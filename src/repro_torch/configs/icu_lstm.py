"""The paper's three ICU AI workloads (Edge AIBench / MIMIC-III, Table IV).

Each is an LSTM classifier over clinical time series (Harutyunyan et al.,
Scientific Data 2019 benchmark family): 76 input features per timestep,
a small LSTM, and a linear head. The paper characterises each model only by
its FLOPs count (per unit of data) and priority weight; we pick LSTM sizes
whose analytic FLOPs (utils.flops.lstm_flops) land on the paper's numbers,
and ALSO carry the paper's published FLOPs verbatim for the benchmark
reproduction (benchmarks use ``paper_flops``; our model uses the real dims).

Paper Table IV:
  short-of-breath alerts        comp=105,089  w=2
  life-death prediction         comp=  7,569  w=2
  patient phenotype class.      comp=347,417  w=1
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ICULSTMConfig:
    name: str
    input_dim: int          # clinical features per timestep
    hidden: int             # LSTM hidden size
    depth: int              # stacked LSTM layers
    num_classes: int
    priority: int           # paper's w_i
    paper_flops: int        # paper Table IV "Model FLOPs" (per data unit)
    seq_len: int = 48       # 48 hourly measurements, per the clinical benchmark


SHORT_OF_BREATH = ICULSTMConfig(
    name="short-of-breath-alerts", input_dim=76, hidden=16, depth=1,
    num_classes=2, priority=2, paper_flops=105_089)

LIFE_DEATH = ICULSTMConfig(
    name="life-death-prediction", input_dim=17, hidden=8, depth=1,
    num_classes=2, priority=2, paper_flops=7_569)

PHENOTYPE = ICULSTMConfig(
    name="patient-phenotype-classification", input_dim=76, hidden=32, depth=1,
    num_classes=25, priority=1, paper_flops=347_417)

ICU_WORKLOADS: Tuple[ICULSTMConfig, ...] = (SHORT_OF_BREATH, LIFE_DEATH,
                                            PHENOTYPE)

# Paper Table IV data sizes (record-count proportional units)
DATA_SIZES = (64, 128, 256, 512, 1024, 2048)
