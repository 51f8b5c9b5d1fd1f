"""END TO END — the paper's scenario, fully executed.

Multi-patient ICU room: each patient's end device releases inference jobs
(short-of-breath alerts w=2, life-death prediction w=2, phenotype
classification w=1) over real synthetic MIMIC-like time series. The
pipeline is the paper's, end to end:

  1. train the three LSTM models (offline phase, 'on the cloud');
  2. calibrate the cost model on a small dataset (Algorithm 1, steps 2-8);
  3. allocate + schedule the job stream with Algorithm 2;
  4. execute the schedule — every inference really runs;
  5. compare against the paper's four baseline strategies.

    python -m repro_torch.examples.serve_hierarchical --patients 12
    python -m repro_torch.examples.serve_hierarchical --device cpu

The reference's example (examples/serve_hierarchical.py) on the port:
the offline phase is `launch.train.train_offline`, the online phase
`launch.serve.run`, both on `--device` (default cuda; raises without
one).
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve
from repro_torch.launch import train


def train_offline(steps: int = 60, device=None) -> dict:
    """The paper's offline phase: train each ICU model and report its
    accuracy on held-out data (`launch.train.train_offline`)."""
    print("=== offline phase: training the three ICU models ===")
    return train.train_offline(steps, device=device)


def main(argv=None):
    """Returns (the offline phase's {workload: result} or None with
    --skip-train, serve.run's (strategy results, lower bound))."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--patients", type=int, default=12)
    ap.add_argument("--horizon", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiers", choices=("paper", "tpu"), default="paper")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    trained = None if args.skip_train else train_offline(device=args.device)

    print("\n=== online phase: allocation + scheduling + execution ===")
    return trained, serve.run(patients=args.patients, horizon=args.horizon,
                              seed=args.seed, tiers_kind=args.tiers,
                              execute=True, device=args.device)


if __name__ == "__main__":
    main()
