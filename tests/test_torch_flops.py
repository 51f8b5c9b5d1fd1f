"""The port's `utils.flops` and config helpers against the reference's
(src/repro/utils/flops.py, src/repro/configs/__init__.py), exactly, on
all ten configs and every INPUT_SHAPES entry. The port counts the leaves
of its init drawn under FakeTensorMode where the reference counts those
of `jax.eval_shape`; the formulas on top are the same code."""
import dataclasses

import pytest

from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import all_configs as ref_all_configs
from repro.configs import get_config as ref_get_config
from repro.configs import get_shape as ref_get_shape
from repro.configs.icu_lstm import ICU_WORKLOADS
from repro.utils import flops as ref_flops
from repro_torch.configs import (ARCH_NAMES, INPUT_SHAPES, all_configs,
                                 get_config, get_shape)
from repro_torch.utils import flops


def test_get_shape_matches_reference():
    assert sorted(INPUT_SHAPES) == sorted(REF_SHAPES)
    for name in INPUT_SHAPES:
        assert dataclasses.asdict(get_shape(name)) == \
            dataclasses.asdict(ref_get_shape(name)), name


def test_all_configs_matches_reference():
    got, want = all_configs(), ref_all_configs()
    assert list(got) == list(want) == list(ARCH_NAMES)
    for name, cfg in got.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want[name])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_flops_match_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for fn in ("param_count", "param_bytes", "active_param_count",
               "_expert_params_per_layer", "_embed_params", "_attn_layers"):
        assert getattr(flops, fn)(cfg) == getattr(ref_flops, fn)(ref_cfg), fn
    for name, shape in INPUT_SHAPES.items():
        ref_shape = REF_SHAPES[name]
        for fn in ("step_flops", "model_flops_6nd"):
            assert getattr(flops, fn)(cfg, shape) == \
                getattr(ref_flops, fn)(ref_cfg, ref_shape), (fn, name)
        for kind in ("prefill", "train", "decode"):
            assert flops.forward_flops(cfg, shape.global_batch,
                                       shape.seq_len, kind) == \
                ref_flops.forward_flops(ref_cfg, ref_shape.global_batch,
                                        ref_shape.seq_len, kind), (kind, name)
        for kind in sorted(set(cfg.group_pattern)):
            assert flops._avg_context(cfg, kind, shape.seq_len) == \
                ref_flops._avg_context(ref_cfg, kind, shape.seq_len)


def test_lstm_flops_match_reference():
    for wl in ICU_WORKLOADS:
        for t in (1, 48):
            assert flops.lstm_flops(wl.input_dim, wl.hidden, t) == \
                ref_flops.lstm_flops(wl.input_dim, wl.hidden, t)
