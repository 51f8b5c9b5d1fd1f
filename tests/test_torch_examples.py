"""The port's four examples (`repro_torch.examples`) on the CPU at small
sizes, against the reference's (`examples/`) where they compute the same
thing: quickstart trains and serves; serve_hierarchical runs the offline
phase (2 steps) and then serves 4 patients, "ours" within the eq.-6 bound
and the baselines; long_context_decode's cache bytes per arch equal the
reference's state (its position is a host int in the port, an int32 leaf
in the reference); llm_fleet_allocation prints the reference's table.
Without CUDA every example raises unless given `--device cpu`."""
import dataclasses
import functools
import importlib.util
import math
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import make_batch as ref_make_batch
from repro.models import build_model as ref_build_model
from repro_torch.examples import (llm_fleet_allocation, long_context_decode,
                                  quickstart, serve_hierarchical)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = [llm_fleet_allocation, long_context_decode, quickstart,
            serve_hierarchical]


@pytest.fixture(autouse=True)
def one_thread():
    """The reduced models run many small ops, which one intra-op thread
    runs faster than a pool sharing the CPU with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_trains_and_serves():
    hist, res = quickstart.main(["--steps", "5", "--device", "cpu"])
    assert [s for s, _ in hist] == [0, 4]
    assert all(math.isfinite(loss) for _, loss in hist)
    assert tuple(res.tokens.shape) == (2, 32)


def test_serve_hierarchical_offline_phase_then_serving(monkeypatch):
    monkeypatch.setattr(serve_hierarchical, "train_offline", functools.partial(
        serve_hierarchical.train_offline, 2))
    trained, (results, lb) = serve_hierarchical.main(
        ["--patients", "4", "--device", "cpu"])
    assert len(trained) == 3
    for res in trained.values():
        assert len(res["losses"]) == 2
        assert all(math.isfinite(x) for x in res["losses"])
    ours = results["ours (algorithm 2)"]
    assert len(ours.entries) == 4
    assert ours.weighted_sum >= lb - 1e-9
    assert all(ours.weighted_sum <= s.weighted_sum + 1e-9
               for s in results.values())


def _reference_cache_sizes(arch, ctx=512):
    """The reference example's cache bytes after prefills of ctx/4, ctx/2
    and ctx (its config reduction), of the groups' state, by shapes
    alone (jax.eval_shape)."""
    cache_bytes = _reference_example("long_context_decode").cache_bytes
    cfg = ref_get_config(arch).reduced(
        layers=2 if len(ref_get_config(arch).group_pattern) <= 2 else None,
        d_model=128, vocab=256)
    if arch == "mixtral-8x7b":
        cfg = dataclasses.replace(cfg, attn_window=64)
    model = ref_build_model(cfg)
    sizes = []
    for c in (ctx // 4, ctx // 2, ctx):
        cache = jax.eval_shape(
            lambda p, b, c=c: model.prefill(p, b, max_len=c + 8)[1],
            model.param_specs(), ref_make_batch(cfg, 1, c, seed=1))
        sizes.append(int(cache_bytes(cache["groups"])))
    return sizes


def test_long_context_decode_cache_bytes_match_reference():
    got = long_context_decode.main(["--device", "cpu"])
    assert list(got) == [a for a, _ in long_context_decode.ARCHS]
    for arch, sizes in got.items():
        assert sizes == _reference_cache_sizes(arch), arch
    assert len(set(got["xlstm-350m"])) == 1            # O(1) state
    assert got["qwen2-1.5b"][2] > 3 * got["qwen2-1.5b"][0]


def test_llm_fleet_allocation_prints_reference_table(capsys):
    n = llm_fleet_allocation.main(["--device", "cpu"])
    got = capsys.readouterr().out
    _reference_example("llm_fleet_allocation").main()
    want = capsys.readouterr().out
    assert got == want
    assert f"disagreements: {n}/20" in got


@pytest.mark.parametrize("example", EXAMPLES,
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_example_raises_without_cuda(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
