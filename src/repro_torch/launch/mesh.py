"""Production and host mesh builders, as the reference's
(src/repro/launch/mesh.py), on `torch.distributed`.

Functions, not module-level constants: importing this module touches no
device and no process group. Both builders take the default process
group, which the caller has initialised (`torchrun`, or
`init_process_group` with an address, world size and rank; the dry-run's
fake group of 256 or 512 ranks), and raise when its world size does not
match the mesh. `device="cuda"` (the default) builds the mesh on the
cards, one per rank (NCCL); `device="cpu"` on the CPU (gloo, what the
tests use).
"""
from __future__ import annotations

from typing import Optional


def _world_size() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no default process group: launch under torchrun "
                           "or call torch.distributed.init_process_group "
                           "first")
    return dist.get_world_size()


def _mesh(device: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    n = _world_size()
    want = 1
    for s in shape:
        want *= s
    if n != want:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh {names} needs "
                         f"{want} ranks; the process group has {n}")
    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16x16 = 256 ranks ("data", "model"); 2x16x16 = 512 ranks in two
    pods ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, names)


def make_host_mesh(*, data: Optional[int] = None, model: int = 1,
                   device: str = "cuda"):
    """A small ("data", "model") mesh over every rank of the process group
    (tests, examples, one card): data defaults to world size / model."""
    n = _world_size()
    data = data or (n // model)
    return _mesh(device, (data, model), ("data", "model"))
