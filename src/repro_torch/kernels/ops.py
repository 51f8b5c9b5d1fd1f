"""Entry points the models call for the port's kernels.

Each op takes the hand-written CUDA kernel for CUDA tensors, at any shape
(the kernels take ragged lengths), and for CPU tensors the plain path the
reference takes off the TPU. There is no switch to the plain path on the
card: a CUDA tensor launches the kernel or raises.

Called with DTensors (a model under an activation policy), an op runs the
same local call on each rank's shards in a `local_map` region, so no
DTensor reaches a kernel's launch: batch on the dp mesh dims, heads on
"model" where they divide, the sequence whole. Where the heads do not
divide "model" (qwen2-1.5b's 12 and gemma-2b's 8 on 16 ranks), each
"model" rank takes its slice of the query rows against every key rather
than repeating all of them. An operand in another layout is
redistributed to it first. The mLSTM cell stays model-replicated, as the
reference pins its inputs to (DP, None, None). With q heads on "model"
and kv heads that do not divide it, each rank takes the kv heads its q
heads map to, (offset + j) // group; a split that cannot map that way
raises.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lstm_cell import lstm_cell, lstm_sequence
from repro_torch.kernels.mlstm_chunk import mlstm_chunk
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.sharding import policy

__all__ = ["attention", "lstm_step", "lstm_layer", "ssm", "mlstm",
           "flash_attention", "lstm_cell", "lstm_sequence", "ssm_scan",
           "mlstm_chunk"]


def _attention_local(q, k, v, causal, window, softcap, scale, block_q,
                     block_k, q_offset=None):
    """Attention on local tensors; with `q_offset` (causal only) the
    queries are the rows from that position on, not the last Lq."""
    if q.device.type != "cpu":
        if q_offset is not None:
            # the keys after the last query are masked for every row: the
            # kernel's own alignment, on the keys up to it
            end = q_offset + q.shape[-2]
            k, v = k[:, :, :end].contiguous(), v[:, :, :end].contiguous()
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale,
                               block_q=block_q, block_k=block_k)
    # production shapes: block-wise, memory-bounded
    if q.shape[-2] >= 1024 or (q_offset is not None
                               and k.shape[-2] >= 1024):
        return ref.attention_blockwise(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale,
                                       q_offset=q_offset)
    return ref.attention_reference(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   q_offset=q_offset)


def attention(q, k, v, *, causal=True, window=None, softcap=None,
              scale=None, block_q=128, block_k=128):
    args = (causal, window, softcap, scale, block_q, block_k)
    if not _any_dtensor(q, k, v):
        return _attention_local(q, k, v, *args)
    mesh = _mesh_of(q, k, v)
    b, hq = q.shape[0], q.shape[1]
    hkv = k.shape[1]
    tp = _size(mesh, "model")
    heads = tp > 1 and hq % tp == 0
    kv_split = heads and hkv % tp == 0
    lo = hi = None
    if heads and not kv_split:
        # the kv heads this rank's q heads map to, taken from replicated k
        group, hq_loc = hq // hkv, hq // tp
        off = mesh.get_local_rank("model") * hq_loc
        lo, hi = off // group, (off + hq_loc - 1) // group + 1
        if not (group % hq_loc == 0 or hq_loc % group == 0):
            raise ValueError(f"GQA: {hq_loc} local q heads of group {group} "
                             f"do not map onto whole kv heads")
    q_pl = policy.layout(mesh, b, heads_dim=1 if heads else None)
    kv_pl = policy.layout(mesh, b, heads_dim=1 if kv_split else None)
    lq, lk = q.shape[2], k.shape[2]
    offset = None
    if (tp > 1 and not heads and lq % tp == 0 and lq <= lk
            and (causal or window is None)):
        # the query rows split on "model", each rank's from its offset
        q_pl = tuple(_shard(2) if name == "model" else pl
                     for name, pl in zip(mesh.mesh_dim_names, q_pl))
        if causal:
            offset = lk - lq + mesh.get_local_rank("model") * (lq // tp)

    def body(ql, kl, vl):
        if lo is not None:
            kl, vl = kl[:, lo:hi], vl[:, lo:hi]
        return _attention_local(ql.contiguous(), kl.contiguous(),
                                vl.contiguous(), *args, q_offset=offset)

    return policy.run_local(body, mesh, (q, k, v), (q_pl, kv_pl, kv_pl),
                            q_pl)


def lstm_step(x, h, c, wx, wh, b):
    """wx: (I, 4, H); wh: (H, 4, H); b: (4, H)."""
    return lstm_cell(x, h, c, wx, wh, b)


def lstm_layer(xs, wx, wh, b, *, return_sequence=False):
    """One LSTM layer over a whole (T, B, I) sequence from h = c = 0: one
    kernel launch on the card, the scanned step on the CPU. Returns (h_T,
    c_T, the (T, B, H) hidden sequence or None). With DTensors the batch
    is split over dp and the (tiny) weights replicated."""
    if not _any_dtensor(xs, wx, wh, b):
        return lstm_sequence(xs, wx, wh, b, return_sequence=return_sequence)
    mesh = _mesh_of(xs, wx, wh, b)
    rows = policy.layout(mesh, xs.shape[1])
    seq = tuple(pl if pl == _replicate() else _shard(1) for pl in rows)
    rep = policy.layout(mesh, None)

    def body(xl, wxl, whl, bl):
        h, c, hs = lstm_sequence(xl.contiguous(), wxl, whl, bl,
                                 return_sequence=return_sequence)
        return (h, c, hs) if return_sequence else (h, c)

    outs = (rows, rows, seq) if return_sequence else (rows, rows)
    out = policy.run_local(body, mesh, (xs, wx, wh, b),
                           (seq, rep, rep, rep), outs)
    return out if return_sequence else (*out, None)


def _ssm_local(x, dt, a, b, c, d, chunk, block_h):
    if x.device.type != "cpu":
        return ssm_scan(x, dt, a, b, c, d, chunk=chunk, block_h=block_h)
    return ref.ssm_scan_reference(x, dt, a, b, c, d)


def ssm(x, dt, a, b, c, d, *, chunk=256, block_h=8):
    if not _any_dtensor(x, dt, a, b, c, d):
        return _ssm_local(x, dt, a, b, c, d, chunk, block_h)
    mesh = _mesh_of(x, dt, a, b, c, d)
    bsz, h = x.shape[0], x.shape[2]
    tp = _size(mesh, "model")
    heads = 2 if tp > 1 and h % tp == 0 else None
    x_pl = policy.layout(mesh, bsz, heads_dim=heads)    # (B, L, H, P)
    dt_pl = x_pl                                        # (B, L, H)
    h_pl = policy.layout(mesh, None,                    # (H,)
                         heads_dim=0 if heads else None)
    bc_pl = policy.layout(mesh, bsz)                    # (B, L, N)
    st_pl = policy.layout(mesh, bsz,                    # (B, H, P, N)
                          heads_dim=1 if heads else None)

    def body(xl, dtl, al, bl, cl, dl):
        return _ssm_local(xl.contiguous(), dtl.contiguous(), al,
                          bl.contiguous(), cl.contiguous(), dl, chunk,
                          block_h)

    return policy.run_local(body, mesh, (x, dt, a, b, c, d),
                            (x_pl, dt_pl, h_pl, bc_pl, bc_pl, h_pl),
                            (x_pl, st_pl))


def _mlstm_local(q, k, v, i_gate, f_gate, chunk, block_h):
    if q.device.type != "cpu":
        return mlstm_chunk(q, k, v, i_gate, f_gate, chunk=chunk,
                           block_h=block_h)
    if q.shape[1] >= 256:   # chunkwise: O(L/chunk) state, as the reference
        return ref.mlstm_chunk_torch(q, k, v, i_gate, f_gate, chunk=256)
    return ref.mlstm_chunk_reference(q, k, v, i_gate, f_gate)


def mlstm(q, k, v, i_gate, f_gate, *, chunk=64, block_h=4):
    """Returns (y, (C, n, m) final state)."""
    if not _any_dtensor(q, k, v, i_gate, f_gate):
        return _mlstm_local(q, k, v, i_gate, f_gate, chunk, block_h)
    mesh = _mesh_of(q, k, v, i_gate, f_gate)
    rows = policy.layout(mesh, q.shape[0])   # batch on dp, the rest whole

    def body(ql, kl, vl, il, fl):
        return _mlstm_local(ql.contiguous(), kl.contiguous(),
                            vl.contiguous(), il.contiguous(),
                            fl.contiguous(), chunk, block_h)

    y, (c, n, m) = policy.run_local(body, mesh,
                                    (q, k, v, i_gate, f_gate),
                                    (rows,) * 5, (rows,) * 4)
    return y, (c, n, m)


# ------------------------------------------------------------ local regions
def _any_dtensor(*xs) -> bool:
    return any(policy.is_dtensor(x) for x in xs)


def _mesh_of(*xs):
    return next(x.device_mesh for x in xs if policy.is_dtensor(x))


def _size(mesh, name: str) -> int:
    return policy.axis_sizes(mesh).get(name, 1)


def _replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()


def _shard(dim: int):
    from torch.distributed.tensor import Shard
    return Shard(dim)
