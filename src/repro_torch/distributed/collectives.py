"""Explicit-collective attention: sequence-sharded decode with an LSE
combine (counterpart of ``repro.distributed.collectives``).

When the kv-heads do not divide the "model" mesh dim, the decode cache is
sharded along its SEQUENCE dim (``sharding.cache_pspecs``).  Plain
attention would then gather the whole cache every layer; instead each rank
computes the flash partial of its shard — on the card ``flash_decode``'s
split kernel and its combine in partials mode, on the CPU the plain version
— and the partials are combined with log-sum-exp weights over the seq
dim's process group: ``all_reduce(MAX)`` of m, then one ``all_reduce(SUM)``
of l·w and acc·w, w = exp(m - m_g).  The communication is (B, Hq, Dh + 1)
f32 a rank instead of the cache: the reference's ``pmax``/``psum`` inside
its ``shard_map``.

The masked score is the finite -1e30, as the reference's: a shard with no
visible slot weighs exp(-1e30 - m_g) = 0 next to one that saw a slot, and a
row with no visible slot on any rank comes out as the mean of V over every
rank's slots (each rank's l is its slot count, its acc the sum of its V).

On gloo a collective of CUDA tensors is staged through host memory by the
backend itself; NCCL reduces on the cards.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.constraints import _as_dtensor, ambient_mesh, axis_size, constrain
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_partials


def lse_decode_attention(q, k, v, kpos, q_pos: int, *, scale: float, window: int = 0,
                         seq_axis: str = "model", batch_axes=("pod", "data"),
                         tail=None):
    """q: (B, 1, Hq, Dh); k/v: (B, S, Hkv, Dh) sharded over ``seq_axis``
    along S (DTensors; a plain tensor counts as replicated); kpos (S,);
    q_pos: the rows' position (an int on the host, as the attention
    kernels take it).  Returns (B, 1, Hq, Dh) in q's dtype: a DTensor over
    the batch axes when q is one, else the rank's full copy.

    ``tail``: optional (tail_k, tail_v, tail_kpos) append buffer, small and
    replicated; it is merged locally on seq-rank 0 only (the other ranks
    mask its kpos to -1), so the cache never pays a collective for it.

    With no ambient mesh or a seq dim of 1: one local decode over [cache ||
    tail] (``flash_decode``)."""
    mesh = ambient_mesh()
    if mesh is None or axis_size(mesh, seq_axis) == 1:
        if tail is not None:
            k = torch.cat([k, tail[0].to(k.dtype)], dim=1)
            v = torch.cat([v, tail[1].to(v.dtype)], dim=1)
            kpos = torch.cat([kpos, tail[2]])
        return flash_decode(q[:, 0].contiguous(), k, v, kpos, q_pos, scale=scale,
                            window=window)[:, None]
    from torch.distributed.tensor import DTensor
    names = mesh.mesh_dim_names or ()
    bax = tuple(a for a in batch_axes if a in names)
    n_b = 1
    for a in bax:
        n_b *= axis_size(mesh, a)
    b = q.shape[0]
    bspec = bax if (bax and b % n_b == 0 and b >= n_b) else None

    def local(t, *spec):
        return constrain(_as_dtensor(t, mesh), *spec).to_local()

    ql = local(q, bspec, None, None, None)
    kl = local(k, bspec, seq_axis, None, None)
    vl = local(v, bspec, seq_axis, None, None)
    kpl = local(kpos, seq_axis)
    if tail is not None:
        tk, tv, tkp = (local(t, *((bspec, None, None, None) if t.dim() == 4 else (None,)))
                       for t in tail)
        if mesh.get_local_rank(seq_axis) != 0:
            tkp = torch.full_like(tkp, -1)          # only seq-rank 0 counts the tail
        kl = torch.cat([kl, tk.to(kl.dtype)], dim=1)
        vl = torch.cat([vl, tv.to(vl.dtype)], dim=1)
        kpl = torch.cat([kpl, tkp])
    acc, m, l = flash_decode_partials(ql[:, 0].contiguous(), kl.contiguous(),
                                      vl.contiguous(), kpl.contiguous(), q_pos,
                                      scale=scale, window=window)
    out = lse_combine(acc, m, l, mesh.get_group(seq_axis)).to(ql.dtype)[:, None]
    if not isinstance(q, DTensor) and (bspec is None or n_b == 1):
        return out                          # this rank holds every row
    from repro_torch.distributed.sharding import to_placements
    out = DTensor.from_local(out, mesh, to_placements(mesh, (bspec, None, None, None)),
                             run_check=False)
    return out if isinstance(q, DTensor) else out.full_tensor()


def lse_combine(acc, m, l, group):
    """Each rank's partial (acc (B, Hq, Dh) unnormalised, m and l (B, Hq),
    f32) combined over ``group``: sum_r w_r acc_r / max(sum_r w_r l_r,
    1e-30), w_r = exp(m_r - max_r m_r).  Returns (B, Hq, Dh) f32."""
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(m - m_g)
    # one SUM collective: acc·w and l·w side by side
    buf = torch.cat([acc * w[..., None], (l * w)[..., None]], dim=-1)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf[..., :-1] / torch.clamp(buf[..., -1:], min=1e-30)
