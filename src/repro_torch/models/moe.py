"""Mixture-of-Experts FFN (DeepSeek-style shared + routed, top-k).

Counterpart of ``repro.models.moe``, scatter dispatch: the (token, k)
pairs are scattered into a per-expert buffer ``(E, cap, D)``, every
expert's FFN runs as one batched product over that buffer, and the results
are gathered back and combined with the router weights.  Every shape is
fixed by (tokens, experts, top_k), none by the routing, so the host never
waits on the device inside a layer and no Python loop runs over experts.

The dispatch is dropless unless the caller asks otherwise (``cap`` =
tokens, whatever the config's ``capacity_factor``), which is what makes
chunked recomputation reproduce the full-prefill KV and a token's output
independent of its batch mates.  The price is known: the products run over
all E experts' slots, E / top_k times the FLOPs the routed tokens need, and
a decode step reads every expert's weights.  ``dropless=False`` (a
``Model`` built with ``moe_dropless=False``, as the reference's train-step
smoke test builds it) takes the reference's capacity path: ``cap =
max(1, int(T·k/E·capacity_factor))`` slots an expert, the pairs whose slot
is ``cap`` or more dropped.  There the module switch ``DISPATCH`` picks the
reference's mechanism: ``"scatter"`` (the default) or ``"einsum"``, the
GShard one-hot dispatch (``_moe_group_einsum``: (T, E, cap) dispatch and
combine tensors contracted with ``torch.einsum``, as the reference computes
them outside any Pallas kernel).

A layer may hold a share of the experts (``MoEConfig.experts_first`` /
``experts_held``: one chip's under expert parallelism).  Its stacks then
hold those experts alone; the router scores all ``num_experts`` and picks
the top k among them as before, and the layer returns the held experts'
part of the result.  A dropless buffer gives every expert a row for every
token, so a share skips the scatter: each held expert runs all T tokens,
``x`` broadcast to ``(held, T, D)`` (the buffer's products, the same
FLOPs), and a token sums its held experts' outputs by the (T, E) matrix of
its renormalised top-k weights, zero for an expert it did not pick.  No
slot count, no scatter or gather, no data-dependent shape and no host
sync: half the ops of the scatter a decode step issues.  Only the dropless
path takes a share.

Callers that read no load-balancing loss (the cached and row layers of
serving) pass ``want_aux=False``, and the loss's ops are not issued.

``apply_moe``'s ``num_groups`` (a ``Model`` built with ``moe_groups``,
through its full and cached layers) runs groups of the sequence axis one
after another (the reference's ``lax.scan``); the serving engine builds no
such model.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.distributed.constraints import constrain, local_call
from repro_torch.models.layers import _gelu, apply_mlp, dense_init, init_mlp


def init_moe(cfg: ModelConfig, dtype, generator: torch.Generator) -> dict:
    """Router (d, num_experts) in f32 whatever ``dtype`` (as the
    reference); stacked weights of the held experts (held, d, f) / (held,
    f, d), fan-in over d / f."""
    m, d = cfg.moe, cfg.d_model
    held = m.held_range[1]
    gated = cfg.activation in ("swiglu", "geglu")
    p = {"router": dense_init((d, m.num_experts), torch.float32, generator)}
    if gated:
        p["w_gate"] = dense_init((held, d, m.expert_d_ff), dtype, generator, in_axis=1)
    p["w_up"] = dense_init((held, d, m.expert_d_ff), dtype, generator, in_axis=1)
    p["w_down"] = dense_init((held, m.expert_d_ff, d), dtype, generator, in_axis=1)
    shared_ff = m.shared_d_ff or m.num_shared_experts * m.expert_d_ff
    if shared_ff:
        p["shared"] = init_mlp(d, shared_ff, cfg.activation, dtype, generator)
    return p


def _expert_ffn(params: dict, xb: torch.Tensor, activation: str) -> torch.Tensor:
    """xb: (E, C, D) -> (E, C, D) through per-expert weights."""
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else _gelu
        h = act(torch.bmm(xb, params["w_gate"].to(xb.dtype))) \
            * torch.bmm(xb, params["w_up"].to(xb.dtype))
    else:
        h = _gelu(torch.bmm(xb, params["w_up"].to(xb.dtype)))
    return torch.bmm(h, params["w_down"].to(xb.dtype))


def top_k_lower_index_first(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties in
    ascending index order as ``jax.lax.top_k`` gives them (``torch.topk``
    leaves the order of ties unspecified): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# dispatch of the capacity path: "scatter" (the (token, k) pairs scattered
# into the expert buffer and gathered back) or "einsum" (the reference's
# GShard one-hot dispatch and combine products); the dropless path always
# scatters, as the reference's does
DISPATCH = "scatter"


def moe_group(params: dict, x: torch.Tensor, moe: MoEConfig, activation: str,
              dropless: bool = True, want_aux: bool = True):
    """One group of tokens through the routed experts: dropless, or with
    ``dropless=False`` and a ``capacity_factor`` > 0 the capacity path
    (through ``_moe_group_einsum`` when ``DISPATCH`` is ``"einsum"``).
    With a share of the experts held, y is their part of the result.

    x: (T, D) -> (y (T, D), aux_loss f32 scalar, or None without
    ``want_aux``)
    """
    t, d = x.shape
    e, k = moe.num_experts, moe.top_k
    first, held = moe.held_range
    capacity = not dropless and moe.capacity_factor > 0
    if capacity and held < e:
        raise ValueError("a share of the experts takes the dropless path only")
    if capacity and DISPATCH == "einsum":
        return _moe_group_einsum(params, x, moe, activation,
                                 max(1, int(t * k / e * moe.capacity_factor)))
    logits = x.float() @ params["router"].float()                             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k_lower_index_first(probs, k)                          # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    if not capacity and held < e:
        return _share_group(params, x, probs, top_p, top_i, moe, activation, want_aux)

    # slot of each (token, k) pair among its expert's hits: every pair has
    # one of its own in the (E, T, D) buffer
    flat_e = top_i.reshape(t * k)                                             # (T·k,)
    onehot = (flat_e[:, None] == torch.arange(e, device=x.device)).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0].long()           # (T·k,)

    # on a mesh (the reference's constraints; no-ops off-mesh): pairs over
    # the batch axes, the buffer's experts over "model" and slots over "data"
    x_rep = constrain(x.repeat_interleave(k, dim=0), ("pod", "data"), None)  # (T·k, D)
    if not capacity:
        buf = _scatter_pairs((e, t, d), (flat_e, slot), x_rep, accumulate=False)
        buf = constrain(buf, "model", "data", None)
        y_buf = constrain(_expert_ffn(params, buf, activation), "model", "data", None)
        y_rep = _take_pairs(y_buf, (flat_e, slot))                            # (T·k, D)
    else:
        # the reference's capacity path: pairs past their expert's cap slots
        # are dropped (zero in, zero out), the rest accumulate as its .add
        cap = max(1, int(t * k / e * moe.capacity_factor))
        keep = (slot < cap)[:, None]
        at = slot.clamp(max=cap - 1)
        buf = _scatter_pairs((e, cap, d), (flat_e, at), torch.where(keep, x_rep, 0),
                             accumulate=True)
        buf = constrain(buf, "model", "data", None)
        y_buf = constrain(_expert_ffn(params, buf, activation), "model", "data", None)
        y_rep = torch.where(keep, _take_pairs(y_buf, (flat_e, at)), 0)

    # combine in the reference's order and dtype
    w = top_p.reshape(t * k, 1).to(y_rep.dtype)
    y = (y_rep * w).reshape(t, k, d).sum(dim=1)
    if not want_aux:
        return y, None
    return y, _aux_loss(probs, onehot.sum(dim=0).float(), moe)


def _aux_loss(probs: torch.Tensor, counts: torch.Tensor, moe: MoEConfig) -> torch.Tensor:
    """Switch-style load-balancing loss from the router's (T, E) probs and
    each expert's count of top-k picks (E,) f32, with no host sync."""
    t, e = probs.shape
    me = probs.mean(dim=0)
    ce = counts / (t * moe.top_k)
    return e * torch.sum(me * ce) * moe.router_aux_loss


def _share_group(params: dict, x: torch.Tensor, probs, top_p, top_i, moe: MoEConfig,
                 activation: str, want_aux: bool):
    """The held experts' part of a dropless layer: every held expert runs
    every token (x broadcast to the (held, T, D) buffer), and token t adds
    expert j's output by its renormalised weight, 0 where t did not pick
    j.  The sum over experts accumulates in f32 and rounds once, as the
    unsplit layer's sum over a token's k picks does.  A share is one
    chip's, so no mesh constraint applies."""
    t, d = x.shape
    first, held = moe.held_range
    weight = torch.zeros_like(probs).scatter_(1, top_i, top_p)               # (T, E)
    w = weight[:, first:first + held].t().to(x.dtype)[:, :, None]           # (held, T, 1)
    y_buf = _expert_ffn(params, x[None].expand(held, t, d), activation)       # (held, T, D)
    y = (y_buf * w).sum(dim=0)
    if not want_aux:
        return y, None
    counts = torch.zeros_like(probs).scatter_(1, top_i, 1.0).sum(dim=0)
    return y, _aux_loss(probs, counts, moe)


def _replicated(fn, *tensors):
    """``fn`` on the tensors; on a mesh (DTensors) on every rank's whole
    copy of them (each gathered: counted all-gathers), the output
    replicated — DTensor has no sharded scatter or gather by index."""
    from torch.distributed.tensor import DTensor
    if not any(isinstance(t, DTensor) for t in tensors):
        return fn(*tensors)
    return local_call(fn, [(t, (None,) * t.ndim) for t in tensors], (0,))


def _scatter_pairs(shape, idx, vals, accumulate: bool):
    """zeros(shape) with ``vals`` put at the index tensors ``idx`` (summed
    where ``accumulate``)."""
    def put(v, *ix):
        buf = torch.zeros(shape, dtype=v.dtype, device=v.device)
        buf.index_put_(ix, v, accumulate=accumulate)
        return buf
    return _replicated(put, vals, *idx)


def _take_pairs(buf, idx):
    """buf[idx] for the index tensors ``idx``."""
    return _replicated(lambda b, *ix: b[ix], buf, *idx)


def _moe_group_einsum(params: dict, x: torch.Tensor, moe: MoEConfig, activation: str,
                      cap: int):
    """The reference's GShard one-hot dispatch on the capacity path: the
    (T, E, cap) dispatch tensor (pair (t, k) to its expert's slot, pairs at
    slot ``cap`` or more dropped) and the combine tensor (the same weighted
    by the router's renormalised top-k probabilities) contract x into the
    expert buffer and the experts' outputs back.  x: (T, D) -> (y, aux)."""
    t, _ = x.shape
    e, k = moe.num_experts, moe.top_k
    probs = torch.softmax(x.float() @ params["router"].float(), dim=-1)
    top_p, top_i = top_k_lower_index_first(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    onehot_e = (top_i[..., None] == torch.arange(e, device=x.device)).float()  # (T,k,E)
    flat = onehot_e.reshape(t * k, e)
    pos = torch.cumsum(flat, dim=0) - flat
    slot = (pos.reshape(t, k, e) * onehot_e).sum(-1).to(torch.int32)            # (T,k)
    keep = slot < cap
    onehot_c = ((slot[..., None] == torch.arange(cap, device=x.device))
                & keep[..., None]).to(x.dtype)                                   # (T,k,C)
    oe = onehot_e.to(x.dtype)
    disp = constrain(torch.einsum("tke,tkc->tec", oe, onehot_c), ("pod", "data"), "model", None)
    comb = constrain(torch.einsum("tke,tkc,tk->tec", oe, onehot_c, top_p.to(x.dtype)),
                     ("pod", "data"), "model", None)
    buf = constrain(torch.einsum("tec,td->ecd", disp, x), "model", "data", None)
    y_buf = constrain(_expert_ffn(params, buf, activation), "model", "data", None)
    y = torch.einsum("tec,ecd->td", comb, y_buf)

    me = probs.mean(dim=0)
    ce = onehot_e.sum(dim=(0, 1)) / (t * k)
    aux = e * torch.sum(me * ce) * moe.router_aux_loss
    return y, aux


def apply_moe(params: dict, x: torch.Tensor, cfg: ModelConfig, num_groups: int = 0,
              dropless: bool = True, want_aux: bool = True):
    """x: (B, S, D) -> (y, aux_loss).  ``num_groups`` > 1 (dividing S) runs
    groups of the sequence axis one after another, each group's dispatch
    over its B·S/num_groups tokens; aux is the groups' mean.  ``dropless``
    and ``want_aux`` as in :func:`moe_group`."""
    m = cfg.moe
    b, s, d = x.shape
    if num_groups <= 1 or s % num_groups:
        y, aux = moe_group(params, x.reshape(b * s, d), m, cfg.activation, dropless,
                           want_aux)
        y = y.reshape(b, s, d)
    else:
        sg = s // num_groups
        ys, auxs = [], []
        for gi in range(num_groups):
            yg, auxg = moe_group(params, x[:, gi * sg:(gi + 1) * sg].reshape(b * sg, d),
                                 m, cfg.activation, dropless, want_aux)
            ys.append(yg.reshape(b, sg, d))
            auxs.append(auxg)
        y = torch.cat(ys, dim=1)
        aux = torch.stack(auxs).mean() if want_aux else None
    if "shared" in params:
        y = y + apply_mlp(params["shared"], x, cfg.activation)
    return y, aux
