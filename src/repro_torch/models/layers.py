"""Common building blocks: norms, MLPs, rotary positions, initialisers.

Counterpart of ``repro.models.layers``.  Functional like the reference:
parameters are dicts of tensors, the apply functions take ``(params, x,
...)``; norms and RoPE compute in f32 inside and cast back to the
activation dtype, as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initialisers (the reference's distributions; values come from the
# caller's torch.Generator, so they differ from JAX's draws)
# ---------------------------------------------------------------------------


def dense_init(shape, dtype, generator: torch.Generator, in_axis: int = 0):
    """Truncated-normal (at +-2 std) fan-in init: std = 1/sqrt(fan_in).
    Drawn by inverse CDF on the generator's device."""
    std = 1.0 / math.sqrt(shape[in_axis])
    u = torch.rand(shape, generator=generator, device=generator.device)
    lo, hi = 0.5 * (1 + math.erf(-2.0 / math.sqrt(2))), 0.5 * (1 + math.erf(2.0 / math.sqrt(2)))
    z = torch.erfinv(2 * (lo + u * (hi - lo)) - 1).mul_(math.sqrt(2))
    return z.clamp_(-2.0, 2.0).mul_(std).to(dtype)


def embed_init(shape, dtype, generator: torch.Generator):
    return (torch.randn(shape, generator=generator, device=generator.device)
            * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(kind: str, dim: int, dtype, device) -> dict:
    p = {"scale": torch.ones(dim, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(dim, dtype=dtype, device=device)
    return p


def apply_norm(kind: str, params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * params["scale"].float()).to(x.dtype)
    if kind == "layernorm":
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
        return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)
    raise ValueError(kind)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head qk-norm (Qwen3 style) over the trailing head_dim; eps is
    fixed at 1e-6 as in the reference (not ``cfg.norm_eps``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated and plain)
# ---------------------------------------------------------------------------


def init_mlp(d_model: int, d_ff: int, activation: str, dtype,
             generator: torch.Generator) -> dict:
    if activation in ("swiglu", "geglu"):
        return {"w_gate": dense_init((d_model, d_ff), dtype, generator),
                "w_up": dense_init((d_model, d_ff), dtype, generator),
                "w_down": dense_init((d_ff, d_model), dtype, generator)}
    return {"w_up": dense_init((d_model, d_ff), dtype, generator),
            "w_down": dense_init((d_ff, d_model), dtype, generator)}


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation; torch's does not
    return F.gelu(x, approximate="tanh")


def apply_mlp(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else _gelu
        g = act(x @ params["w_gate"].to(x.dtype))
        u = x @ params["w_up"].to(x.dtype)
        return (g * u) @ params["w_down"].to(x.dtype)
    h = _gelu(x @ params["w_up"].to(x.dtype))
    return h @ params["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh) or (..., S, Dh); positions: (..., S) on x's
    device.  Rotates split halves (not interleaved pairs), as the reference."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (Dh/2,)
    angles = positions.float()[..., None] * freqs                 # (..., S, Dh/2)
    if x.ndim == angles.ndim + 1:                                 # head axis present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
