"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU.

Counterpart of ``repro.models.rglru``:

    y = W_out( gelu(W_y x) ⊙ RG-LRU(conv1d(W_x x)) )

RG-LRU (per channel, block-diagonal gates per head):
    r_t = σ(W_a z_t + b_a)                recurrence gate
    i_t = σ(W_i z_t + b_i)                input gate
    log a_t = -c · softplus(Λ) · r_t      (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ z_t)

The recurrence h_t = a_t h_{t-1} + b_t runs in the port's ``rglru_scan``
kernel on a CUDA tensor and in its plain version on a CPU tensor.  The
carried state (conv tail + h) is O(1) in sequence length; the restoration
executor snapshots it at chunk boundaries.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models.layers import _gelu, dense_init

_C = 8.0
_MAX_SQRT_GRADIENT = 1000.0


def _widths(cfg: ModelConfig):
    w = cfg.rglru.lru_width or cfg.d_model
    return w, cfg.rglru.num_rglru_heads or max(1, w // 128)


def init_rglru_block(cfg: ModelConfig, dtype, generator: torch.Generator) -> dict:
    """The reference's distributions; ``lam`` stays f32 whatever ``dtype``."""
    d = cfg.d_model
    w, nh = _widths(cfg)
    hd = w // nh
    dev = generator.device
    # Λ init so that a^c ∈ [0.9, 0.999] (Griffin appendix)
    lo, hi = 0.9 ** 2, 0.999 ** 2
    u = lo + (hi - lo) * torch.rand(w, generator=generator, device=dev)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))  # softplus^{-1}(-log u / c)
    return {
        "w_y": dense_init((d, w), dtype, generator),
        "w_x": dense_init((d, w), dtype, generator),
        "conv_w": dense_init((cfg.rglru.conv1d_width, w), dtype, generator),
        "conv_b": torch.zeros(w, dtype=dtype, device=dev),
        "gate_a": dense_init((nh, hd, hd), dtype, generator, in_axis=1),
        "gate_a_b": torch.zeros(w, dtype=dtype, device=dev),
        "gate_i": dense_init((nh, hd, hd), dtype, generator, in_axis=1),
        "gate_i_b": torch.zeros(w, dtype=dtype, device=dev),
        "lam": lam.float(),
        "w_out": dense_init((w, d), dtype, generator),
    }


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0): max(x, 0) + log1p(exp(-|x|))
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _gates(params: dict, z: torch.Tensor, nh: int):
    """z: (B, S, W) -> log_a (B,S,W) f32, gated input b (B,S,W) f32."""
    b, s, w = z.shape
    zh = z.reshape(b, s, nh, w // nh)
    ra = torch.einsum("bsnh,nhk->bsnk", zh, params["gate_a"].to(z.dtype)).reshape(b, s, w)
    ri = torch.einsum("bsnh,nhk->bsnk", zh, params["gate_i"].to(z.dtype)).reshape(b, s, w)
    r = torch.sigmoid(ra.float() + params["gate_a_b"].float())
    i = torch.sigmoid(ri.float() + params["gate_i_b"].float())
    log_a = -_C * _softplus(params["lam"].float()) * r
    a2 = torch.exp(2 * log_a)
    gated = i * z.float()
    b_t = torch.sqrt(torch.clamp(1.0 - a2, 1.0 / _MAX_SQRT_GRADIENT ** 2, 1.0)) * gated
    return log_a, b_t


def causal_conv1d(z: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                  tail: torch.Tensor):
    """Depthwise causal conv. z: (B,S,W); conv_w: (K,W); tail: (B,K-1,W) —
    the last K-1 inputs from the previous chunk. Returns (out, new_tail)."""
    k = conv_w.shape[0]
    zc = torch.cat([tail.to(z.dtype), z], dim=1)                 # (B, S+K-1, W)
    out = sum(zc[:, i:i + z.shape[1]] * conv_w[i].to(z.dtype) for i in range(k))
    out = out + conv_b.to(z.dtype)
    new_tail = zc[:, -(k - 1):] if k > 1 else tail
    return out, new_tail


def rglru_full(cfg: ModelConfig, params: dict, x: torch.Tensor,
               conv_tail: torch.Tensor, h0: torch.Tensor):
    """Chunk forward (C = 1 for decode). x: (B,S,D); conv_tail (B,K-1,W);
    h0 (B,W) f32.  Returns (out (B,S,D), conv_tail', h')."""
    _, nh = _widths(cfg)
    y = _gelu(x @ params["w_y"].to(x.dtype))
    z = x @ params["w_x"].to(x.dtype)
    z, conv_tail = causal_conv1d(z, params["conv_w"], params["conv_b"], conv_tail)
    log_a, b_t = _gates(params, z, nh)
    h, h_last = rglru_scan(log_a.contiguous(), b_t.contiguous(),
                           h0.float().contiguous())
    out = (y * h.to(x.dtype)) @ params["w_out"].to(x.dtype)
    return out, conv_tail, h_last
