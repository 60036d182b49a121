"""Model and hardware configuration of the PyTorch port.

A copy of ``repro.config`` (the port imports nothing of ``repro``) holding
what the port uses: the frozen :class:`ModelConfig` with its family
sub-configs, the input shapes the sharding rules choose a mode by
(:class:`ShapeConfig`, ``SHAPES``, :func:`supports_shape`), and the
:class:`HardwareProfile` type the cost model reads with the reference's
hardware and I/O-bandwidth tables (``HARDWARE``, ``IO_BANDWIDTHS``) that
the simulation engine and the serve CLI take.
Configs are pure data — models are built from them in
``repro_torch.models.model`` and sharding rules in
``repro_torch.distributed.sharding``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """GShard/Switch-style mixture of experts (shared + routed, top-k)."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0          # d_ff of the shared-expert block (0 = expert_d_ff * num_shared)
    first_k_dense: int = 0        # leading layers that use a dense FFN instead
    dense_d_ff: int = 0           # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001
    # the routed experts this layer holds, [experts_first, experts_first +
    # experts_held) (0 = all): one chip's share under expert parallelism.
    # The router still scores all num_experts; the layer's output is the
    # held experts' part of the result
    experts_first: int = 0
    experts_held: int = 0

    def __post_init__(self):
        first, held = self.held_range
        if first < 0 or held < 1 or first + held > self.num_experts:
            raise ValueError(f"experts [{first}, {first + held}) of "
                             f"{self.num_experts}")

    @property
    def held_range(self) -> Tuple[int, int]:
        """(first, count) of the routed experts held here."""
        return self.experts_first, self.experts_held or self.num_experts


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    q_lora_rank: int = 1536       # 0 => full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin RG-LRU recurrent block."""

    lru_width: int = 0            # 0 => d_model
    conv1d_width: int = 4
    block_pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")
    num_rglru_heads: int = 0      # block-diagonal gating heads (0 => d/128)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 "Finch" time-mix with data-dependent decay."""

    head_size: int = 64
    decay_lora_rank: int = 64     # LoRA rank of the data-dependent decay path
    tokenshift_lora_rank: int = 32


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int                # query heads (0 for attention-free)
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- normalisation / activation / position ---
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-6
    activation: str = "swiglu"    # swiglu | geglu | gelu (non-gated)
    position: str = "rope"        # rope | sinusoidal | none
    rope_theta: float = 10_000.0
    use_qkv_bias: bool = False
    use_qk_norm: bool = False
    tie_embeddings: bool = False
    logits_softcap: float = 0.0

    # --- attention variants ---
    attn_window: int = 0          # 0 = full causal; >0 = sliding window
    mla: Optional[MLAConfig] = None

    # --- family extras ---
    moe: Optional[MoEConfig] = None
    rglru: Optional[RGLRUConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # --- frontend ---
    input_mode: str = "tokens"    # tokens | embeddings (vlm/audio stub frontends)

    # ------------------------------------------------------------------
    # Derived structure
    # ------------------------------------------------------------------
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: 'attention' | 'recurrent' | 'rwkv'."""
        if self.rwkv is not None:
            return ("rwkv",) * self.num_layers
        if self.rglru is not None:
            pat = self.rglru.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        return ("attention",) * self.num_layers

    @property
    def is_uniform(self) -> bool:
        """True if every layer is identical => scan-over-layers applies."""
        kinds = set(self.layer_kinds())
        if len(kinds) != 1:
            return False
        if self.moe is not None and self.moe.first_k_dense > 0:
            return False
        return True

    @property
    def attention_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, k in enumerate(self.layer_kinds()) if k == "attention")

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context (O(1)/O(window) state)?"""
        if self.rwkv is not None:
            return True
        if self.rglru is not None:
            return self.attn_window > 0
        return False

    @property
    def qk_head_dim(self) -> int:
        if self.mla is not None:
            return self.mla.qk_nope_head_dim + self.mla.qk_rope_head_dim
        return self.head_dim

    @property
    def v_head_dim(self) -> int:
        if self.mla is not None:
            return self.mla.v_head_dim
        return self.head_dim

    # ------------------------------------------------------------------
    # Parameter / cache accounting (exact, used for roofline MODEL_FLOPS)
    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla is not None:
            m = self.mla
            p = 0
            if m.q_lora_rank > 0:
                p += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * self.qk_head_dim
            else:
                p += d * self.num_heads * self.qk_head_dim
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)                    # kv down (+ shared rope key)
            p += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)  # kv up
            p += self.num_heads * m.v_head_dim * d                            # o proj
            return p
        hq, hk, dh = self.num_heads, self.num_kv_heads, self.head_dim
        p = d * hq * dh + 2 * d * hk * dh + hq * dh * d
        if self.use_qkv_bias:
            p += (hq + 2 * hk) * dh
        return p

    def _ffn_params(self, d_ff: int) -> int:
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        return mult * self.d_model * d_ff

    def _rglru_params(self) -> int:
        w = self.rglru.lru_width or self.d_model
        d = self.d_model
        conv = self.rglru.conv1d_width * w
        # linear in (x2 branches) + gates (recurrence + input, block-diagonal approx dense) + out
        return 2 * d * w + 2 * w * (w // max(1, self.rglru.num_rglru_heads or (w // 128))) + conv + w * d

    def _rwkv_params(self) -> int:
        d = self.d_model
        r = self.rwkv.decay_lora_rank
        # time-mix: r,k,v,g,o projections + decay LoRA + token-shift LoRAs (5 small)
        # + channel-mix receptance (the 2·d·d_ff channel-mix mats are counted as FFN)
        tm = 5 * d * d + (d * r + r * d) + 5 * (d * self.rwkv.tokenshift_lora_rank * 2)
        return tm + d * d

    def param_counts(self) -> dict:
        """Returns dict(total=..., active=..., embedding=...)."""
        d = self.d_model
        n_tables = 1 if (self.tie_embeddings or self.input_mode == "embeddings") else 2
        emb = self.vocab_size * d * n_tables
        total = emb
        active = emb
        for i, kind in enumerate(self.layer_kinds()):
            lp_tot = lp_act = 2 * d  # two norms
            if kind == "attention":
                a = self._attn_params()
                lp_tot += a
                lp_act += a
            elif kind == "recurrent":
                a = self._rglru_params()
                lp_tot += a
                lp_act += a
            elif kind == "rwkv":
                a = self._rwkv_params()
                lp_tot += a
                lp_act += a
            # FFN
            if self.moe is not None and i >= self.moe.first_k_dense:
                m = self.moe
                e = self._ffn_params(m.expert_d_ff)
                shared_ff = m.shared_d_ff or m.num_shared_experts * m.expert_d_ff
                s = self._ffn_params(shared_ff) if shared_ff else 0
                router = d * m.num_experts
                lp_tot += m.held_range[1] * e + s + router
                lp_act += m.top_k * e + s + router
            elif self.moe is not None and i < self.moe.first_k_dense:
                f = self._ffn_params(self.moe.dense_d_ff or self.d_ff)
                lp_tot += f
                lp_act += f
            else:
                f = self._ffn_params(self.d_ff)
                lp_tot += f
                lp_act += f
            total += lp_tot
            active += lp_act
        total += d  # final norm
        active += d
        return dict(total=int(total), active=int(active), embedding=int(emb))

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes for ONE token across all layers (the I/O unit of
        CacheFlow restoration)."""
        per_layer = 0
        if self.mla is not None:
            per_layer = (self.mla.kv_lora_rank + self.mla.qk_rope_head_dim) * dtype_bytes
        elif self.num_kv_heads > 0:
            per_layer = 2 * self.num_kv_heads * self.head_dim * dtype_bytes
        n_attn = len(self.attention_layers)
        return per_layer * n_attn

    def state_bytes(self, batch: int = 1, dtype_bytes: int = 4) -> int:
        """Recurrent-state bytes (RG-LRU / RWKV) — O(1) in sequence length."""
        b = 0
        for kind in self.layer_kinds():
            if kind == "recurrent":
                w = self.rglru.lru_width or self.d_model
                b += batch * (w + (self.rglru.conv1d_width - 1) * w) * dtype_bytes
            elif kind == "rwkv":
                h = self.d_model // self.rwkv.head_size
                b += batch * (h * self.rwkv.head_size * self.rwkv.head_size + 2 * self.d_model) * dtype_bytes
        return b

    def flops_per_token(self, context_len: int = 0) -> float:
        """Forward FLOPs per token: 2·N_active + attention quadratic term."""
        n = self.param_counts()["active"] - self.param_counts()["embedding"]
        f = 2.0 * n
        for _ in self.attention_layers:
            ctx = min(context_len, self.attn_window) if self.attn_window else context_len
            f += 2 * 2 * self.num_heads * self.qk_head_dim * ctx  # qk^T and ·v
        return f

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 4 if self.rglru is None else 6),
            d_model=128,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32 if self.num_heads else 0,
            d_ff=256,
            vocab_size=512,
        )
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
            kw["num_kv_heads"] = kw["num_heads"]
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=8, top_k=2, expert_d_ff=64,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                shared_d_ff=64 if self.moe.num_shared_experts else 0,
                first_k_dense=min(self.moe.first_k_dense, 1),
                dense_d_ff=256 if self.moe.first_k_dense else 0)
        if self.rglru is not None:
            kw["rglru"] = dataclasses.replace(self.rglru, lru_width=128, num_rglru_heads=2)
            kw["num_kv_heads"] = 1
            kw["attn_window"] = 0 if not self.attn_window else 64
        if self.rwkv is not None:
            kw["rwkv"] = dataclasses.replace(self.rwkv, head_size=32, decay_lora_rank=16,
                                             tokenshift_lora_rank=8)
        kw.update(overrides)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (every (arch x shape) is one cell of the sharding rules)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k requires sub-quadratic decode; everything else is universal
    for the (decoder-only) registry."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


# ---------------------------------------------------------------------------
# Hardware profiles (roofline constants the cost model reads)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float          # per chip, bf16
    hbm_bw: float              # bytes/s per chip
    link_bw: float             # bytes/s per ICI link
    hbm_bytes: float
    # serving-simulation extras
    kernel_overhead_s: float = 30e-6   # fixed per-launch overhead (paper's c0)


HARDWARE = {
    "tpu_v5e": HardwareProfile("tpu_v5e", 197e12, 819e9, 50e9, 16e9),
    # Paper GPUs; h100 is the port's serve CLI default (the card it runs on)
    "l40s": HardwareProfile("l40s", 181e12, 864e9, 32e9, 46e9, kernel_overhead_s=20e-6),
    "a100": HardwareProfile("a100", 312e12, 1555e9, 300e9, 40e9, kernel_overhead_s=15e-6),
    "h100": HardwareProfile("h100", 989e12, 3350e9, 450e9, 80e9, kernel_overhead_s=12e-6),
}

GBPS = 1e9 / 8  # bytes/s per Gbps

# Paper's studied I/O bandwidths (bytes/s)
IO_BANDWIDTHS = {"10Gbps": 10 * GBPS, "40Gbps": 40 * GBPS, "80Gbps": 80 * GBPS}
