"""CacheFlow cost models and analysis (paper §3.1–§3.2).

T_comp(n): recomputing n prefix tokens — quadratic attention term + linear
param term + fixed per-chunk overhead (kernel launches, weight streaming).
T_io(n): loading n tokens' KV — linear in bytes, bounded by channel bandwidth.

Closed forms used throughout:
  optimal split    ℓ* = L·T_io / (T_comp + T_io)                      (Eq. 1)
  optimal time     T* = T_comp·T_io / (T_comp + T_io)   (harmonic mean)
  S-stage speedup  T*_multi = T*/S                                    (Eq. 2)
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.config import HardwareProfile, ModelConfig


@dataclass(frozen=True)
class CostModel:
    """Per-(model, hardware, bandwidth) restoration cost model.

    All times in seconds, token counts in tokens.
    """
    cfg: ModelConfig
    hw: HardwareProfile
    io_bandwidth: float            # bytes/s of the KV channel
    mfu: float = 0.5               # achievable fraction of peak during prefill
    num_chips: int = 1             # chips sharing the recompute (TP group)
    io_channels: int = 1           # parallel I/O channels
    # fraction of restoration-compute throughput a LIVE decode batch eats
    # (continuous batching: recurring decode steps timeshare the same chips
    # as chunk recomputes, so at steady state the compute alternative the
    # §3.3 benefit gate prices is slower than on an idle device).  0.0 keeps
    # the classic idle-device pricing.
    decode_interference: float = 0.0

    # ------------------------------------------------------------------
    def flops_recompute(self, n0: int, n1: int) -> float:
        """FLOPs to recompute tokens [n0, n1) given [0, n0) is already
        restored: linear param term + attention over the growing context."""
        pc = self.cfg.param_counts()
        n_active = pc["active"] - pc["embedding"]
        n = n1 - n0
        f = 2.0 * n_active * n
        # attention: each token t attends to t+1 keys (or window)
        n_attn = len(self.cfg.attention_layers)
        avg_ctx = (n0 + n1) / 2.0
        if self.cfg.attn_window:
            avg_ctx = min(avg_ctx, float(self.cfg.attn_window))
        f += 2.0 * 2.0 * n_attn * self.cfg.num_heads * self.cfg.qk_head_dim * n * avg_ctx
        return f

    def t_comp_range(self, n0: int, n1: int, chunks: int = 1) -> float:
        """Seconds to recompute tokens [n0, n1) in ``chunks`` kernel launches."""
        if n1 <= n0:
            return 0.0
        f = self.flops_recompute(n0, n1)
        return f / (self.hw.peak_flops * self.mfu * self.num_chips) \
            + chunks * self.hw.kernel_overhead_s

    def t_comp(self, n: int, chunk_size: int = 512) -> float:
        import math
        return self.t_comp_range(0, n, chunks=max(1, math.ceil(n / max(1, chunk_size))))

    # ------------------------------------------------------------------
    def bytes_per_token(self) -> int:
        return self.cfg.kv_bytes_per_token()

    def t_io_tokens(self, n: int) -> float:
        """Seconds to load n tokens' KV (all layers) over the channel(s)."""
        return n * self.bytes_per_token() / (self.io_bandwidth * self.io_channels)

    def t_io_layer_tokens(self, n_layers: int, n_tokens: int) -> float:
        n_attn = max(1, len(self.cfg.attention_layers))
        per_layer = self.bytes_per_token() / n_attn
        return n_layers * n_tokens * per_layer / (self.io_bandwidth * self.io_channels)

    # ------------------------------------------------------------------
    # Decode (lifecycle phases beyond restoration)
    # ------------------------------------------------------------------
    def t_decode_step(self, context_lens) -> float:
        """One batched decode step (one token for each request in the
        continuous batch): HBM-bandwidth-bound — the weights stream once
        per step and each request's KV context is read once — plus the
        fixed kernel overhead.  ``context_lens`` are per-request attended
        context lengths (capped by the attention window).  The weight-
        streaming term is paid once per step regardless of batch size, so a
        PARTIAL batch (requests streaming in/out mid-flight) amortizes it
        worse — per-request step cost falls as the continuous batch fills.
        An empty batch costs nothing (no step is issued)."""
        if not context_lens:
            return 0.0
        pc = self.cfg.param_counts()
        param_bytes = 2.0 * (pc["active"] - pc["embedding"])   # bf16 weights
        kv = 0.0
        for n in context_lens:
            if self.cfg.attn_window:
                n = min(n, self.cfg.attn_window)
            kv += n * self.bytes_per_token()
        return (param_bytes + kv) / (self.hw.hbm_bw * self.num_chips) \
            + self.hw.kernel_overhead_s

    # ------------------------------------------------------------------
    # Paper closed forms
    # ------------------------------------------------------------------
    def harmonic_bound(self, n: int) -> float:
        """T* = Tc·Tio/(Tc+Tio) — the two-pointer optimum (Eq. 1)."""
        tc = self.t_comp(n)
        tio = self.t_io_tokens(n)
        if tc + tio == 0:
            return 0.0
        return tc * tio / (tc + tio)

    def optimal_token_split(self, n: int) -> int:
        """Number of tokens to recompute from the front (rest loaded from the
        back). Accounts for the quadratic skew: front tokens are cheaper to
        recompute, so the optimum recomputes MORE than the linear-cost split
        would suggest. Solved by bisection on equal finish times."""
        lo, hi = 0, n
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if self.t_comp(mid) <= self.t_io_tokens(n - mid):
                lo = mid
            else:
                hi = mid
        return lo

    def t_token_wise(self, n: int) -> float:
        """Finish time of the optimal token-wise two-pointer schedule."""
        split = self.optimal_token_split(n)
        return max(self.t_comp(split), self.t_io_tokens(n - split))

    def optimal_layer_split(self, n: int) -> int:
        """Cutover layer ℓ: layers [0,ℓ) recomputed (one forward to layer ℓ),
        layers [ℓ,L) loaded top-down."""
        L = self.cfg.num_layers
        tc_full = self.t_comp(n, chunk_size=n)       # single launch, all layers
        lo, hi = 0, L
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if tc_full * mid / L <= self.t_io_layer_tokens(L - mid, n):
                lo = mid
            else:
                hi = mid
        return lo

    def t_layer_wise(self, n: int) -> float:
        L = self.cfg.num_layers
        ell = self.optimal_layer_split(n)
        tc_full = self.t_comp(n, chunk_size=n)
        return max(tc_full * ell / L, self.t_io_layer_tokens(L - ell, n))

    def crossover_l_delta(self, max_n: int = 65536, step: int = 128) -> int:
        """L_Δ = min{N | T_token(N) <= T_layer(N)} (paper Fig. 3). Largely
        hardware-dependent: token-wise wins once per-chunk fixed overheads
        amortise."""
        n = step
        while n <= max_n:
            if self.t_token_wise(n) <= self.t_layer_wise(n):
                return n
            n += step
        return max_n

    def stage_parallel_bound(self, n: int, stages: int) -> float:
        """Eq. 2: T*/S with boundary activations decoupling stages."""
        return self.harmonic_bound(n) / max(1, stages)

    def boundary_activation_bytes(self, n: int, dtype_bytes: int = 2) -> int:
        """Per stage boundary: n × d_model activations — the price of 3D
        decoupling (vs the stage's KV slice it replaces)."""
        return n * self.cfg.d_model * dtype_bytes
