"""Operations and bytes of the model's ops and of each kernel launch, and
the chip's peaks they are held against.

Counts follow what the inputs need, never what a kernel happens to touch:
attention counts each query row against the keys it may see (causal: the
row at position p sees p + 1 of them), a mixture of experts counts the
experts a token is routed to, and only the matrix products are counted.
A kernel's bytes count each input byte read once and each output byte
written once.

The peaks and ``bound_s`` are a copy of ``chip_smoke.py``'s ``bound`` (NVIDIA's data
sheet of the H100 SXM: dense bf16 products and HBM3 bandwidth).
"""
from __future__ import annotations

from dataclasses import dataclass

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds a call could take on the chip: its bytes at the
    HBM bandwidth or its products at the bf16 peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


@dataclass(frozen=True)
class Shape:
    """The widths that set a qwen3 layer's products (dense or MoE)."""
    layers: int
    d: int
    hq: int
    hkv: int
    dh: int
    ff: int            # dense FFN width (0 in a MoE layer)
    vocab: int
    experts: int = 0
    top_k: int = 0
    expert_ff: int = 0

    @classmethod
    def of(cls, hf: dict) -> "Shape":
        """From a configuration's published keys (``config.json`` names)."""
        moe = hf.get("num_experts", 0)
        return cls(layers=hf["num_hidden_layers"], d=hf["hidden_size"],
                   hq=hf["num_attention_heads"], hkv=hf["num_key_value_heads"],
                   dh=hf["head_dim"], ff=0 if moe else hf["intermediate_size"],
                   vocab=hf["vocab_size"], experts=moe,
                   top_k=hf.get("num_experts_per_tok", 0),
                   expert_ff=hf.get("moe_intermediate_size", 0))

    def linear_per_token(self) -> int:
        """Products of one token through one layer, attention scores aside:
        q, k, v and o projections and the FFN (router and routed experts
        in a MoE layer)."""
        attn = 2 * self.d * (self.hq * self.dh + 2 * self.hkv * self.dh) \
            + 2 * self.hq * self.dh * self.d
        if self.experts:
            ffn = 2 * self.d * self.experts + self.top_k * 6 * self.d * self.expert_ff
        else:
            ffn = 6 * self.d * self.ff
        return attn + ffn

    def attention(self, p0: int, rows: int) -> int:
        """QK^T and PV of ``rows`` query rows from position ``p0``, each
        over the p + 1 keys it sees, in one layer."""
        seen = rows * (2 * p0 + rows + 1) // 2
        return 4 * self.hq * self.dh * seen

    def unembed(self, rows: int) -> int:
        return 2 * self.d * self.vocab * rows

    def span(self, t0: int, t1: int, lo: int, hi: int, logits_rows: int = 0) -> int:
        """Products of tokens [t0, t1) through layers [lo, hi), plus the
        unembedding of ``logits_rows`` rows."""
        per_layer = (t1 - t0) * self.linear_per_token() + self.attention(t0, t1 - t0)
        return (hi - lo) * per_layer + self.unembed(logits_rows)


# ---------------------------------------------------------------------------
# Kernel launches: (flops, bytes) from the shapes a launch was called with.
# ---------------------------------------------------------------------------

def flash_prefill(b: int, sq: int, hq: int, hkv: int, dh: int, q_offset: int,
                  esz: int = 2):
    """Rows [q_offset, q_offset + sq) of a causal chunk over a cache whose
    slots up to the last row's position are filled: q read and the output
    written once, K and V read for the slots the rows see, kpos for them."""
    seen = q_offset + sq
    flops = 4 * b * hq * dh * (sq * (2 * q_offset + sq + 1) // 2)
    nbytes = 2 * b * sq * hq * dh * esz + 2 * b * seen * hkv * dh * esz + 4 * seen
    return flops, nbytes


def flash_decode(b: int, hq: int, hkv: int, dh: int, q_pos: int, esz: int = 2):
    """One query row at ``q_pos`` over the q_pos + 1 slots it sees."""
    seen = q_pos + 1
    flops = 4 * b * hq * dh * seen
    nbytes = 2 * b * hq * dh * esz + 2 * b * seen * hkv * dh * esz + 4 * seen
    return flops, nbytes


def kv_restore(n_slots: int, rows: int, chans: tuple, in_esz: int, out_esz: int,
               chunk_size: int, scaled: bool):
    """One restoration load's dequantizing scatter: ``rows`` staged rows of
    ``n_slots`` slots in every field written into the live cache, and a
    float32 scale per chunk and channel read (int8 runs).  The staged rows
    themselves are not counted: the copy that staged them ends just before
    the launch, so the kernel may read them from L2 rather than from HBM.  Its only
    arithmetic is the scaling, no product: all bytes."""
    c = sum(chans)
    nbytes = n_slots * rows * c * out_esz
    if scaled:
        nbytes += -(-rows // max(1, chunk_size)) * c * 4
    return 0, nbytes
