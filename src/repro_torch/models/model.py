"""Model builder: config -> functional model with the restoration-chunk,
suffix-prefill and decode entry points.

Counterpart of ``repro.models.model`` for dense attention stacks.
Parameters are a plain dict of tensors: ``embed``, ``unembed``,
``final_norm`` and ``layers`` — a list of per-layer dicts (the reference
stacks identical layers for ``lax.scan``; PyTorch runs eagerly, so the
port keeps one dict per layer).  :func:`params_from_jax` converts the
reference's ``Model.init`` pytree into this layout.

Every entry point runs on the model's device, which defaults to CUDA;
``device="cpu"`` must be asked for.  Positions live on the host (see
``attention.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.kvcache import init_cache, layer_slots
from repro_torch.models.layers import apply_norm, embed_init, init_norm


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA without a card raises (no
    entry point carries on on the CPU when it finds no GPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available()"
                           " is False; pass device='cpu' to run on the CPU")
    return dev


class Model:
    def __init__(self, cfg: ModelConfig, *, param_dtype=torch.float32,
                 compute_dtype=torch.float32, device="cuda"):
        if (cfg.mla is not None or cfg.moe is not None or cfg.rglru is not None
                or cfg.rwkv is not None or cfg.input_mode != "tokens"
                or cfg.position not in ("rope", "none")):
            raise NotImplementedError(
                f"{cfg.name}: only dense token-input attention models are "
                f"ported so far")
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.slots = layer_slots(cfg)

    # ------------------------------------------------------------------
    # Params
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        """Random weights from ``generator`` (which must live on the
        model's device): truncated-normal fan-in for dense weights, N(0,
        0.02) for embeddings, ones for norm scales — the reference's
        distributions, not its values."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg, dt = self.cfg, self.param_dtype
        p: dict = {"embed": embed_init((cfg.vocab_size, cfg.d_model), dt, generator)}
        if not cfg.tie_embeddings:
            p["unembed"] = embed_init((cfg.d_model, cfg.vocab_size), dt, generator)
        p["final_norm"] = init_norm(cfg.norm, cfg.d_model, dt, self.device)
        p["layers"] = [tfm.init_layer(cfg, dt, generator)
                       for _ in range(cfg.num_layers)]
        return p

    def num_params(self, params) -> int:
        return sum(t.numel() for t in _leaves(params))

    def layer_params(self, params, i: int) -> dict:
        return params["layers"][i]

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def embed(self, params, inputs, positions=None):
        """inputs: (B, S) int token ids (host or device)."""
        ids = inputs.to(self.device, torch.long)
        return params["embed"][ids].to(self.compute_dtype)

    def unembed(self, params, x):
        cfg = self.cfg
        x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        table = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return x @ table.to(x.dtype)

    # ------------------------------------------------------------------
    # Cached-chunk forward (decode C=1; restoration chunks C>1)
    # ------------------------------------------------------------------
    def _layer_cached(self, p, kind, slot, x, positions, cache):
        # views of this layer's slot: the attention writes the chunk's KV
        # straight into the stacked cache (the reference's .at[slot].set
        # of the whole stacked array)
        view = {"k": cache["k"][slot], "v": cache["v"][slot],
                "kpos": cache["kpos"][slot]}
        x, _ = tfm.attention_layer_cached(self.cfg, p, x, positions, view)
        return x, cache

    def layer_chunk(self, params, i: int, x, positions, cache):
        """One layer over a chunk, attending to + updating the cache."""
        kind, slot = self.slots[i]
        return self._layer_cached(self.layer_params(params, i), kind, slot, x,
                                  positions, dict(cache))

    def stack_chunk(self, params, x, positions, cache, lo: int = 0,
                    hi: Optional[int] = None):
        """Run layers [lo, hi) over a chunk (B,C,D), attending to + updating
        the cache. The workhorse of token-wise and stage-local restoration."""
        hi = self.cfg.num_layers if hi is None else hi
        cache = dict(cache)
        for i in range(lo, hi):
            kind, slot = self.slots[i]
            x, cache = self._layer_cached(self.layer_params(params, i), kind,
                                          slot, x, positions, cache)
        return x, cache

    def decode_step(self, params, tokens, cache, pos: int):
        """tokens: (B,) int; pos: int.  Returns (logits (B,V), cache)."""
        b = tokens.shape[0]
        positions = torch.full((b, 1), int(pos), dtype=torch.int32)
        x = self.embed(params, tokens[:, None], positions)
        x, cache = self.stack_chunk(params, x, positions, cache)
        return self.unembed(params, x)[:, 0], cache

    def prefill_chunk(self, params, inputs, cache, start_pos: int):
        """Chunk prefill against an existing cache: inputs (B,C); returns
        (last logits, cache)."""
        b, c = inputs.shape[:2]
        positions = (int(start_pos) + torch.arange(c, dtype=torch.int32)).expand(b, c)
        x = self.embed(params, inputs, positions)
        x, cache = self.stack_chunk(params, x, positions, cache)
        logits = self.unembed(params, x[:, -1:])
        return logits[:, 0], cache

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None):
        return init_cache(self.cfg, batch, max_len, dtype or self.compute_dtype,
                          self.device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)          # bf16 has no numpy dtype: via f32
    t = torch.from_numpy(np.array(a))      # a writable copy
    return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)


def params_from_jax(tree: dict, *, dtype=torch.float32, device="cuda") -> dict:
    """The reference ``Model.init`` pytree (as numpy arrays: ``prefix_layers``
    list + stacked ``scan_layers``) -> the port's parameter dict."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, dtype, dev)

    out = {k: conv(v) for k, v in tree.items()
           if k not in ("prefix_layers", "scan_layers")}
    layers = [conv(p) for p in tree.get("prefix_layers", [])]
    scan = tree.get("scan_layers")
    if scan is not None:
        n = len(next(iter(_leaves(scan))))

        def index(node, j):
            if isinstance(node, dict):
                return {k: index(v, j) for k, v in node.items()}
            return np.asarray(node)[j]

        layers += [conv(index(scan, j)) for j in range(n)]
    out["layers"] = layers
    return out
