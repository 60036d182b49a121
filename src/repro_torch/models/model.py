"""Model builder: config -> functional model with the whole-sequence
(``forward``: training; ``prefill``), restoration-chunk, suffix-prefill and
decode entry points.

Counterpart of ``repro.models.model`` for every family of the registry:
dense and MoE attention stacks (GQA or MLA), the RecurrentGemma hybrid
(RG-LRU and local-attention layers), RWKV-6 stacks, and the embedding-input
frontends (the model takes (B, S, D) embeddings instead of token ids).
Parameters are a plain dict of tensors: ``embed`` (token models only),
``unembed``, ``final_norm`` and ``layers`` — a list of per-layer dicts (the
reference stacks identical layers for ``lax.scan`` and unrolls a
non-uniform prefix such as DeepSeek's first dense layer; PyTorch runs
eagerly, so the port keeps one dict per layer).  :func:`params_from_jax`
converts the reference's ``Model.init`` pytree into this layout.

Serving is dropless: the port's MoE dispatch ignores the config's
``capacity_factor`` (the reference's ``Model`` replaces it by 0), so
chunked recomputation reproduces the full-prefill KV.  Every entry point
takes the capacity path only in a model built with ``moe_dropless=False``;
``moe_groups`` runs the MoE over that many groups of the sequence, one
after another, in the full and cached layers.

``decode_rows`` is the serving engine's decode step: one token of each of
many requests in one pass, every layer issued once for all of them, each
request's attention over its own cache.

``decode_step_append`` is the reference's append-buffer decode: the new
token's KV goes into a small tail (``init_tail``) and attention runs over
[cache || tail] in ``flash_decode``, the prefix cache left read-only.

``backend`` is the reference's choice of the whole-sequence attention:
``"auto"`` (the masked softmax up to ``attention.FLASH_THRESHOLD`` keys,
the blocked online softmax above) or ``"flash"`` (always blocked).  The
chunked and decode paths run the hand-written kernels whatever it says.

``remat_policy`` rematerialises each layer of ``forward`` in the backward
pass (``torch.utils.checkpoint``, non-reentrant): ``"full"`` and
``"nothing"`` save nothing, ``"dots"`` saves the weight products
(``aten.mm``/``aten.addmm``) and recomputes the rest, batched attention
products (``aten.bmm``) included — the reference's
``dots_with_no_batch_dims_saveable``.

Every entry point runs on the model's device, which defaults to CUDA;
``device="cpu"`` must be asked for.  Positions live on the host (see
``attention.py``).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import ModelConfig
from repro_torch.distributed.collectives import lse_decode_attention
from repro_torch.distributed.constraints import (ambient_mesh, axis_size, constrain,
                                                 write_slots)
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import _is_dtensor
from repro_torch.models import mla as mla_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.kvcache import cache_seq_len, init_cache, layer_slots
from repro_torch.models.layers import (apply_norm, embed_init, init_norm,
                                       sinusoidal_positions)


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
                 compute_dtype=torch.float32, device="cuda", remat_policy: str = "none",
                 moe_groups: int = 0, moe_dropless: bool = True, backend: str = "auto"):
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r}: one of {REMAT_POLICIES}")
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.remat_policy = remat_policy
        self.moe_groups = moe_groups
        self.moe_dropless = moe_dropless
        attn_mod.use_flash(backend, 0)          # refuses an unknown backend
        self.backend = backend
        self.slots = layer_slots(cfg)

    # ------------------------------------------------------------------
    # Params
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        """Random weights from ``generator`` (which must live on the
        model's device): truncated-normal fan-in for dense weights, N(0,
        0.02) for embeddings, ones for norm scales, the MoE router in f32 —
        the reference's distributions, not its values.  An embedding-input
        model has no ``embed`` table."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg, dt = self.cfg, self.param_dtype
        p: dict = {}
        if cfg.input_mode == "tokens":
            p["embed"] = embed_init((cfg.vocab_size, cfg.d_model), dt, generator)
        if not cfg.tie_embeddings:
            p["unembed"] = embed_init((cfg.d_model, cfg.vocab_size), dt, generator)
        p["final_norm"] = init_norm(cfg.norm, cfg.d_model, dt, self.device)
        p["layers"] = [tfm.init_layer(cfg, i, dt, generator)
                       for i in range(cfg.num_layers)]
        return p

    def param_specs(self) -> dict:
        """The parameter tree as ``meta`` tensors: shapes and dtypes, no
        storage (the reference's ``jax.eval_shape`` of ``init``)."""
        meta = Model(self.cfg, param_dtype=self.param_dtype,
                     compute_dtype=self.compute_dtype, device="meta")
        return meta.init(_MetaGenerator())

    def num_params(self, params) -> int:
        return sum(t.numel() for t in _leaves(params))

    def layer_params(self, params, i: int) -> dict:
        return params["layers"][i]

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def embed(self, params, inputs, positions=None):
        """inputs: (B, S) int token ids, or (B, S, D) float embeddings for an
        embedding-input model (host or device); positions (B, S) (host or
        device) are read for sinusoidal positions only."""
        cfg = self.cfg
        if cfg.input_mode == "tokens":
            # F.embedding, not indexing: on the CPU its backward sums a row's
            # gradients in a fixed order (indexing's scatter-add does not)
            # on a mesh the table is gathered whole first (DTensor's
            # vocab-parallel lookup does not take a 2-D mesh)
            x = F.embedding(inputs.to(self.device, torch.long),
                            constrain(params["embed"], None, None)).to(self.compute_dtype)
        else:
            x = inputs.to(self.device, self.compute_dtype)
        if cfg.position == "sinusoidal":
            x = x + sinusoidal_positions(positions.to(self.device),
                                         cfg.d_model).to(x.dtype)
        return x

    def unembed(self, params, x):
        cfg = self.cfg
        x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        table = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return x @ table.to(x.dtype)

    # ------------------------------------------------------------------
    # Full forward (train) / prefill
    # ------------------------------------------------------------------
    def _layer_full(self, p, kind, x, positions, states):
        """One layer, full sequence, from ``states`` (the recurrent and RWKV
        kinds' carried state).  Returns (x', cache entry or new state, aux).

        Layer boundaries carry the reference's sharding constraints: batch
        over ("pod", "data") and sequence over "model" (Megatron-SP style),
        which pin the sharded run to gathering weights per layer rather
        than replicating activations.  No-ops off-mesh."""
        cfg = self.cfg
        if kind == "attention":
            x, entry, aux = tfm.attention_layer_full(cfg, p, x, positions,
                                                     dropless=self.moe_dropless,
                                                     moe_groups=self.moe_groups,
                                                     backend=self.backend)
            entry = {f: constrain(a, ("pod", "data"), "model") for f, a in entry.items()}
            return constrain(x, ("pod", "data"), "model", None), entry, aux
        if kind == "recurrent":
            conv, h0 = states
            x, conv, h = tfm.recurrent_layer_full(cfg, p, x, conv, h0)
            return constrain(x, ("pod", "data"), "model", None), (conv, h), 0.0
        if kind == "rwkv":
            x, stm, scm, wkv = tfm.rwkv_layer_full(cfg, p, x, *states)
            return constrain(x, ("pod", "data"), "model", None), (stm, scm, wkv), 0.0
        raise ValueError(kind)

    def fresh_state(self, kind: str, b: int, dtype):
        """Zero carried state of a recurrent or RWKV layer (None for
        attention) on the model's device."""
        cfg, dev = self.cfg, self.device
        if kind == "recurrent":
            w = cfg.rglru.lru_width or cfg.d_model
            return (torch.zeros((b, cfg.rglru.conv1d_width - 1, w), dtype=dtype, device=dev),
                    torch.zeros((b, w), dtype=torch.float32, device=dev))
        if kind == "rwkv":
            hs = cfg.rwkv.head_size
            return (torch.zeros((b, cfg.d_model), dtype=dtype, device=dev),
                    torch.zeros((b, cfg.d_model), dtype=dtype, device=dev),
                    torch.zeros((b, cfg.d_model // hs, hs, hs), dtype=torch.float32,
                                device=dev))
        return None

    def run_layer_full(self, params, i: int, x, positions, states=None):
        """One layer, full-sequence mode, from fresh state unless ``states``
        is given.  Returns (x', cache entry or state)."""
        kind = self.cfg.layer_kinds()[i]
        if states is None:
            states = self.fresh_state(kind, x.shape[0], x.dtype)
        return self._layer_full(self.layer_params(params, i), kind, x, positions,
                                states)[:2]

    def positions_of(self, b: int, s: int, positions=None) -> torch.Tensor:
        """(B, S) int32 positions on the model's device: 0..S-1 unless given."""
        if positions is None:
            return torch.arange(s, dtype=torch.int32, device=self.device).expand(b, s)
        return positions.to(self.device)

    def forward(self, params, inputs, positions=None, collect_cache: bool = False):
        """Whole-sequence forward of (B, S) tokens or (B, S, D) embeddings.

        Returns (logits, aux) or, with ``collect_cache``, (logits, aux,
        entries): each layer's whole-sequence cache entry ({"k", "v"} or
        {"ckv"}) or final state, in layer order.  Each layer runs under
        the model's ``remat_policy``."""
        b, s = inputs.shape[:2]
        positions = self.positions_of(b, s, positions)
        x = self.embed(params, inputs, positions)
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        entries = []
        layer = _remat(self._layer_full, self.remat_policy)
        for i, kind in enumerate(self.cfg.layer_kinds()):
            x, entry, aux = layer(params["layers"][i], kind, x, positions,
                                  self.fresh_state(kind, b, x.dtype))
            aux_total = aux_total + aux
            if collect_cache:
                entries.append(entry)
        logits = self.unembed(params, x)
        if collect_cache:
            return logits, aux_total, entries
        return logits, aux_total

    def prefill(self, params, inputs, positions=None):
        """Returns (last-token logits (B, V), the cache filled with the
        sequence; ``grow_cache`` lengthens it for decode)."""
        b, s = inputs.shape[:2]
        default = positions is None
        positions = self.positions_of(b, s, positions)
        logits, _, entries = self.forward(params, inputs, positions, collect_cache=True)
        return logits[:, -1], self._entries_to_cache(entries, positions, s,
                                                     default_positions=default)

    def _entries_to_cache(self, entries, positions, s: int,
                          max_len: Optional[int] = None,
                          default_positions: bool = False) -> dict:
        """The stacked cache dict from per-layer whole-sequence entries: the
        last ``attn_window`` tokens in their ring slots for a windowed
        config, else every token at its position; kpos -1 elsewhere.  With
        ``default_positions`` (0..S-1) and DTensor entries (on a mesh) the
        slots are known on the host and written through the shards that
        hold them (``write_slots``)."""
        cfg = self.cfg
        s_cache = cache_seq_len(cfg, max_len or s)
        kinds = cfg.layer_kinds()
        attn_e = [e for e, k in zip(entries, kinds) if k == "attention"]
        rec_e = [e for e, k in zip(entries, kinds) if k == "recurrent"]
        rwkv_e = [e for e, k in zip(entries, kinds) if k == "rwkv"]
        cache: dict = {}
        pos_row = positions[0].long()
        if attn_e:
            lo = s - s_cache if cfg.attn_window and s > s_cache else 0
            slot = pos_row[lo:] % s_cache

            def to_cache(a):
                buf = a.new_zeros((a.shape[0], s_cache) + a.shape[2:])
                if default_positions and _is_dtensor(a):
                    return write_slots(buf, 1, [p % s_cache for p in range(lo, s)],
                                       a[:, lo:])
                buf[:, slot] = a[:, lo:]
                return buf

            fields = ("ckv",) if cfg.mla is not None else ("k", "v")
            for f in fields:
                cache[f] = torch.stack([to_cache(e[f]) for e in attn_e])
            kpos = torch.full((s_cache,), -1, dtype=torch.int32, device=pos_row.device)
            kpos[slot] = pos_row[lo:].int()
            cache["kpos"] = kpos[None].repeat(len(attn_e), 1)
        if rec_e:
            cache["conv"] = torch.stack([e[0] for e in rec_e])
            cache["lru"] = torch.stack([e[1] for e in rec_e])
        if rwkv_e:
            cache["shift_tm"] = torch.stack([e[0] for e in rwkv_e])
            cache["shift_cm"] = torch.stack([e[1] for e in rwkv_e])
            cache["wkv"] = torch.stack([e[2] for e in rwkv_e])
        return cache

    # ------------------------------------------------------------------
    # Cached-chunk forward (decode C=1; restoration chunks C>1)
    # ------------------------------------------------------------------
    def _layer_cached(self, p, kind, slot, x, positions, cache):
        # every kind writes this layer's slot of the stacked cache in place
        # (the reference's .at[slot].set of the whole stacked array); the
        # attention writes the chunk's KV through views of the slot
        if kind == "attention":
            fields = ("ckv", "kpos") if self.cfg.mla is not None else ("k", "v", "kpos")
            view = {f: cache[f][slot] for f in fields}
            x, _ = tfm.attention_layer_cached(self.cfg, p, x, positions, view,
                                              dropless=self.moe_dropless,
                                              moe_groups=self.moe_groups)
            return x, cache
        if kind == "recurrent":
            x, conv, h = tfm.recurrent_layer_full(self.cfg, p, x,
                                                  cache["conv"][slot],
                                                  cache["lru"][slot])
            cache["conv"][slot] = conv
            cache["lru"][slot] = h
            return x, cache
        if kind == "rwkv":
            x, stm, scm, wkv = tfm.rwkv_layer_full(self.cfg, p, x,
                                                   cache["shift_tm"][slot],
                                                   cache["shift_cm"][slot],
                                                   cache["wkv"][slot])
            cache["shift_tm"][slot] = stm
            cache["shift_cm"][slot] = scm
            cache["wkv"][slot] = wkv
            return x, cache
        raise ValueError(kind)

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
        """tokens: (B,) int (or (B, D) embeddings); pos: int.  Returns
        (logits (B,V), cache)."""
        b = tokens.shape[0]
        positions = torch.full((b, 1), int(pos), dtype=torch.int32)
        x = self.embed(params, tokens[:, None], positions)
        x, cache = self.stack_chunk(params, x, positions, cache)
        return self.unembed(params, x)[:, 0], cache

    def can_decode_rows(self, caches) -> bool:
        """Whether :meth:`decode_rows` takes these requests' caches: every
        layer is attention (a recurrent or RWKV layer carries per-request
        state), the MoE is dropless (a capacity's drops would depend on the
        batch) and no cache is a DTensor."""
        cfg = self.cfg
        return (all(k == "attention" for k in cfg.layer_kinds())
                and (cfg.moe is None or self.moe_dropless)
                and not any(_is_dtensor(c["kpos"]) for c in caches))

    def decode_rows(self, params, tokens, caches, positions):
        """One decode token of each of B requests in one pass: ``tokens``
        (B,) int (or (B, D) embeddings), ``caches`` the B requests' own
        cache dicts (batch 1, each of its own length), ``positions`` one
        host int a row.  Every layer's norms, projections and FFN and the
        unembedding run once for the B rows; each row writes its KV into
        its own cache, in place, and attends over it alone.  A stack that
        :meth:`can_decode_rows` takes only.  Returns logits (B, V)."""
        pos_dev = torch.tensor(positions, dtype=torch.int32, device=self.device)[:, None]
        x = self.embed(params, tokens[:, None], pos_dev)
        fields = ("ckv", "kpos") if self.cfg.mla is not None else ("k", "v", "kpos")
        # each row's cache split into its layer slots once for the step
        rows = [{f: c[f].unbind(0) for f in fields} for c in caches]
        for i, p in enumerate(params["layers"]):
            _, slot = self.slots[i]
            views = [{f: r[f][slot] for f in fields} for r in rows]
            x = tfm.attention_layer_rows(self.cfg, p, x, pos_dev, positions, views,
                                         dropless=self.moe_dropless,
                                         moe_groups=self.moe_groups)
        return self.unembed(params, x)[:, 0]

    def prefill_chunk(self, params, inputs, cache, start_pos: int):
        """Chunk prefill against an existing cache: inputs (B,C) (or
        (B,C,D) embeddings); returns (last logits, cache)."""
        b, c = inputs.shape[:2]
        positions = (int(start_pos) + torch.arange(c, dtype=torch.int32)).expand(b, c)
        x = self.embed(params, inputs, positions)
        x, cache = self.stack_chunk(params, x, positions, cache)
        logits = self.unembed(params, x[:, -1:])
        return logits[:, 0], cache

    # ------------------------------------------------------------------
    # Append-buffer decode
    # ------------------------------------------------------------------
    def decode_step_append(self, params, tokens, cache, tail, tail_len: int, pos: int):
        """Append-buffer decode: the prefix ``cache`` stays read-only; the new
        token's KV (or MLA latent) goes into slot ``tail_len`` of a small
        ``tail`` (``init_tail``: a cache of W slots, kpos -1 where empty),
        and every layer attends over [cache || tail], the two concatenated
        with their kpos.  Under an ambient mesh whose "model" dim is above 1
        and does not divide ``num_kv_heads`` (a GQA cache sharded along its
        sequence by ``cache_pspecs``), the attention is the reference's
        sequence-sharded branch instead: ``lse_decode_attention``, each
        rank's shard partial combined across ranks, the tail merged on
        seq-rank 0, and the cache never gathered.  A uniform attention
        stack only, as the reference.

        tokens (B,) (or (B, D) embeddings); pos: int.  The tail is written
        in place.  Returns (logits (B, V), tail)."""
        cfg = self.cfg
        if not (cfg.is_uniform and cfg.num_layers) or cfg.layer_kinds()[0] != "attention":
            raise ValueError(f"{cfg.name}: append-buffer decode requires a uniform "
                             "attention stack (every layer alike, no dense prefix)")
        b = tokens.shape[0]
        positions = torch.full((b, 1), int(pos), dtype=torch.int32, device=self.device)
        x = self.embed(params, tokens[:, None], positions)
        x, tail = self._decode_append_scan(params, x, positions, cache, tail, int(tail_len),
                                           int(pos))
        return self.unembed(params, x)[:, 0], tail

    def _decode_append_scan(self, params, x, positions, cache, tail, tail_len: int,
                            pos: int):
        """The layers in order (the reference's ``lax.scan`` over its
        stacked layers); ``pos`` is ``positions``' value on the host.  Each
        layer's attention reads a copy of its whole cache slot joined to its
        tail slot, as the reference's concatenation does, or on a
        sequence-sharded cache combines the ranks' partials.  Returns (x,
        tail)."""
        cfg = self.cfg
        scale = 1.0 / (cfg.qk_head_dim ** 0.5)
        mesh = ambient_mesh()
        msize = axis_size(mesh, "model") if mesh is not None else 1
        seq_sharded = msize > 1 and cfg.num_kv_heads % msize != 0
        for i, p in enumerate(params["layers"]):
            _, slot = self.slots[i]
            h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
            tail["kpos"][slot, tail_len] = pos
            kp = torch.cat([cache["kpos"][slot], tail["kpos"][slot]])
            if cfg.mla is not None:
                q_nope, q_rope = mla_mod._project_q(cfg, p["attn"], h, positions)
                ckv = tail["ckv"][slot]
                ckv[:, tail_len] = mla_mod.compress_kv(cfg, p["attn"], h,
                                                       positions)[:, 0].to(ckv.dtype)
                full = torch.cat([cache["ckv"][slot], ckv], dim=1)
                a = mla_mod.mla_attend_absorbed(cfg, p["attn"], q_nope, q_rope, positions,
                                                full.to(h.dtype), kp)
            else:
                q, k_new, v_new = attn_mod.project_qkv(cfg, p["attn"], h, positions)
                kt, vt = tail["k"][slot], tail["v"][slot]
                kt[:, tail_len] = k_new[:, 0].to(kt.dtype)
                vt[:, tail_len] = v_new[:, 0].to(vt.dtype)
                if seq_sharded:
                    # (B, Hq, Dh) of partials cross the ranks, not the cache
                    a = lse_decode_attention(
                        q, cache["k"][slot].to(q.dtype), cache["v"][slot].to(q.dtype),
                        cache["kpos"][slot], pos, scale=scale, window=cfg.attn_window,
                        tail=(kt, vt, tail["kpos"][slot]))[:, 0]
                else:
                    k_full = torch.cat([cache["k"][slot], kt], dim=1).to(q.dtype)
                    v_full = torch.cat([cache["v"][slot], vt], dim=1).to(q.dtype)
                    a = flash_decode(q[:, 0].contiguous(), k_full, v_full, kp, pos,
                                     scale=scale, window=cfg.attn_window)
                a = a.reshape(*h.shape[:2], cfg.num_heads * cfg.head_dim)
                a = a @ p["attn"]["wo"].to(h.dtype)
            x = x + a
            h = apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
            f, _ = tfm._ffn(cfg, p, h, self.moe_dropless, self.moe_groups,
                            want_aux=False)
            x = x + f
        return x, tail

    def init_tail(self, batch: int, window: int, dtype=None) -> dict:
        """The small append buffer of ``decode_step_append``: a cache of
        ``window`` slots, every kpos -1."""
        return init_cache(self.cfg, batch, window, dtype or self.compute_dtype,
                          self.device)

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None):
        return init_cache(self.cfg, batch, max_len, dtype or self.compute_dtype,
                          self.device)


class _MetaGenerator(torch.Generator):
    """A generator that reports the meta device: ``init`` then draws shapes
    only."""

    @property
    def device(self):
        return torch.device("meta")


REMAT_POLICIES = ("none", "full", "nothing", "dots")
# the weight products "dots" saves; everything else, the batched attention
# products (aten.bmm) among it, is recomputed in the backward pass
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` rematerialised in the backward pass under ``policy``."""
    if policy == "none":
        return fn
    if policy == "dots":
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    return functools.partial(checkpoint, fn, use_reentrant=False)


def build_model(cfg: ModelConfig, *, param_dtype=torch.float32,
                compute_dtype=torch.float32, device="cuda", remat_policy: str = "none",
                moe_groups: int = 0, moe_dropless: bool = True, backend: str = "auto") -> Model:
    """The reference's ``build_model``: a ``Model`` of ``cfg`` (the port's
    holds no compiled state, so there is nothing to cache)."""
    return Model(cfg, param_dtype=param_dtype, compute_dtype=compute_dtype,
                 device=device, remat_policy=remat_policy, moe_groups=moe_groups,
                 moe_dropless=moe_dropless, backend=backend)


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


# float leaves the reference keeps in f32 whatever the parameter dtype
F32_LEAVES = ("lam", "decay_base", "bonus_u", "mix_base", "cm_mix_k", "cm_mix_r",
              "router")


def params_from_jax(tree: dict, *, dtype=torch.float32, device="cuda") -> dict:
    """The reference ``Model.init`` pytree (as numpy arrays: ``prefix_layers``
    list + stacked ``scan_layers``; a hybrid has every layer in
    ``prefix_layers``, DeepSeek its first dense layer) -> the port's
    parameter dict."""
    dev = resolve_device(device)

    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        return _tensor(node, torch.float32 if key in F32_LEAVES else dtype, dev)

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
