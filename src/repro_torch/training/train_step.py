"""Train-step factory: LM cross-entropy + AdamW, remat- and MoE-aux-aware
(counterpart of ``repro.training.train_step``).

Gradients come from ``torch.autograd`` through the model's plain functions
and, on the card, through the scan kernels' gradient Functions
(``rglru_scan``, whose backward is the same kernel over reversed time, and
``wkv6``, whose backward is a kernel of its own).  A parameter the loss does not reach makes ``torch.autograd.grad`` raise
rather than hand back no gradient.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.distributed.constraints import constrain
from repro_torch.models.model import Model, _leaves
from repro_torch.training.optimizer import AdamWConfig, OptState, adamw_update


def tree_like(tree, flat):
    """``flat`` (an iterable in ``_leaves`` order) shaped like ``tree``."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)
    return build(tree)


def lm_loss(model: Model, params, batch: dict):
    """Next-token cross entropy (the log-sum-exp over the vocabulary in f32)
    plus the MoE aux loss.  ``batch``: {"tokens": (B, S+1)} or, for an
    embedding-input model, {"embeddings": (B, S, D), "labels": (B, S)}."""
    if "tokens" in batch:
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
    else:
        inputs, labels = batch["embeddings"], batch["labels"]
    logits, aux = model.forward(params, inputs)
    # on a mesh: batch over the batch axes, sequence over "model", the
    # vocabulary whole (DTensor's gather along a sharded dim is not exact)
    logits = constrain(logits.float(), ("pod", "data"), "model", None)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(logits.device, torch.long)[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll + aux, {"nll": nll, "aux": aux}


def value_and_grad(loss_fn: Callable, model: Model, params, batch: dict):
    """((loss, extras), grads) with grads a tree shaped like ``params``.
    Marks every parameter as requiring a gradient."""
    leaves = list(_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, extras = loss_fn(model, params, batch)
        grads = torch.autograd.grad(loss, leaves)
    extras = {k: torch.as_tensor(v).detach() for k, v in extras.items()}
    return (loss.detach(), extras), tree_like(params, grads)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    loss_fn: Optional[Callable] = None, grad_accum: int = 1):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    updating params and the optimizer state in place.  ``grad_accum`` > 1
    splits the batch's leading axis into that many micro-batches and
    averages their f32 gradients, summed one after another as the
    reference's scan does."""
    loss_fn = loss_fn or lm_loss

    def train_step(params, opt_state: OptState, batch: dict):
        if grad_accum <= 1:
            (loss, extras), grads = value_and_grad(loss_fn, model, params, batch)
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in _leaves(params)]
            loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
            aux_sum = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(grad_accum):
                mb = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])[i]
                      for k, v in batch.items()}
                (loss, extras), g = value_and_grad(loss_fn, model, params, mb)
                acc = [a + b.float() for a, b in zip(acc, _leaves(g))]
                loss_sum = loss_sum + loss
                aux_sum = aux_sum + extras["aux"]
            grads = tree_like(params, [a / grad_accum for a in acc])
            loss = loss_sum / grad_accum
            extras = {"nll": loss - aux_sum / grad_accum, "aux": aux_sum / grad_accum}
        params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **extras, **om}

    return train_step


def make_eval_step(model: Model, loss_fn: Optional[Callable] = None):
    loss_fn = loss_fn or lm_loss

    @torch.no_grad()
    def eval_step(params, batch: dict):
        loss, extras = loss_fn(model, params, batch)
        return {"loss": loss, **extras}

    return eval_step
