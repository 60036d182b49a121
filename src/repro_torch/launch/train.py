"""End-to-end training entry point (counterpart of ``repro.launch.train``).

On the card (the default ``--device cuda``; without a card it raises):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 100 --ckpt-dir build/train_ckpt
On the CPU, the reduced config as the reference's tests run it:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --reduced --steps 100 --device cpu

It exercises the deterministic sharded data, AdamW with its schedule, remat
(``"dots"``), checkpoints with restart — a run resumes from the newest
complete manifest in ``--ckpt-dir`` — and an injected host failure
(``--fail-at-step``) that the supervisor restarts from that manifest (the
newest save started before the failure: the injection lets it land).
Training runs in f32, as the reference's does; ``allow_tf32`` stays off.
Weights come from ``Model.init`` on a generator of the run's device seeded
0.  Every arch of the registry trains on the card: the scans' gradients
run in their own kernels (``rglru_scan`` over reversed time, ``wkv6``'s
backward kernel).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.distributed.fault_tolerance import HostFailure, TrainingSupervisor
from repro_torch.models import build_model, resolve_device
from repro_torch.training import (AdamWConfig, CheckpointManager, DataConfig,
                                  batch_at, embedding_batch_at, init_opt_state,
                                  make_train_step)


@dataclass
class TrainRun:
    """What ``run`` did: the last step, the restarts, each step's loss (a
    step run again after a restart keeps its last loss), the steps of the
    finishing session with each one's wall seconds (ended by a device
    synchronise), the steps it resumed from, the peak device memory (CUDA
    only) and the final parameters."""
    last_step: int
    restarts: int
    losses: dict = field(default_factory=dict)
    step_seconds: dict = field(default_factory=dict)
    resumed_from: list = field(default_factory=list)
    peak_bytes: Optional[int] = None
    params: Optional[dict] = None


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(arch: str, *, reduced: bool, steps: int, ckpt_dir: Optional[str] = None,
        global_batch: int = 8, seq_len: int = 64, ckpt_every: int = 20,
        fail_at_step: int = -1, peak_lr: float = 3e-3, log_every: int = 10,
        device="cuda") -> TrainRun:
    """Train ``arch`` for ``steps`` steps on ``device``, checkpointing into
    ``ckpt_dir`` every ``ckpt_every`` steps and at the last (no checkpoints
    without a directory, and then no injected failure either)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if fail_at_step >= 0 and ckpt_dir is None:
        raise ValueError("an injected failure needs a checkpoint directory to resume from")
    model = build_model(cfg, remat_policy="dots", device=dev)
    opt_cfg = AdamWConfig(peak_lr=peak_lr, warmup_steps=max(2, steps // 20),
                          total_steps=steps)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                    global_batch=global_batch)
    ckpt = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir is not None else None
    step_fn = make_train_step(model, opt_cfg)
    supervisor = TrainingSupervisor(ckpt)
    out = TrainRun(last_step=-1, restarts=0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def make_batch(s):
        if cfg.input_mode == "tokens":
            return batch_at(dc, s, dev)
        return embedding_batch_at(dc, s, cfg.d_model, dev)

    def session(start_step):
        params = model.init(torch.Generator(dev).manual_seed(0))
        opt_state = init_opt_state(params)
        first = 0
        if start_step is not None:
            first, restored = ckpt.restore({"params": params, "opt": opt_state})
            params, opt_state = restored["params"], restored["opt"]
            print(f"[restore] resumed from step {first}")
            out.resumed_from.append(first)
            first += 1
        out.step_seconds = {}
        t0 = time.perf_counter()
        for s in range(first, steps):
            if s == fail_at_step and supervisor.restarts == 0:
                print(f"[inject] host failure at step {s}")
                # the save in flight lands first, so the restart point does
                # not depend on how fast the writer thread was
                ckpt.wait()
                raise HostFailure(f"injected at step {s}")
            ts = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, make_batch(s))
            _sync(dev)
            out.step_seconds[s] = time.perf_counter() - ts
            out.losses[s] = float(metrics["loss"])
            if s % log_every == 0 or s == steps - 1:
                print(f"step {s:5d} loss={out.losses[s]:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.2f} "
                      f"({(time.perf_counter() - t0):.1f}s)")
            if ckpt is not None and (s % ckpt_every == 0 or s == steps - 1):
                ckpt.save_async(s, {"params": params, "opt": opt_state})
        if ckpt is not None:
            ckpt.wait()
        out.params = params
        return steps - 1

    out.last_step = supervisor.run(session) if ckpt is not None else session(None)
    out.restarts = supervisor.restarts
    if dev.type == "cuda":
        out.peak_bytes = torch.cuda.max_memory_allocated(dev)
    print(f"[done] trained to step {out.last_step} (restarts: {supervisor.restarts})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="build/train_ckpt",
                    help="checkpoints; a run resumes from the newest complete one")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--peak-lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    run(args.arch, reduced=args.reduced, steps=args.steps, ckpt_dir=args.ckpt_dir,
        global_batch=args.global_batch, seq_len=args.seq_len,
        fail_at_step=args.fail_at_step, peak_lr=args.peak_lr, device=args.device)


if __name__ == "__main__":
    main()
