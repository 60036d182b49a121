"""The port's training CLI on the CPU: ``python -m
repro_torch.launch.train`` end to end with an injected host failure and a
bit-exact resume, the synthetic data pipeline, checkpoints and the restart
supervisor, each checked as the reference's ``tests/test_training.py``
checks its own (loss falls by more than 0.3 in 25 steps at its setting;
keep/gc; a ``tmp_`` directory is invisible; the supervisor restarts from
the manifest), plus what the port adds: a resumed run ends with parameters
equal (``torch.equal``) to an uninterrupted run's, and ``save_async``
writes the values the tree held when it was called.  The data's values come
from a torch generator, not ``jax.random``, so they are not compared with
the reference's; their distributions are checked instead.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.fault_tolerance import (FailureDetector,  # noqa: E402
                                                     HostFailure, StragglerMonitor,
                                                     TrainingSupervisor)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import _leaves  # noqa: E402
from repro_torch.training import (AdamWConfig, CheckpointManager,  # noqa: E402
                                  DataConfig, batch_at, embedding_batch_at,
                                  init_opt_state, make_eval_step, make_train_step)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    machine's cores, and small CPU ops slow down many times over when each
    process's thread pool spans them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_setup():
    cfg = get_config("qwen1.5-0.5b").reduced()
    m = build_model(cfg, remat_policy="dots", device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    step = make_train_step(m, AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=50))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    return m, params, init_opt_state(params), dc, step


def test_loss_decreases():
    """The reference test's setting: 25 steps, peak lr 3e-3, warmup 5."""
    m, params, state, dc, step = _small_setup()
    losses = []
    for s in range(25):
        params, state, metrics = step(params, state, batch_at(dc, s))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::6]
    ev = make_eval_step(m)(params, batch_at(dc, 99))
    assert np.isfinite(float(ev["loss"])) and float(ev["aux"]) == 0.0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_data_pipeline_determinism_and_sharding():
    dc1 = DataConfig(vocab_size=100, seq_len=16, global_batch=8, num_hosts=2, host_id=0)
    dc2 = DataConfig(vocab_size=100, seq_len=16, global_batch=8, num_hosts=2, host_id=1)
    a, b, c = batch_at(dc1, 7)["tokens"], batch_at(dc1, 7)["tokens"], batch_at(dc2, 7)["tokens"]
    assert torch.equal(a, b)                                      # deterministic
    assert not torch.equal(a, c)                                  # host-sharded
    assert not torch.equal(a, batch_at(dc1, 8)["tokens"])          # a batch a step
    assert a.shape == (4, 17) and a.dtype == torch.int32          # local batch
    with pytest.raises(ValueError):
        DataConfig(vocab_size=100, seq_len=16, global_batch=8, num_hosts=3).local_batch


def test_data_distribution_is_the_references():
    """About 70% of rows are arithmetic sequences mod V, the rest uniform."""
    dc = DataConfig(vocab_size=1000, seq_len=12, global_batch=256)
    t = torch.cat([batch_at(dc, s)["tokens"] for s in range(8)]).long()
    assert int(t.min()) >= 0 and int(t.max()) < 1000
    arithmetic = ((t[:, 1:] - t[:, :-1]) % 1000 == 1).all(dim=1).float().mean()
    assert 0.65 < float(arithmetic) < 0.75


def test_embedding_batches():
    dc = DataConfig(vocab_size=50, seq_len=6, global_batch=4)
    e1, e2 = embedding_batch_at(dc, 3, 16), embedding_batch_at(dc, 3, 16)
    assert e1["embeddings"].shape == (4, 6, 16) and e1["labels"].shape == (4, 6)
    assert torch.equal(e1["embeddings"], e2["embeddings"])
    assert torch.equal(e1["labels"], e2["labels"])
    assert 0.05 < float(e1["embeddings"].std()) < 0.2


# ---------------------------------------------------------------------------
# checkpoints and the supervisor
# ---------------------------------------------------------------------------


def test_checkpoint_atomic_keep_and_shape_check(tmp_path):
    m, params, state, dc, step = _small_setup()
    ck = CheckpointManager(str(tmp_path), keep=2)
    for s in (0, 1, 2, 3):
        ck.save(s, {"p": params, "o": state})
    assert ck.steps() == [2, 3]                                   # keep=2 gc
    os.makedirs(tmp_path / "tmp_step_9")                          # a crashed save
    assert ck.latest_step() == 3
    with open(tmp_path / "step_3" / "manifest.json") as f:
        assert json.load(f) == {"step": 3, "n_leaves": 3 * len(list(_leaves(params))) + 1,
                                "complete": True}
    st, tree = ck.restore({"p": params, "o": state})
    assert st == 3 and int(tree["o"].step) == 0
    assert all(torch.equal(a, b) for a, b in zip(_leaves(tree["p"]), _leaves(params)))
    assert type(tree["o"]) is type(state)
    wrong = dict(params, final_norm={"scale": torch.ones(7)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"p": wrong, "o": state})


def test_save_async_writes_the_values_at_the_call(tmp_path):
    """The leaves are copied to the host inside ``save_async``: updating the
    tensors in place afterwards does not reach the checkpoint."""
    params = {"w": torch.arange(6, dtype=torch.float32)}
    ck = CheckpointManager(str(tmp_path))
    ck.save_async(0, params)
    params["w"].add_(100.0)
    ck.wait()
    _, tree = ck.restore(params)
    assert torch.equal(tree["w"], torch.arange(6, dtype=torch.float32))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(params)


def test_supervisor_restarts_from_checkpoint(tmp_path):
    """Injected host failure -> restart resumes from the manifest."""
    m, params0, state0, dc, step = _small_setup()
    ck = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainingSupervisor(ck)
    trace = []

    def session(start):
        params, state = params0, state0
        first = 0
        if start is not None:
            first, tree = ck.restore({"p": params, "o": state})
            params, state = tree["p"], tree["o"]
            first += 1
        for s in range(first, 12):
            if s == 6 and sup.restarts == 0:
                raise HostFailure("boom")
            params, state, _ = step(params, state, batch_at(dc, s))
            trace.append(s)
            if s % 2 == 0:
                ck.save(s, {"p": params, "o": state})
        return 11

    assert sup.run(session) == 11
    assert sup.restarts == 1
    assert trace == list(range(6)) + list(range(5, 12))           # resumed after 4
    assert sup.max_restarts == 10


def test_failure_detector_and_straggler_monitor():
    t = [0.0]
    fd = FailureDetector(4, timeout=5.0, clock=lambda: t[0])
    t[0] = 3.0
    fd.beat(0)
    fd.beat(1)
    fd.beat(2)
    t[0] = 7.0
    assert fd.scan() == [3]
    assert sorted(fd.alive_hosts()) == [0, 1, 2]
    assert fd.scan() == []                                        # newly dead only

    sm = StragglerMonitor(straggler_factor=0.5)
    for _ in range(5):
        sm.report("io0", 100.0)
        sm.report("io1", 10.0)
    assert sm.stragglers() == ["io1"]


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------


def test_cli_restart_resumes_bit_exact(tmp_path, capsys):
    """24 steps, a checkpoint every 4, a host failure injected at step 10:
    the run resumes from step 8's manifest, reaches step 23, and its losses
    and final parameters equal an uninterrupted run's bit for bit."""
    kw = dict(reduced=True, steps=24, global_batch=8, seq_len=32, ckpt_every=4,
              peak_lr=3e-3, log_every=5, device="cpu")
    cut = train_cli.run("qwen1.5-0.5b", ckpt_dir=str(tmp_path / "cut"), fail_at_step=10,
                        **kw)
    out = capsys.readouterr().out
    whole = train_cli.run("qwen1.5-0.5b", ckpt_dir=str(tmp_path / "whole"), **kw)
    assert (cut.last_step, cut.restarts, cut.resumed_from) == (23, 1, [8])
    assert (whole.last_step, whole.restarts, whole.resumed_from) == (23, 0, [])
    assert "[inject] host failure at step 10" in out
    assert "[restore] resumed from step 8" in out
    assert "[done] trained to step 23 (restarts: 1)" in out
    assert sorted(cut.step_seconds) == list(range(9, 24))         # the finishing session
    assert cut.losses == whole.losses and len(whole.losses) == 24
    assert all(np.isfinite(v) for v in whole.losses.values())
    for a, b in zip(_leaves(cut.params), _leaves(whole.params)):
        assert torch.equal(a, b)
    assert CheckpointManager(str(tmp_path / "cut")).steps() == [16, 20, 23]


def test_cli_main_prints_the_references_lines(tmp_path, capsys):
    train_cli.main(["--reduced", "--steps", "3", "--seq-len", "8", "--global-batch", "2",
                    "--ckpt-dir", str(tmp_path), "--device", "cpu",
                    "--arch", "musicgen-large"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("step     0 loss=") and " lr=" in lines[0]
    assert " gnorm=" in lines[0] and lines[0].endswith("s)")
    assert lines[-1] == "[done] trained to step 2 (restarts: 0)"
    # a second call resumes from the last manifest and has nothing left to do
    train_cli.main(["--reduced", "--steps", "3", "--seq-len", "8", "--global-batch", "2",
                    "--ckpt-dir", str(tmp_path), "--device", "cpu",
                    "--arch", "musicgen-large"])
    assert "[restore] resumed from step 2" in capsys.readouterr().out


def test_cli_refusals(tmp_path):
    with pytest.raises(ValueError, match="checkpoint directory"):
        train_cli.run("qwen1.5-0.5b", reduced=True, steps=2, fail_at_step=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.run("qwen1.5-0.5b", reduced=True, steps=2, ckpt_dir=str(tmp_path))


def test_cli_trains_an_rwkv_model_on_the_cpu():
    """The CPU's plain wkv6 carries the gradient: rwkv6-7b trains there."""
    res = train_cli.run("rwkv6-7b", reduced=True, steps=3, global_batch=2, seq_len=8,
                        device="cpu")
    assert res.last_step == 2 and all(np.isfinite(v) for v in res.losses.values())
