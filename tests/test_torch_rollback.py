"""``--bad-step-policy rollback`` in the port's trainer against the JAX
trainer's, one process, f32, resnet18 at 32 px (48 train rows, batches of
16: three steps an epoch, three epochs), float32 input (a NaN needs it).

- ``MPT_FAULT_NONFINITE_AT_STEP=5`` poisons epoch 1's second batch; the
  default policy (two non-finite steps in a row) rolls back at epoch 1
  step 2 to epoch 0's checkpoint and replays epoch 1. The ``fault`` →
  ``rollback`` record sequence equals the JAX trainer's on the same
  configuration, field for field in epoch, step, reason, ``rollbacks`` and
  ``lr_scale``; the final parameters, statistics and moments equal the
  port's unpoisoned run's bit for bit (the replayed batches are clean).
- ``rollback_lr_backoff`` scales every rate the schedule gives after the
  rollback (a cosine schedule, checked step by step).
- A rollback with no checkpoint, or past ``max_rollbacks``, raises
  ``RollbackLimitError``.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from mpi_pytorch_tpu import config as jax_config
from mpi_pytorch_tpu.obs.schema import validate_jsonl
from mpi_pytorch_tpu.utils import env as jax_env
from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import Config
from mpi_pytorch_tpu_torch.train import elastic, trainer
from mpi_pytorch_tpu_torch.train.state import TrainState, make_schedule
from mpi_pytorch_tpu_torch.utils import env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV = {"train_csv": os.path.join(REPO, "data", "train_sample.csv"),
       "test_csv": os.path.join(REPO, "data", "test_sample.csv")}
STEPS, EPOCHS = 3, 3
KEYS = ("kind", "epoch", "step", "reason", "rollbacks", "lr_scale")


def _fields(tmp, **kw) -> dict:
    base = dict(
        debug=True, debug_sample_size=60, num_classes=200, width=32, height=32,
        batch_size=16, num_epochs=EPOCHS, compute_dtype="float32", input_dtype="float32",
        fused_stem=True, loader_workers=2, log_every_steps=0, validate=False,
        resume_backoff_s=0.0, bad_step_policy="rollback",
        checkpoint_dir=os.path.join(tmp, "ckpt"), log_file=os.path.join(tmp, "training.log"),
        metrics_file=os.path.join(tmp, "metrics.jsonl"), **CSV,
    )
    base.update(kw)
    return base


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _trail(records):
    return [{k: r[k] for k in KEYS if k in r} for r in records
            if r["kind"] in ("fault", "rollback")]


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, removed when it ends: the checkpoints here
    run to hundreds of MB, and the suite's workers share one disk."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def gates():
    env.reset_fault_counters()
    jax_env.reset_fault_counters()
    yield os.environ
    for name in env.FAULT_GATES:
        os.environ.pop(name, None)
    env.reset_fault_counters()
    jax_env.reset_fault_counters()


def test_rollback_trail_matches_jax_and_ends_on_the_clean_run(tmp_path, gates):
    clean = Config(**_fields(str(tmp_path / "clean"), bad_step_policy="abort"))
    trainer.train(clean, device="cpu")

    gates["MPT_FAULT_NONFINITE_AT_STEP"] = "5"
    cfg = Config(**_fields(str(tmp_path / "port")))
    summary = trainer.train(cfg, device="cpu")
    assert summary.epochs_run == EPOCHS  # epoch 1's first pass never completed
    records = _records(cfg.metrics_file)
    trail = _trail(records)
    assert trail == [
        {"kind": "fault", "epoch": 1, "reason": "injected_nonfinite"},
        {"kind": "rollback", "epoch": 1, "step": 2, "reason": "nonfinite_streak",
         "rollbacks": 1, "lr_scale": 1.0},
    ]
    rollback = [r for r in records if r["kind"] == "rollback"][0]
    assert rollback["restored_epoch"] == 0
    assert [r["epoch"] for r in records if r["kind"] == "resume"] == [0]
    losses = [r["loss"] for r in records if r["kind"] == "step"]
    # Epoch 1's first pass (its second and third steps non-finite), then
    # the replay: 9 + 3 step records.
    assert len(losses) == 12 and not np.isfinite(losses[4:6]).any()
    assert np.isfinite(losses[6:]).all()
    assert validate_jsonl(cfg.metrics_file) == []

    from mpi_pytorch_tpu.train.trainer import train as jax_train

    env.reset_fault_counters()
    jax_env.reset_fault_counters()
    jax_cfg = jax_config.Config(**_fields(str(tmp_path / "jax")))
    jax_cfg.validate_config()
    jax_train(jax_cfg)
    assert _trail(_records(jax_cfg.metrics_file)) == trail

    got = torch.load(ckpt.latest_checkpoint(cfg.checkpoint_dir), weights_only=True)
    want = torch.load(ckpt.latest_checkpoint(clean.checkpoint_dir), weights_only=True)
    assert got["step"] == want["step"] == STEPS * EPOCHS
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)


def test_lr_backoff_scales_the_scheduled_rate(tmp_path, gates, monkeypatch):
    seen = []
    real = TrainState.set_learning_rate

    def spy(self):
        real(self)
        seen.append((self.step, self.optimizer.param_groups[0]["lr"]))

    monkeypatch.setattr(TrainState, "set_learning_rate", spy)
    gates["MPT_FAULT_NONFINITE_AT_STEP"] = "5"
    cfg = Config(**_fields(str(tmp_path), rollback_nonfinite_steps=1, rollback_lr_backoff=0.5,
                           lr_schedule="cosine"))
    trainer.train(cfg, device="cpu")
    rollback = [r for r in _records(cfg.metrics_file) if r["kind"] == "rollback"]
    assert [(r["epoch"], r["step"], r["lr_scale"]) for r in rollback] == [(1, 1, 0.5)]
    assert "LR scaled to 0.5x" in open(cfg.log_file).read()
    schedule = make_schedule(cfg.learning_rate, "cosine", total_steps=STEPS * EPOCHS)
    # Steps 0..4 at the schedule's rate (the 5th poisoned), then the
    # replay from step 3 on at half of it.
    assert [s for s, _ in seen] == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7, 8]
    scales = [1.0] * 5 + [0.5] * 6
    for (step, lr), scale in zip(seen, scales):
        assert lr == pytest.approx(schedule(step) * scale, rel=1e-12), step


def test_rollback_without_a_checkpoint_raises(tmp_path, gates):
    gates["MPT_FAULT_NONFINITE_AT_STEP"] = "1"
    cfg = Config(**_fields(str(tmp_path), rollback_nonfinite_steps=1))
    with pytest.raises(elastic.RollbackLimitError, match="no checkpoint"):
        trainer.train(cfg, device="cpu")


def test_rollback_past_max_rollbacks_raises(tmp_path, gates, monkeypatch):
    # A drift verdict on every step of epoch 1: the first one rolls back,
    # the replay's first step asks again, past max_rollbacks=1.
    real = elastic.RollbackPolicy.observe
    calls = []

    def drifting(self, loss, grad_norm):
        calls.append(loss)
        return "loss_drift" if len(calls) > STEPS else real(self, loss, grad_norm)

    monkeypatch.setattr(elastic.RollbackPolicy, "observe", drifting)
    cfg = Config(**_fields(str(tmp_path), max_rollbacks=1))
    with pytest.raises(elastic.RollbackLimitError, match="max-rollbacks=1"):
        trainer.train(cfg, device="cpu")
    records = _records(cfg.metrics_file)
    assert [(r["kind"], r["reason"], r["epoch"], r["step"]) for r in records
            if r["kind"] in ("rollback", "anomaly")] == [
        ("rollback", "loss_drift", 1, 0), ("anomaly", "rollback_limit", 1, 0)]
    assert validate_jsonl(cfg.metrics_file) == []


def test_rollback_config_round_trips_the_cli():
    from mpi_pytorch_tpu_torch.config import parse_config

    argv = ["--bad-step-policy", "rollback", "--rollback-nonfinite-steps", "1",
            "--rollback-loss-drift", "2.5", "--rollback-drift-warmup", "4",
            "--max-rollbacks", "2", "--rollback-lr-backoff", "0.5",
            "--checkpoint-every-epochs", "2", "--ckpt-bf16-moments", "true",
            "--preempt-file", "/nonexistent/stop", "--heartbeat-every-steps", "3",
            "--preempt-straggler-beats", "2", "--straggler-threshold", "2.0",
            "--step-metrics", "true", "--preempt-nonfinite-steps", "2",
            "--nan-sentinel", "false", "--resume-retries", "1", "--resume-backoff-s", "0.1"]
    cfg = parse_config(argv)
    ref = jax_config.parse_config(argv)
    for f in dataclasses.fields(Config):
        if f.name in ("bad_step_policy", "rollback_nonfinite_steps", "rollback_loss_drift",
                      "rollback_drift_warmup", "max_rollbacks", "rollback_lr_backoff",
                      "checkpoint_every_epochs", "ckpt_bf16_moments", "preempt_file",
                      "heartbeat_every_steps", "preempt_straggler_beats",
                      "straggler_threshold", "step_metrics", "preempt_nonfinite_steps",
                      "nan_sentinel", "resume_retries", "resume_backoff_s"):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
