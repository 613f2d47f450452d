"""The port's robust-training units against the JAX package's, on the
same inputs (``train/elastic.py``, ``obs/{health,heartbeat}.py``, the
cursor and the guard of ``train/trainer.py``, the gates of
``utils/env.py``, the A8 fields of ``config.py``). Every comparison is
exact: these are host-side decisions, not arithmetic.

- ``manifest_fingerprint``: equal strings on three manifests, one of them
  reordered.
- ``data_cursor`` and ``validate_cursor``: equal dicts, and the same
  verdict and reason on a table of cursors.
- ``topology_manifest`` on world 1, data 2 with ZeRO, 2 pods × 2 and
  1 × 2 model: equal but for ``process_count`` (the port's ranks are its
  processes; the JAX mesh here is one process's virtual devices), and the
  ZeRO layout as the multiset of ``[chunk, padded]`` (the key paths
  differ: a pytree path against ``state.{i}.{key}``).
- ``RollbackPolicy``, ``PreemptionWatchdog``, ``flag_stragglers``,
  ``Heartbeat``, ``StepHealth``, ``FaultInjector``, ``with_retries``,
  ``PreemptionGuard``: the same verdicts, records and delays.
- The gates, the config fields and their checks, and every record kind
  the slice writes against ``obs.schema.validate_record``.
"""

import dataclasses
import math
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mpi_pytorch_tpu import config as jax_config
from mpi_pytorch_tpu.data.manifest import manifest_fingerprint as jax_fingerprint
from mpi_pytorch_tpu.obs import health as jax_health
from mpi_pytorch_tpu.obs import heartbeat as jax_heartbeat
from mpi_pytorch_tpu.obs.schema import validate_record
from mpi_pytorch_tpu.parallel.mesh import create_mesh as jax_create_mesh
from mpi_pytorch_tpu.train import elastic as jax_elastic
from mpi_pytorch_tpu.train import trainer as jax_trainer
from mpi_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
from mpi_pytorch_tpu.utils import env as jax_env
from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import Config, MeshConfig
from mpi_pytorch_tpu_torch.data.manifest import Manifest, load_manifests, manifest_fingerprint
from mpi_pytorch_tpu_torch.obs import health, heartbeat
from mpi_pytorch_tpu_torch.parallel import distributed
from mpi_pytorch_tpu_torch.parallel.mesh import Axis, Mesh, create_mesh
from mpi_pytorch_tpu_torch.train import elastic, trainer
from mpi_pytorch_tpu_torch.train.state import make_optimizer
from mpi_pytorch_tpu_torch.utils import env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV = {"train_csv": os.path.join(REPO, "data", "train_sample.csv"),
       "test_csv": os.path.join(REPO, "data", "test_sample.csv")}

A8_FIELDS = (
    "checkpoint_every_epochs", "ckpt_bf16_moments", "resume_retries", "resume_backoff_s",
    "preempt_file", "preempt_straggler_beats", "preempt_nonfinite_steps", "bad_step_policy",
    "max_skipped_steps", "rollback_nonfinite_steps", "rollback_loss_drift",
    "rollback_drift_warmup", "max_rollbacks", "rollback_lr_backoff", "step_metrics",
    "nan_sentinel", "heartbeat_every_steps", "straggler_threshold",
)


class FakeMetrics:
    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(dict(record))


@pytest.fixture
def clean_gates():
    for reset in (env.reset_fault_counters, jax_env.reset_fault_counters):
        reset()
    yield
    for name in jax_env.FAULT_GATES:
        os.environ.pop(name, None)
    for reset in (env.reset_fault_counters, jax_env.reset_fault_counters):
        reset()


def _valid(records):
    problems = [p for r in records for p in validate_record({"ts": 1.0, **r})]
    assert problems == []


# ---------------------------------------------------------------------------
# fingerprint and cursor
# ---------------------------------------------------------------------------


def test_manifest_fingerprint_matches_jax():
    train_m, test_m = load_manifests(Config(debug=True, debug_sample_size=200,
                                            num_classes=64500, **CSV))
    synthetic = Manifest(filenames=tuple(f"f{i}.jpg" for i in range(20)),
                         labels=(np.arange(20) % 7).astype(np.int32),
                         category_ids=np.arange(20), img_dir="unused")
    reordered = train_m.select(np.arange(len(train_m))[::-1])
    prints = [manifest_fingerprint(m) for m in (train_m, synthetic, reordered)]
    assert prints == [jax_fingerprint(m) for m in (train_m, synthetic, reordered)]
    assert len(set(prints)) == 3 and all(len(p) == 16 for p in prints)
    assert manifest_fingerprint(test_m) == jax_fingerprint(test_m)


def test_data_cursor_matches_jax():
    for kw in ({}, {"seed": 3, "batch_size": 64, "shuffle": False, "drop_remainder": False}):
        got = trainer.data_cursor(Config(**kw), "ab" * 8, 10, 3, 4)
        want = jax_trainer.data_cursor(jax_config.Config(**kw), "ab" * 8, 10, 3, 4)
        assert got == want


def test_validate_cursor_matches_jax():
    fp = "0123456789abcdef"
    good = trainer.data_cursor(Config(), fp, 10, 3, 4)
    cursors = [good, None, "not a dict"]
    for key, bad in (("epoch", 2), ("seed", 1), ("shuffle", False), ("global_batch", 64),
                     ("drop_remainder", False), ("processes", 2), ("steps_per_epoch", 9),
                     ("manifest_fingerprint", "0" * 16), ("step_in_epoch", 10),
                     ("step_in_epoch", -1)):
        cursors.append({**good, key: bad})
    cases = [(c, {}) for c in cursors]
    cases += [(good, {"scan_epoch": True, "device_cache": True}),
              ({**good, "step_in_epoch": 0}, {"scan_epoch": True, "device_cache": True})]
    verdicts = []
    for cursor, kw in cases:
        args = dict(fingerprint=fp, n_steps=10, start_epoch=3)
        got = trainer.validate_cursor(cursor, cfg=Config(**kw), **args)
        want = jax_trainer.validate_cursor(cursor, cfg=jax_config.Config(**kw), **args)
        assert got == want, (cursor, kw)
        verdicts.append(got)
    assert verdicts[0] == (4, None) and verdicts[-1] == (0, None)
    assert all(step == 0 and why for step, why in verdicts[1:-1])


# ---------------------------------------------------------------------------
# topology manifest
# ---------------------------------------------------------------------------


class _MLP(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        x = x.reshape(x.shape[0], -1)
        x = fnn.relu(fnn.Dense(13, name="body")(x))  # 13: uneven → ZeRO padding
        return fnn.Dense(8, name="head")(x)


def _jax_template():
    variables = _MLP().init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    return jax.eval_shape(jax_make_optimizer(1e-2).init, variables["params"])


def _port_optimizer(axis):
    model = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(192, 13), torch.nn.ReLU(),
                                torch.nn.Linear(13, 8))
    return make_optimizer(model, 1e-2, zero_axis=axis)[0]


def _specs(layout):
    return sorted(tuple(v) for v in layout.values() if v is not None)


@pytest.mark.parametrize("name,mesh_kw,port_mesh,zero", [
    ("world1", {}, Mesh((Axis("data", 1, 0),)), False),
    ("data2_zero", {}, Mesh((Axis("data", 2, 0),)), True),
    ("pods2x2", {"pods": 2}, Mesh((Axis("pod", 2, 0), Axis("ici", 2, 0))), True),
    ("data1_model2", {"model_parallel": 2}, Mesh((Axis("data", 1, 0),), Axis("model", 2, 0)),
     False),
])
def test_topology_manifest_matches_jax(monkeypatch, name, mesh_kw, port_mesh, zero):
    n = math.prod(a.size for a in (*port_mesh.axes, port_mesh.model))
    monkeypatch.setattr(distributed, "world_size", lambda: n)
    jax_mesh = jax_create_mesh(jax_config.MeshConfig(**mesh_kw), devices=jax.devices()[:n])
    want = jax_elastic.topology_manifest(jax_mesh, zero_opt_state=zero, spmd_mode=zero,
                                         opt_template=_jax_template() if zero else None)
    opt = _port_optimizer(elastic.zero_shard_axis(port_mesh)[0]) if zero else None
    got = elastic.topology_manifest(port_mesh, zero_opt_state=zero, spmd_mode=zero,
                                    optimizer=opt)
    assert set(got) == set(want)
    assert got["process_count"] == n and want["process_count"] == 1
    for key in set(want) - {"process_count", "zero_shard_layout"}:
        assert got[key] == want[key], key
    if zero:
        assert _specs(got["zero_shard_layout"]) == _specs(want["zero_shard_layout"])
        assert got["zero_shards"] == 2


def test_mesh_topology_of_a_created_mesh():
    got = elastic.mesh_topology(create_mesh(MeshConfig()))
    want = jax_elastic.mesh_topology(jax_create_mesh(jax_config.MeshConfig(),
                                                     devices=jax.devices()[:1]))
    assert got == want
    assert elastic.describe_topology(got) == jax_elastic.describe_topology(want)
    assert elastic.describe_topology(None) == jax_elastic.describe_topology(None)


# ---------------------------------------------------------------------------
# policies, watchdog, heartbeat, health
# ---------------------------------------------------------------------------


def test_rollback_policy_matches_jax():
    rng = np.random.default_rng(0)
    stream = [(float(v), float(g)) for v, g in rng.uniform(1, 2, size=(40, 2))]
    stream[7] = (float("nan"), 1.0)
    stream[12] = (1.5, float("inf"))
    stream[13] = (float("inf"), 1.0)
    stream[20] = (9.0, 1.0)  # drift
    stream[30] = (3.2, None)
    for kw in ({}, {"nonfinite_steps": 1, "loss_drift": 3.0, "drift_warmup": 3},
               {"nonfinite_steps": 3, "loss_drift": 1.5, "drift_warmup": 1}):
        ours, ref = elastic.RollbackPolicy(**kw), jax_elastic.RollbackPolicy(**kw)
        got, want = [], []
        for loss, norm in stream:
            got.append(ours.observe(loss, norm))
            want.append(ref.observe(loss, norm))
            if got[-1]:
                ours.after_rollback()
                ref.after_rollback()
        assert got == want and any(got), kw


class _Guard:
    triggered = False


class _Beat:
    straggler_streak = 0


class _Health:
    nonfinite_grad_streak = 0


class _Injector:
    preempt_fired = False
    preempt_at_step = 7


def test_watchdog_precedence_and_one_record_match_jax(tmp_path):
    sentinel = tmp_path / "preempt.now"
    # Each row arms the triggers from that reason on down: the first armed
    # one in the precedence order must fire, once, with one record.
    for armed in range(5, 0, -1):
        records = {}
        for mod in (elastic, jax_elastic):
            guard, beat, hl, inj = _Guard(), _Beat(), _Health(), _Injector()
            guard.triggered = armed >= 5
            if armed >= 4:
                sentinel.write_text("")
            inj.preempt_fired = armed >= 3
            beat.straggler_streak = 3 if armed >= 2 else 0
            hl.nonfinite_grad_streak = 2
            metrics = FakeMetrics()
            dog = mod.PreemptionWatchdog(guard, preempt_file=str(sentinel), straggler_beats=3,
                                         nonfinite_steps=2, heartbeat=beat, health=hl,
                                         metrics=metrics, injector=inj)
            assert dog.should_stop(epoch=1, step=4) and dog.should_stop()
            records[mod.__name__] = metrics.records
            if sentinel.exists():
                sentinel.unlink()
        ours, ref = records[elastic.__name__], records[jax_elastic.__name__]
        assert ours == ref and len(ours) == 1, armed
        _valid(ours)
    assert ours[0]["reason"] == "nonfinite_grads" and ours[0]["streak"] == 2
    quiet = elastic.PreemptionWatchdog(_Guard(), heartbeat=_Beat(), health=_Health())
    assert not quiet.should_stop(epoch=0, step=0)


def test_stragglers_and_streak_counters_match_jax():
    rows = ([100.0, 500.0], [100.0, 149.0], [100.0, 151.0, 100.0], [5.0], [0.0, 9.0],
            [float("nan"), 1.0])
    for row in rows:
        for thr in (1.5, 3.0):
            assert heartbeat.flag_stragglers(row, thr) == jax_heartbeat.flag_stragglers(row, thr)
    beats = [[[100.0], [500.0]], [[100.0], [500.0]], [[100.0], [100.0]], [[100.0], [400.0]]]
    out = {}
    for mod in (heartbeat, jax_heartbeat):
        metrics = FakeMetrics()
        seq = iter(beats)
        hb = mod.Heartbeat(metrics, every_steps=1, threshold=1.5, batch_images=64,
                           gather=lambda v: np.asarray(next(seq), np.float32))
        streaks = []
        for step in range(4):
            hb.on_step(0, step, 0.1)
            streaks.append(hb.straggler_streak)
        out[mod.__name__] = (streaks, metrics.records)
    assert out[heartbeat.__name__] == out[jax_heartbeat.__name__]
    assert out[heartbeat.__name__][0] == [1, 2, 0, 1]
    _valid(out[heartbeat.__name__][1])

    seqs = {}
    for mod in (health, jax_health):
        metrics = FakeMetrics()
        sh = mod.StepHealth(metrics, step_metrics=True, nan_sentinel=False)
        streak = []
        for norm in (float("inf"), float("inf"), 0.5, float("nan")):
            sh.on_step(0, len(streak), {"loss": 1.0, "grad_norm": norm})
            streak.append(sh.nonfinite_grad_streak)
        seqs[mod.__name__] = (streak, [{k: r[k] for k in ("kind", "epoch", "step", "loss")}
                                       for r in metrics.records])
        if mod is health:
            _valid(metrics.records)
            assert all(r["recompiles"] is None and r["hbm_bytes"] is None
                       for r in metrics.records)
    assert seqs[health.__name__] == seqs[jax_health.__name__]


def test_sentinel_record_and_error_match_jax():
    got = {}
    for mod in (health, jax_health):
        metrics = FakeMetrics()
        sh = mod.StepHealth(metrics, step_metrics=True)
        with pytest.raises(mod.NonFiniteLossError) as err:
            sh.on_step(2, 5, {"loss": float("nan"), "grad_norm": 1.0})
        anomaly = metrics.records[-1]
        got[mod.__name__] = (str(err.value), {k: v for k, v in anomaly.items() if k != "loss"})
        with pytest.raises(mod.NonFiniteLossError):
            mod.StepHealth(FakeMetrics()).check_epoch(3, float("inf"))
    assert got[health.__name__] == got[jax_health.__name__]
    assert trainer.NonFiniteLossError is health.NonFiniteLossError


# ---------------------------------------------------------------------------
# the guard, the retries, the injector, the gates
# ---------------------------------------------------------------------------


def test_preemption_guard_flag_and_restore():
    before = signal.getsignal(signal.SIGTERM)
    with trainer.PreemptionGuard() as guard:
        assert not guard.triggered
        signal.raise_signal(signal.SIGTERM)
        assert guard.triggered  # the first signal: the flag only
    assert signal.getsignal(signal.SIGTERM) is before


def test_preemption_guard_second_signal_escape_hatch():
    before = signal.getsignal(signal.SIGINT)
    with pytest.raises(KeyboardInterrupt):
        with trainer.PreemptionGuard() as guard:
            signal.raise_signal(signal.SIGINT)
            assert guard.triggered
            signal.raise_signal(signal.SIGINT)  # the second: the prior handler raises
            pytest.fail("a second SIGINT must re-raise through the prior handler")
    assert signal.getsignal(signal.SIGINT) is before


def test_with_retries_backoff_matches_jax(monkeypatch):
    delays = {}
    for mod in (elastic, jax_elastic):
        slept = delays.setdefault(mod.__name__, [])
        monkeypatch.setattr(mod.time, "sleep", slept.append)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 4:
                raise RuntimeError("wedged")
            return "ok"

        assert mod.with_retries(flaky, what="x", retries=3, backoff_s=0.25) == "ok"
        with pytest.raises(RuntimeError, match="wedged"):
            mod.with_retries(lambda: (_ for _ in ()).throw(RuntimeError("wedged")),
                             what="x", retries=2, backoff_s=0.5)
    assert delays[elastic.__name__] == delays[jax_elastic.__name__] == [0.25, 0.5, 1.0, 0.5, 1.0]


def test_wedge_and_device_put_gates_absorbed_within_retries(monkeypatch, clean_gates, tmp_path):
    monkeypatch.setattr(elastic.time, "sleep", lambda s: None)
    os.environ["MPT_FAULT_BACKEND_WEDGE_N"] = "2"
    mesh = elastic.with_retries(lambda: create_mesh(MeshConfig()), what="backend init",
                                retries=3, backoff_s=0.0)
    assert mesh.axes[0].size == 1
    os.environ["MPT_FAULT_BACKEND_WEDGE_N"] = "10"
    env.reset_fault_counters()
    with pytest.raises(RuntimeError, match="backend init wedged"):
        elastic.with_retries(lambda: create_mesh(MeshConfig()), what="backend init",
                             retries=2, backoff_s=0.0)

    model = torch.nn.Linear(4, 3)
    opt, schedule = make_optimizer(model, 1e-2)
    state = trainer.TrainState(model=model, optimizer=opt, schedule=schedule, step=5)
    ckpt.save_checkpoint(str(tmp_path), epoch=0, state=state, loss=1.0)
    fresh = torch.nn.Linear(4, 3)
    opt2, _ = make_optimizer(fresh, 1e-2)
    target = trainer.TrainState(model=fresh, optimizer=opt2, schedule=schedule)
    payload, _, _ = ckpt.load_checkpoint(ckpt.latest_checkpoint(str(tmp_path)), target)
    os.environ["MPT_FAULT_DEVICE_PUT_N"] = "2"
    elastic.with_retries(lambda: elastic.checked_place(target, payload), what="placement",
                         retries=2, backoff_s=0.0)
    assert target.step == 5 and torch.equal(fresh.weight, model.weight)
    os.environ["MPT_FAULT_DEVICE_PUT_N"] = "3"
    env.reset_fault_counters()
    with pytest.raises(RuntimeError, match="device_put failed"):
        elastic.with_retries(lambda: elastic.checked_place(target, payload), what="placement",
                             retries=2, backoff_s=0.0)


def test_fault_injector_matches_jax(monkeypatch, clean_gates):
    os.environ.update({"MPT_FAULT_KILL_AT_STEP": "3", "MPT_FAULT_PREEMPT_AT_STEP": "2",
                       "MPT_FAULT_NONFINITE_AT_STEP": "3"})
    out = {}
    for mod in (elastic, jax_elastic):
        killed = []
        monkeypatch.setattr(mod.os, "kill", lambda pid, sig, k=killed: k.append((pid, sig)))
        metrics = FakeMetrics()
        inj = mod.FaultInjector(metrics=metrics)
        assert inj.active
        fired = []
        for step in range(3):
            inj.after_step(1, step)
            fired.append((inj.preempt_fired, len(killed)))
        rng = np.random.default_rng(0)
        batches = [(rng.standard_normal((2, 4, 4, 3)).astype(np.float32), np.arange(2))
                   for _ in range(4)]
        poisoned = list(inj.poison_batches(iter(batches), epoch=0))
        nan_rows = [bool(np.isnan(im).all()) for im, _ in poisoned]
        out[mod.__name__] = (fired, killed, metrics.records, nan_rows)
    monkeypatch.undo()
    assert out[elastic.__name__] == out[jax_elastic.__name__]
    fired, killed, records, nan_rows = out[elastic.__name__]
    assert fired == [(False, 0), (True, 0), (True, 1)]
    assert killed == [(os.getpid(), signal.SIGKILL)]
    assert nan_rows == [False, False, True, False]
    assert [r["reason"] for r in records] == ["injected_kill", "injected_nonfinite"]
    _valid(records)


def test_fault_gates_are_jax_gates_with_jax_texts(clean_gates):
    assert set(env.FAULT_GATES) <= set(jax_env.FAULT_GATES)
    for name, text in env.FAULT_GATES.items():
        assert text == jax_env.FAULT_GATES[name], name
    for gate in ("MPT_FAULT_KILL_AT_STEP", "MPT_FAULT_DELAY_STEP_MS", "MPT_FAULT_DELAY_PROCESS",
                 "MPT_FAULT_DELAY_AFTER_STEP", "MPT_FAULT_DCN_DELAY_MS",
                 "MPT_FAULT_BACKEND_WEDGE_N", "MPT_FAULT_DEVICE_PUT_N",
                 "MPT_FAULT_NONFINITE_AT_STEP", "MPT_FAULT_PREEMPT_AT_STEP", "MPT_PREEMPT_FILE"):
        assert gate in env.FAULT_GATES
    os.environ["MPT_FAULT_DEVICE_PUT_N"] = "2"
    assert [env.fault_countdown("MPT_FAULT_DEVICE_PUT_N") for _ in range(3)] == [
        True, True, False]
    with pytest.raises(KeyError):
        env.fault_countdown("MPT_FAULT_TYPO")
    os.environ["MPT_FAULT_KILL_AT_STEP"] = "x"
    with pytest.raises(ValueError):
        env.env_int("MPT_FAULT_KILL_AT_STEP")


# ---------------------------------------------------------------------------
# config fields and checks
# ---------------------------------------------------------------------------


def test_a8_config_defaults_match_jax():
    port, ref = Config(), jax_config.Config()
    for name in A8_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    assert set(A8_FIELDS) <= {f.name for f in dataclasses.fields(Config)}


@pytest.mark.parametrize("bad", [
    {"resume_retries": -1}, {"resume_backoff_s": -0.1}, {"preempt_straggler_beats": -1},
    {"preempt_nonfinite_steps": -1}, {"preempt_straggler_beats": 2},
    {"preempt_nonfinite_steps": 2}, {"bad_step_policy": "retry"}, {"max_skipped_steps": 0},
    {"rollback_nonfinite_steps": 0}, {"rollback_loss_drift": 0.5},
    {"rollback_drift_warmup": 0}, {"max_rollbacks": 0}, {"rollback_lr_backoff": 0.0},
    {"rollback_lr_backoff": 1.5},
    {"bad_step_policy": "rollback", "device_cache": True, "scan_epoch": True},
    {"bad_step_policy": "rollback", "checkpoint_every_epochs": 0},
    {"heartbeat_every_steps": -1}, {"straggler_threshold": 1.0},
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_a8_config_checks_match_jax(bad):
    with pytest.raises(ValueError) as ours:
        Config(**bad).validate_config()
    with pytest.raises(ValueError) as ref:
        jax_config.Config(**bad).validate_config()
    assert str(ours.value) == str(ref.value)


def test_a8_config_accepts_what_jax_accepts():
    for kw in ({"preempt_straggler_beats": 2, "heartbeat_every_steps": 5,
                "preempt_nonfinite_steps": 2, "step_metrics": True},
               {"bad_step_policy": "rollback", "rollback_loss_drift": 2.0,
                "rollback_lr_backoff": 0.5},
               {"bad_step_policy": "skip", "max_skipped_steps": 3}):
        Config(**kw).validate_config()
        jax_config.Config(**kw).validate_config()


# ---------------------------------------------------------------------------
# the records of the resume side
# ---------------------------------------------------------------------------


def test_restore_latest_records_validate(tmp_path):
    model = torch.nn.Linear(4, 3)
    opt, schedule = make_optimizer(model, 1e-2)
    state = trainer.TrainState(model=model, optimizer=opt, schedule=schedule)
    mesh = create_mesh(MeshConfig())
    topo = elastic.topology_manifest(mesh)
    for epoch in (0, 1):
        ckpt.save_checkpoint(str(tmp_path), epoch=epoch, state=state, loss=1.0,
                             manifest=dict(topo, data_cursor={"epoch": epoch + 1,
                                                              "step_in_epoch": 0}))
    newest = ckpt.latest_checkpoint(str(tmp_path))
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    metrics = FakeMetrics()
    payload, epoch, _, info = elastic.restore_latest(str(tmp_path), state, mesh, metrics=metrics)
    assert epoch == 0 and info["corrupt_skipped"] == 1
    assert [r["kind"] for r in metrics.records] == ["anomaly", "resume"]
    assert metrics.records[0]["reason"] == "corrupt_checkpoint"
    resume = metrics.records[1]
    assert (resume["from_mesh"], resume["to_mesh"], resume["strategy"]) == (
        "data=1,model=1", "data=1,model=1", "replicate")
    assert (resume["cursor_epoch"], resume["cursor_step"]) == (1, 0)
    _valid(metrics.records)
