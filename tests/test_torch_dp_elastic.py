"""Robust training across world sizes: two gloo ranks (``RANK_ENV``,
``parallel.launch.run_world``) and one process, on the CPU.

32 px, 200 classes, f32, float32 input, spmd mode with
``--zero-opt-state``, SGD with momentum (ZeRO shards its momentum), a
global batch of 16 (8 rows a rank), three steps an epoch. The checkpoints
that cross world sizes are vit_s16's: no batchnorm and no dropout, so a
world of two computes what one process does up to the order of its sums
(a resnet18's batchnorm over 8 or 16 rows at these sizes turns that
order into loss gaps of 3e-5 to 4e-4 within three steps, the same in
either direction, which would hide what the reshard does); the
straggler and the preempt gate run resnet18.

- A checkpoint written by two ranks resumes in one process, and one
  written by one process resumes on two ranks, through the trainer: the
  ``resume`` record states both meshes (``data=2,model=1`` ↔
  ``data=1,model=1``), the ZeRO shard counts and the strategy, and the
  resumed epoch's losses are finite. Then the restored state's three
  spmd steps on one fixed global batch (each rank its half) against the
  same-world resume's (the checkpoint restored in the world that wrote
  it): losses and gradient norms rtol 1e-5 — JAX's cross-mesh tolerance
  (``tests/test_elastic.py``). The one-process twins run at the ranks'
  thread count (``rank_threads``).
- A rank delayed 2.5 s a step (``MPT_FAULT_DELAY_STEP_MS``,
  ``MPT_FAULT_DELAY_PROCESS=1``) under ``--heartbeat-every-steps 1`` and
  ``--preempt-straggler-beats 2`` (``--straggler-threshold 1.2``): the
  heartbeats flag rank 1, the
  watchdog's ``fault`` record says ``straggler_streak``, and both ranks
  stop at the same epoch boundary with one checkpoint, whose sidecar says
  ``data=2`` and ``zero_shards`` 2.
- ``MPT_FAULT_PREEMPT_AT_STEP=2`` on two ranks stops at the epoch
  boundary, not mid-epoch: epoch 0 runs whole and no dirty file appears.

Every record of the kinds this slice writes passes the JAX package's
``validate_record``; the spmd step's own ``grad_sync`` record (the
traffic ledger's, a port-only kind) is not among them.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.obs.schema import validate_record
from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import Config
from mpi_pytorch_tpu_torch.parallel import distributed
from mpi_pytorch_tpu_torch.parallel.launch import run_world
from mpi_pytorch_tpu_torch.parallel.mesh import create_mesh, zero_shard_axis
from mpi_pytorch_tpu_torch.train import elastic, trainer
from mpi_pytorch_tpu_torch.train.state import sync_state
from mpi_pytorch_tpu_torch.train.step import make_spmd_train_step
from mpi_pytorch_tpu_torch.utils import env
from test_torch_dp_step import RANK_ENV, rank_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(REPO, "tests")
WORLD, BATCH, STEPS = 2, 16, 3
VIT = {"model_name": "vit_s16"}


def _cfg(tmp: str, **kw) -> Config:
    base = dict(
        debug=True, debug_sample_size=60, num_classes=200, width=32, height=32,
        batch_size=BATCH, num_epochs=1, compute_dtype="float32", input_dtype="float32",
        optimizer="sgd", spmd_mode=True, zero_opt_state=True,
        loader_workers=2, log_every_steps=0, validate=False, resume_backoff_s=0.0,
        test_csv=os.path.join(REPO, "data", "test_sample.csv"),
        checkpoint_dir=os.path.join(tmp, "ckpt"), log_file=os.path.join(tmp, "training.log"),
        metrics_file=os.path.join(tmp, "metrics.jsonl"),
    )
    base.update(kw)
    return Config(**base)


def _records(cfg):
    with open(cfg.metrics_file) as f:
        return [json.loads(line) for line in f if line.strip()]


SLICE_KINDS = ("resume", "fault", "anomaly", "rollback", "step", "heartbeat", "epoch")


def _slice_records_valid(cfg) -> None:
    records = [r for r in _records(cfg) if r["kind"] in SLICE_KINDS]
    assert records and [p for r in records for p in validate_record(r)] == []


def _fixed_batch():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 200, BATCH).astype(np.int32))


def _steps_after_restore(ckpt_dir: str, tmp: str) -> dict:
    """The trainer's resume of ``ckpt_dir`` at the state level (restore,
    placement, sync), then three spmd steps on this rank's part of the
    fixed global batch: losses, gradient norms, the resume record."""
    cfg = _cfg(tmp, **VIT)
    mesh = create_mesh(cfg.mesh)
    state, _ = trainer.build_training(cfg, torch.device("cpu"), mesh)

    class Records(list):
        write = list.append

    records = Records()
    payload, _, _, _ = elastic.restore_latest(ckpt_dir, state, mesh, metrics=records,
                                              zero_shards_to=zero_shard_axis(mesh)[1])
    elastic.checked_place(state, payload)
    sync_state(state)
    step = make_spmd_train_step(torch.float32, zero_opt_state=True, mesh=mesh)
    images, labels = _fixed_batch()
    n = BATCH // distributed.world_size()
    rows = slice(distributed.rank() * n, (distributed.rank() + 1) * n)
    losses, norms = [], []
    for _ in range(STEPS):
        m = step(state, torch.from_numpy(images[rows]), torch.from_numpy(labels[rows]))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms, "resume": records[-1]}


def elastic_worker(payload: dict) -> dict:
    """One rank: write the two-rank checkpoint, resume the one-process one
    through the trainer, the state-level resumes of both, then the
    straggler and the preempt-gate runs."""
    torch.backends.cudnn.allow_tf32 = False
    distributed.maybe_initialize_distributed(torch.device("cpu"))
    root, out = payload["root"], {}
    two = _cfg(os.path.join(root, "two"), **VIT)
    trainer.train(two, device="cpu")
    one_on_two = _cfg(os.path.join(root, "one_on_two"), num_epochs=2, from_checkpoint=True,
                      **VIT)
    out["one_on_two"] = trainer.train(one_on_two, device="cpu").step_losses
    out["two_same"] = _steps_after_restore(two.checkpoint_dir, os.path.join(root, "s2"))
    out["one_cross"] = _steps_after_restore(os.path.join(root, "one", "ckpt"),
                                            os.path.join(root, "s3"))
    # Rank 1 is flagged while t + d > τ·(t + d/2), the median of two being
    # their mean: at d = 2.5 s and τ = 1.2, while a step takes t < 5 s (at
    # the default τ = 1.5, t < 1.25 s, which a loaded box's 1.3 s steps
    # missed).
    gates = {"MPT_FAULT_DELAY_STEP_MS": "2500", "MPT_FAULT_DELAY_PROCESS": "1"}
    os.environ.update(gates)
    env.reset_fault_counters()
    straggler = trainer.train(_cfg(os.path.join(root, "straggler"), num_epochs=3,
                                   heartbeat_every_steps=1, step_metrics=True,
                                   straggler_threshold=1.2, preempt_straggler_beats=2),
                              device="cpu")
    for name in gates:
        del os.environ[name]
    out["straggler"] = (straggler.preempted, straggler.epochs_run)
    os.environ["MPT_FAULT_PREEMPT_AT_STEP"] = "2"
    env.reset_fault_counters()
    cut = trainer.train(_cfg(os.path.join(root, "cut"), num_epochs=3), device="cpu")
    del os.environ["MPT_FAULT_PREEMPT_AT_STEP"]
    out["cut"] = (cut.preempted, cut.epochs_run, len(cut.step_losses))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_elastic"))
    one = _cfg(os.path.join(root, "one"), **VIT)
    with rank_threads():
        trainer.train(one, device="cpu")
    shutil.copytree(os.path.join(root, "one"), os.path.join(root, "one_on_two"))
    ranks = run_world("test_torch_dp_elastic:elastic_worker", WORLD, {"root": root},
                      timeout_s=150, env=RANK_ENV, pythonpath=[HERE])
    shutil.copytree(os.path.join(root, "two"), os.path.join(root, "two_on_one"))
    with rank_threads():
        two_on_one = trainer.train(_cfg(os.path.join(root, "two_on_one"), num_epochs=2,
                                        from_checkpoint=True, **VIT), device="cpu")
        two_cross = _steps_after_restore(os.path.join(root, "two", "ckpt"),
                                         os.path.join(root, "s0"))
        one_same = _steps_after_restore(os.path.join(root, "one", "ckpt"),
                                        os.path.join(root, "s1"))
    yield {"root": root, "ranks": ranks, "two_on_one": two_on_one.step_losses,
           "two_cross": two_cross, "one_same": one_same}
    shutil.rmtree(root, ignore_errors=True)


def _resume_record(cfg):
    return [r for r in _records(cfg) if r["kind"] == "resume"]


def test_two_rank_checkpoint_resumes_in_one_process(world):
    cfg = _cfg(os.path.join(world["root"], "two_on_one"))
    manifest = ckpt.read_manifest(ckpt.checkpoint_paths(cfg.checkpoint_dir)[0])
    assert manifest["mesh_shape"] == {"data": 2, "model": 1} and manifest["zero_shards"] == 2
    (rec,) = _resume_record(cfg)
    assert (rec["from_mesh"], rec["to_mesh"], rec["from_devices"], rec["to_devices"]) == (
        "data=2,model=1", "data=1,model=1", 2, 1)
    # vit_s16's largest moment (an MLP's 1536 × 384) is under the 4 MiB bound.
    assert (rec["zero_shards_from"], rec["zero_shards_to"], rec["strategy"]) == (
        2, 1, "host-reshard")
    # The cursor names the rank count it was written for: a clean epoch
    # boundary continues at step 0 either way.
    assert (rec["epoch"], rec["cursor_epoch"], rec["cursor_step"]) == (0, 1, 0)
    assert len(world["two_on_one"]) == STEPS and np.isfinite(world["two_on_one"]).all()
    same, cross = world["ranks"][0]["two_same"], world["two_cross"]
    assert cross["resume"]["strategy"] == "host-reshard"
    np.testing.assert_allclose(cross["losses"], same["losses"], rtol=1e-5)
    np.testing.assert_allclose(cross["norms"], same["norms"], rtol=1e-5)
    _slice_records_valid(cfg)


def test_one_process_checkpoint_resumes_on_two_ranks(world):
    ranks = world["ranks"]
    cfg = _cfg(os.path.join(world["root"], "one_on_two"))
    (rec,) = _resume_record(cfg)
    assert (rec["from_mesh"], rec["to_mesh"], rec["zero_shards_from"],
            rec["zero_shards_to"]) == ("data=1,model=1", "data=2,model=1", 1, 2)
    assert ranks[0]["one_on_two"] == ranks[1]["one_on_two"]
    assert len(ranks[0]["one_on_two"]) == STEPS and np.isfinite(ranks[0]["one_on_two"]).all()
    same, cross = world["one_same"], ranks[0]["one_cross"]
    assert cross["resume"]["to_mesh"] == "data=2,model=1"
    assert ranks[1]["one_cross"]["losses"] == cross["losses"]
    np.testing.assert_allclose(cross["losses"], same["losses"], rtol=1e-5)
    np.testing.assert_allclose(cross["norms"], same["norms"], rtol=1e-5)
    _slice_records_valid(cfg)


def test_straggler_stops_both_ranks_at_one_epoch_boundary(world):
    assert [r["straggler"] for r in world["ranks"]] == [(True, 1), (True, 1)]
    cfg = _cfg(os.path.join(world["root"], "straggler"))
    records = _records(cfg)
    beats = [r for r in records if r["kind"] == "heartbeat"]
    assert len(beats) == STEPS and all(b["stragglers"] == [1] for b in beats)
    faults = [r for r in records if r["kind"] == "fault"]
    assert [(f["reason"], f["streak"], f["epoch"]) for f in faults] == [
        ("straggler_streak", 2, 0)]
    paths = ckpt.checkpoint_paths(cfg.checkpoint_dir)
    assert [ckpt.checkpoint_epoch(p) for p in paths] == [0]
    assert not os.path.exists(paths[0] + ".dirty")
    manifest = ckpt.read_manifest(paths[0])
    assert manifest["mesh_shape"]["data"] == 2 and manifest["zero_shards"] == 2
    _slice_records_valid(cfg)


def test_preempt_gate_on_two_ranks_waits_for_the_epoch_boundary(world):
    assert [r["cut"] for r in world["ranks"]] == [(True, 1, STEPS)] * WORLD
    cfg = _cfg(os.path.join(world["root"], "cut"))
    records = _records(cfg)
    assert [(r["epoch"], r["step"]) for r in records if r["kind"] == "step"] == [
        (0, s) for s in range(STEPS)]
    faults = [r for r in records if r["kind"] == "fault"]
    assert [(f["reason"], f["epoch"], f["step"]) for f in faults] == [
        ("injected_preempt", 0, 2)]
    paths = ckpt.checkpoint_paths(cfg.checkpoint_dir)
    assert [ckpt.checkpoint_epoch(p) for p in paths] == [0]
    assert not os.path.exists(paths[0] + ".dirty")
    assert ckpt.read_manifest(paths[0])["data_cursor"]["step_in_epoch"] == 0
