"""Exact-step resume and the checkpoint's robust-training pieces, one
process, f32, resnet18 at the small size of ``tests/test_torch_trainer.py``
(32 px, 48 train rows, batches of 16: three steps an epoch, three epochs).

- A run preempted mid-epoch 1 by ``MPT_FAULT_PREEMPT_AT_STEP`` saves a
  dirty checkpoint whose sidecar holds the cursor; resumed, it ends with
  parameters, statistics, moments, step and generator BITWISE the
  uninterrupted run's, every (epoch, step) run once; with the trunk
  frozen, the resumed run's step losses match the JAX train step's on
  the same weights (``models/convert.py``), fed by the JAX trainer's own
  walk, at rtol 1e-4.
- A cursor that no longer describes the walk (the batch changed) falls
  back to replay with an ``anomaly`` ``cursor_mismatch`` record.
- A corrupt newest checkpoint falls back to the previous one; an
  all-corrupt directory raises.
- The sidecars and ``.dirty`` follow retention and clean overwrites.
- ``ckpt_bf16_moments`` round-trips as JAX's cast does.
- The async writer's snapshot is a copy: the saved parameters are the
  ones at save time though the next step ran before the write.
"""

import dataclasses
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from mpi_pytorch_tpu import checkpoint as jax_ckpt
from mpi_pytorch_tpu.obs.schema import validate_jsonl
from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import Config
from mpi_pytorch_tpu_torch.train import trainer
from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer
from mpi_pytorch_tpu_torch.utils import env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV = {"train_csv": os.path.join(REPO, "data", "train_sample.csv"),
       "test_csv": os.path.join(REPO, "data", "test_sample.csv")}
STEPS, EPOCHS = 3, 3


def _cfg(tmp, **kw) -> Config:
    base = dict(
        debug=True, debug_sample_size=60, num_classes=200, width=32, height=32,
        batch_size=16, num_epochs=EPOCHS, compute_dtype="float32", input_dtype="float32",
        fused_stem=True, loader_workers=2, log_every_steps=0, validate=False,
        step_metrics=True, resume_backoff_s=0.0,
        checkpoint_dir=os.path.join(tmp, "ckpt"), log_file=os.path.join(tmp, "training.log"),
        metrics_file=os.path.join(tmp, "metrics.jsonl"), **CSV,
    )
    base.update(kw)
    return Config(**base)


def _records(cfg):
    with open(cfg.metrics_file) as f:
        return [json.loads(line) for line in f if line.strip()]


def _pairs(records):
    return [(r["epoch"], r["step"]) for r in records if r["kind"] == "step"]


def _tensors(obj, prefix=""):
    """Every tensor of a payload, by path (parameters, statistics,
    moments, generator)."""
    if torch.is_tensor(obj):
        return {prefix: obj}
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(_tensors(v, f"{prefix}.{k}"))
        return out
    if isinstance(obj, list):
        out = {}
        for i, v in enumerate(obj):
            out.update(_tensors(v, f"{prefix}.{i}"))
        return out
    return {}


def _final(cfg):
    return torch.load(ckpt.latest_checkpoint(cfg.checkpoint_dir), weights_only=True)


@pytest.fixture
def gates():
    env.reset_fault_counters()
    yield os.environ
    for name in env.FAULT_GATES:
        os.environ.pop(name, None)
    env.reset_fault_counters()


@pytest.fixture
def tmp_path(tmp_path):
    """The test's directory, removed when it ends: the checkpoints here
    run to hundreds of MB, and the suite's workers share one disk."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted run, and a run preempted after its 4th step
    (epoch 1 step 0), both in directories the tests copy from."""
    root = str(tmp_path_factory.mktemp("resume"))
    ref_cfg = _cfg(os.path.join(root, "ref"))
    ref = trainer.train(ref_cfg, device="cpu")
    env.reset_fault_counters()
    os.environ["MPT_FAULT_PREEMPT_AT_STEP"] = "4"
    try:
        cut_cfg = _cfg(os.path.join(root, "cut"))
        cut = trainer.train(cut_cfg, device="cpu")
    finally:
        os.environ.pop("MPT_FAULT_PREEMPT_AT_STEP")
    yield {"ref": (ref_cfg, ref), "cut": (cut_cfg, cut)}
    shutil.rmtree(root, ignore_errors=True)


def _copy(cfg, tmp, **kw):
    shutil.copytree(os.path.dirname(cfg.checkpoint_dir), str(tmp), dirs_exist_ok=True)
    return _cfg(str(tmp), **kw)


def test_preempted_run_saves_a_dirty_checkpoint_with_its_cursor(runs):
    cfg, cut = runs["cut"]
    assert cut.preempted and cut.epochs_run == 1 and len(cut.step_losses) == STEPS + 1
    latest = ckpt.latest_checkpoint(cfg.checkpoint_dir)
    assert ckpt.checkpoint_epoch(latest) == 0 and os.path.exists(latest + ".dirty")
    cursor = ckpt.read_manifest(latest)["data_cursor"]
    assert (cursor["epoch"], cursor["step_in_epoch"]) == (1, 1)
    records = _records(cfg)
    fault = [r for r in records if r["kind"] == "fault"]
    assert [(r["reason"], r["epoch"], r["step"]) for r in fault] == [("injected_preempt", 1, 1)]
    assert torch.load(latest, weights_only=True)["step"] == STEPS + 1
    assert validate_jsonl(cfg.metrics_file) == []


def test_resume_is_bitwise_the_uninterrupted_run(runs, tmp_path):
    ref_cfg, ref = runs["ref"]
    cfg = _copy(runs["cut"][0], tmp_path, from_checkpoint=True)
    done = trainer.train(cfg, device="cpu")
    assert not done.preempted and done.epochs_run == 2
    assert "exact-step resume: continuing epoch 1 at step 1" in open(cfg.log_file).read()
    got, want = _final(cfg), _final(ref_cfg)
    assert got["step"] == want["step"] == STEPS * EPOCHS and got["epoch"] == want["epoch"]
    got_t, want_t = _tensors(got), _tensors(want)
    assert got_t.keys() == want_t.keys() and any(".exp_avg_sq" in k for k in got_t)
    assert any("running_var" in k for k in got_t) and ".generator" in got_t
    for k in want_t:
        assert torch.equal(got_t[k], want_t[k]), k
    # No step twice: every (epoch, step) once across both sessions, the
    # resumed losses those of the uninterrupted run.
    records = _records(cfg)
    pairs = _pairs(records)
    assert sorted(pairs) == [(e, s) for e in range(EPOCHS) for s in range(STEPS)]
    assert len(pairs) == len(set(pairs))
    losses = [r["loss"] for r in records if r["kind"] == "step"]
    assert losses == ref.step_losses
    resume = [r for r in records if r["kind"] == "resume"]
    assert [(r["cursor_epoch"], r["cursor_step"], r["strategy"]) for r in resume] == [
        (1, 1, "replicate")]
    assert validate_jsonl(cfg.metrics_file) == []


def test_resumed_losses_match_the_jax_trainer(tmp_path, gates):
    """A preempted-then-resumed run's nine step losses against the JAX
    train step's uninterrupted run from the same weights, rtol 1e-4, the
    JAX side fed by the JAX trainer's own walk (its manifests,
    ``DataLoader`` and ``synchronized_batches``): the resumed cursor's
    steps are JAX's samples. The trunk is frozen (``feature_extract``) on
    both sides: a 32 px resnet18 trained whole turns f32 rounding into
    loss gaps that grow step after step through its batchnorm backward
    (``tests/test_torch_train_step.py``), 1.2e-3 by the ninth step, while
    the resume's own parity over the whole trunk is the bitwise test
    above."""
    import jax
    import jax.numpy as jnp

    from mpi_pytorch_tpu.config import Config as JaxConfig
    from mpi_pytorch_tpu.config import MeshConfig
    from mpi_pytorch_tpu.data.manifest import load_manifests as jax_load_manifests
    from mpi_pytorch_tpu.data.pipeline import DataLoader as JaxDataLoader
    from mpi_pytorch_tpu.train.trainer import synchronized_batches as jax_synchronized_batches
    from mpi_pytorch_tpu.models.common import head_filter
    from mpi_pytorch_tpu.models.resnet import resnet18 as jax_resnet18
    from mpi_pytorch_tpu.parallel import create_mesh, shard_batch
    from mpi_pytorch_tpu.train.state import TrainState as JaxTrainState
    from mpi_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
    from mpi_pytorch_tpu.train.step import make_train_step as jax_make_train_step
    from mpi_pytorch_tpu.train.step import place_state_on_mesh
    from mpi_pytorch_tpu_torch.models.convert import to_flax_variables
    from mpi_pytorch_tpu_torch.models.registry import create_model_bundle

    cfg = _cfg(str(tmp_path), feature_extract=True)
    gates["MPT_FAULT_PREEMPT_AT_STEP"] = "4"
    assert trainer.train(cfg, device="cpu").preempted
    del gates["MPT_FAULT_PREEMPT_AT_STEP"]
    env.reset_fault_counters()
    trainer.train(dataclasses.replace(cfg, from_checkpoint=True), device="cpu")
    records = _records(cfg)
    assert _pairs(records) == [(e, s) for e in range(EPOCHS) for s in range(STEPS)]
    got = [r["loss"] for r in records if r["kind"] == "step"]

    bundle = create_model_bundle("resnet18", cfg.num_classes, seed=cfg.seed,
                                 image_size=cfg.image_size, fused_stem=True)
    variables = jax.tree_util.tree_map(
        jnp.asarray, to_flax_variables(bundle.model.state_dict(), "resnet18"))
    mask = jax.tree_util.tree_map_with_path(
        lambda path, _: head_filter([getattr(k, "key", str(k)) for k in path]),
        variables["params"])
    mesh = create_mesh(MeshConfig(), devices=jax.devices()[:1])
    state = place_state_on_mesh(JaxTrainState.create(
        apply_fn=jax_resnet18(cfg.num_classes, dtype=jnp.float32, fused_stem=True).apply,
        variables=variables, tx=jax_make_optimizer(cfg.learning_rate, mask),
        rng=jax.random.PRNGKey(1)), mesh)
    step = jax_make_train_step(jnp.float32)
    # The JAX trainer's loader over its own train manifest (one process:
    # the whole manifest is the host's shard).
    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(JaxConfig)
                        if f.name in ("debug", "debug_sample_size", "train_csv", "test_csv",
                                      "num_classes", "batch_size", "seed", "shuffle",
                                      "drop_remainder", "synthetic_data", "input_dtype",
                                      "width", "height")})
    loader = JaxDataLoader(
        jax_load_manifests(jcfg)[0], batch_size=jcfg.batch_size, image_size=jcfg.image_size,
        shuffle=jcfg.shuffle, seed=jcfg.seed, drop_remainder=jcfg.drop_remainder,
        synthetic=jcfg.synthetic_data, num_workers=2, image_dtype=jcfg.input_dtype,
        native_decode=jcfg.native_decode, decode_prescale=jcfg.decode_prescale)
    want = []
    for epoch in range(EPOCHS):
        for images, labels in jax_synchronized_batches(loader, epoch, STEPS):
            state, m = step(state, shard_batch((images, labels), mesh))
            want.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_cursor_mismatch_falls_back_to_replay(runs, tmp_path):
    cfg = _copy(runs["cut"][0], tmp_path, from_checkpoint=True, batch_size=8)
    done = trainer.train(cfg, device="cpu")
    assert not done.preempted
    assert "exact-step resume unavailable" in open(cfg.log_file).read()
    records = _records(cfg)
    mismatch = [r for r in records if r["kind"] == "anomaly"]
    assert [(r["reason"], r["epoch"]) for r in mismatch] == [("cursor_mismatch", 1)]
    assert mismatch[0]["detail"] == "cursor global_batch=16 != current 8"
    # The interrupted epoch is replayed from step 0: (1, 0) twice.
    assert _pairs(records).count((1, 0)) == 2
    assert validate_jsonl(cfg.metrics_file) == []


def test_corrupt_newest_falls_back_and_all_corrupt_raises(runs, tmp_path):
    ref_cfg, ref = runs["ref"]
    cfg = _copy(ref_cfg, tmp_path / "one", from_checkpoint=True)
    paths = ckpt.checkpoint_paths(cfg.checkpoint_dir)
    assert [ckpt.checkpoint_epoch(p) for p in paths] == [0, 1, 2]
    with open(paths[-1], "r+b") as f:
        f.truncate(os.path.getsize(paths[-1]) // 2)
    with open(paths[-1] + ".tmp", "wb") as f:  # what a kill mid-write leaves
        f.write(b"partial")
    before = len(_records(cfg))
    done = trainer.train(cfg, device="cpu")
    assert done.epochs_run == 1 and done.epoch_losses == ref.epoch_losses[-1:]
    records = _records(cfg)[before:]
    assert [r["kind"] for r in records[:2]] == ["anomaly", "resume"]
    assert (records[0]["reason"], records[0]["epoch"]) == ("corrupt_checkpoint", 2)
    assert (records[1]["epoch"], records[1]["corrupt_skipped"]) == (1, 1)
    assert torch.equal(_tensors(_final(cfg))[".model.fc.weight"],
                       _tensors(_final(ref_cfg))[".model.fc.weight"])

    cfg = _copy(ref_cfg, tmp_path / "all", from_checkpoint=True)
    for path in ckpt.checkpoint_paths(cfg.checkpoint_dir):
        with open(path, "wb") as f:
            f.write(b"garbage" * 100)
    with pytest.raises(ckpt.CheckpointCorruptError, match="refusing to fresh-start"):
        trainer.train(cfg, device="cpu")


def _small_state(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(128, 64), torch.nn.Linear(64, 10))
    opt, schedule = make_optimizer(model, 1e-2)
    state = TrainState(model=model, optimizer=opt, schedule=schedule)
    for _ in range(2):
        model(torch.randn(4, 128)).square().sum().backward()
        opt.step()
        state.step += 1
    return state


def test_sidecars_and_dirty_follow_retention_and_overwrites(runs, tmp_path):
    # The resumed run (keep 2) retires the dirty epoch-0 file with both
    # sidecars, and every file it keeps has its manifest.
    cfg = _copy(runs["cut"][0], tmp_path / "run", from_checkpoint=True, keep_checkpoints=2)
    trainer.train(cfg, device="cpu")
    assert sorted(os.listdir(cfg.checkpoint_dir)) == [
        "ckpt_00001.pt", "ckpt_00001.pt.manifest.json",
        "ckpt_00002.pt", "ckpt_00002.pt.manifest.json"]

    state, d = _small_state(), str(tmp_path / "unit")
    path = ckpt.save_checkpoint(d, epoch=0, state=state, loss=1.0, dirty=True,
                                manifest={"a": 1})
    assert os.path.exists(path + ".dirty") and ckpt.read_manifest(path) == {"a": 1}
    ckpt.save_checkpoint(d, epoch=0, state=state, loss=1.0)  # a clean overwrite
    assert not os.path.exists(path + ".dirty") and ckpt.read_manifest(path) is None
    with open(path + ".manifest.json", "w") as f:
        f.write("{not json")
    assert ckpt.read_manifest(path) is None
    for epoch in (1, 2):
        ckpt.save_checkpoint(d, epoch=epoch, state=state, loss=1.0, dirty=epoch == 1,
                             manifest={"e": epoch}, keep=1)
    assert sorted(os.listdir(d)) == ["ckpt_00002.pt", "ckpt_00002.pt.manifest.json"]


def test_bf16_moments_round_trip_as_jax(tmp_path):
    state = _small_state()
    live = {i: {k: v.clone() for k, v in st.items()}
            for i, st in state.optimizer.state_dict()["state"].items()}
    ckpt.save_checkpoint(str(tmp_path), epoch=0, state=state, loss=1.0, moments_bf16=True)
    path = ckpt.latest_checkpoint(str(tmp_path))
    stored = torch.load(path, weights_only=True)["optimizer"]["state"]
    fresh = _small_state(seed=1)
    ckpt.restore_checkpoint(path, fresh)
    restored = fresh.optimizer.state_dict()["state"]
    # JAX's host-side cast of the same moments (checkpoint._cast_moments).
    jax_cast = jax_ckpt._cast_moments({i: {k: v.numpy() for k, v in st.items() if k != "step"}
                                       for i, st in live.items()})
    for i, st in live.items():
        for k, v in st.items():
            big = v.numel() >= 4096 and k != "step"
            assert stored[i][k].dtype == (torch.bfloat16 if big else v.dtype), (i, k)
            assert restored[i][k].dtype == v.dtype
            if k == "step":
                assert torch.equal(restored[i][k], v)
                continue
            ref = np.asarray(jax_cast[i][k]).astype(np.float32)
            np.testing.assert_array_equal(restored[i][k].numpy(), ref)
            assert torch.equal(restored[i][k], v) != big
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)  # the parameters stay exact


def test_async_snapshot_is_a_copy(monkeypatch, tmp_path):
    state = _small_state()
    at_save = {k: v.clone() for k, v in state.model.state_dict().items()}
    release = threading.Event()
    real = ckpt._write

    def slow(*args, **kw):
        release.wait(30)
        return real(*args, **kw)

    monkeypatch.setattr(ckpt, "_write", slow)
    writer = ckpt.AsyncCheckpointer()
    path = writer.save(str(tmp_path), epoch=0, state=state, loss=1.0)
    # The next step updates the live tensors in place before the write.
    state.model(torch.randn(4, 128)).square().sum().backward()
    state.optimizer.step()
    assert not os.path.exists(path)
    release.set()
    writer.wait()
    saved = torch.load(path, weights_only=True)["model"]
    for k, v in at_save.items():
        assert torch.equal(saved[k], v), k
        assert not torch.equal(saved[k], state.model.state_dict()[k]), k


def test_async_writer_error_fails_the_run(monkeypatch, tmp_path):
    def broken(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", broken)
    writer = ckpt.AsyncCheckpointer()
    writer.save(str(tmp_path), epoch=0, state=_small_state(), loss=1.0)
    with pytest.raises(OSError, match="disk full"):
        writer.wait()
    writer.wait()  # raised once


def test_summary_and_config_carry_the_preempted_flag():
    assert "preempted" in {f.name for f in dataclasses.fields(trainer.TrainSummary)}
