"""The port's configuration, data layer and trainer against the JAX
package, on the CPU.

- Every port ``Config`` field has the JAX field's name and default, and
  ``parse_config`` parses the same flags (strictly, with ``--image-size``).
- ``load_manifests`` gives the JAX package's manifests and label map
  (DEBUG sampling, raw ids for a wide head, the contiguous remap for a
  narrow one), and ``DataLoader`` byte-identical batches for
  (seed, epoch) = (0, 0) and (0, 1), f32 and uint8.
- The trainer: ``pad_batch``/``global_step_count`` as the JAX ones,
  checkpoint round trip, keep-last-k, and ``from_checkpoint`` continuing
  the epoch counter; exact comparisons throughout.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mpi_pytorch_tpu import config as jax_config
from mpi_pytorch_tpu.data import pipeline as jax_pipeline
from mpi_pytorch_tpu.data.manifest import load_manifests as jax_load_manifests
from mpi_pytorch_tpu.train import trainer as jax_trainer
from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import Config, parse_config
from mpi_pytorch_tpu_torch.data.manifest import load_manifests
from mpi_pytorch_tpu_torch.data.pipeline import DataLoader, epoch_order
from mpi_pytorch_tpu_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV = {
    "train_csv": os.path.join(REPO, "data", "train_sample.csv"),
    "test_csv": os.path.join(REPO, "data", "test_sample.csv"),
}


def test_config_fields_match_jax():
    jax_fields = {f.name: f for f in dataclasses.fields(jax_config.Config)}
    for f in dataclasses.fields(Config):
        assert f.name in jax_fields, f.name
        got, want = getattr(Config(), f.name), getattr(jax_config.Config(), f.name)
        if dataclasses.is_dataclass(got):  # the mesh: every field, by name
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert {"device_cache", "scan_epoch"} <= {f.name for f in dataclasses.fields(Config)}


def test_parse_config_flags(monkeypatch):
    for key in list(os.environ):
        if key.startswith("MPT_"):
            monkeypatch.delenv(key)
    argv = ["--batch-size", "64", "--image-size", "96", "--height", "64",
            "--fused-stem", "true", "--lr-schedule", "cosine", "--optimizer", "sgd"]
    cfg = parse_config(argv)
    assert (cfg.batch_size, cfg.width, cfg.height, cfg.fused_stem) == (64, 96, 64, True)
    assert (cfg.lr_schedule, cfg.optimizer) == ("cosine", "sgd")
    with pytest.raises(SystemExit):
        parse_config(["--batchsize", "64"])  # strict: an unknown flag errors
    with pytest.raises(ValueError, match="weight_decay"):
        parse_config(["--weight-decay", "0.1"])  # only adamw decays
    with pytest.raises(ValueError, match="bad_step_policy"):
        # rollback restores a checkpoint, so it needs the periodic saves
        parse_config(["--bad-step-policy", "rollback", "--checkpoint-every-epochs", "0"])
    monkeypatch.setenv("MPT_NUM_EPOCHS", "3")
    assert parse_config([]).num_epochs == 3


@pytest.mark.parametrize(
    "debug,num_classes", [(True, 64500), (True, 3000), (False, 64500)],
    ids=["debug_raw_ids", "debug_remapped", "full_raw_ids"],
)
def test_manifests_match_jax(debug, num_classes):
    kw = dict(debug=debug, num_classes=num_classes, debug_sample_size=3200, seed=0, **CSV)
    got = load_manifests(Config(**kw))
    ref = jax_load_manifests(jax_config.Config(**kw))
    for g, r in zip(got, ref):
        assert g.filenames == r.filenames and g.img_dir == r.img_dir
        np.testing.assert_array_equal(g.labels, r.labels)
        np.testing.assert_array_equal(g.category_ids, r.category_ids)
    half = got[0].shard(3, 1)
    ref_half = ref[0].shard(3, 1)
    assert half.filenames == ref_half.filenames
    np.testing.assert_array_equal(half.labels, ref_half.labels)


def test_manifest_rejects_too_narrow_a_head():
    with pytest.raises(ValueError, match="exceed num_classes"):
        load_manifests(Config(debug=True, debug_sample_size=400, num_classes=10, **CSV))


@pytest.mark.parametrize("image_dtype", ["float32", "uint8"])
def test_loader_batches_are_byte_identical_to_jax(image_dtype):
    cfg = Config(debug=True, debug_sample_size=120, num_classes=64500, **CSV)
    manifest, _ = load_manifests(cfg)
    kw = dict(batch_size=16, image_size=(24, 20), shuffle=True, seed=0,
              drop_remainder=False, synthetic=True, num_workers=2, prefetch=2,
              image_dtype=image_dtype)
    ours = DataLoader(manifest, **kw)
    ref = jax_pipeline.DataLoader(manifest, **kw)  # the port's manifest duck-types
    assert len(ours) == len(ref) == 6
    for epoch in (0, 1):
        got = list(ours.epoch(epoch))
        want = list(ref.epoch(epoch))
        assert len(got) == len(want) == 6
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.dtype == wi.dtype == np.dtype(image_dtype)
            assert gi.tobytes() == wi.tobytes()
            np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(epoch_order(0, 1, 50, True), jax_pipeline.epoch_order(0, 1, 50, True))
    assert len(DataLoader(manifest, **{**kw, "drop_remainder": True})) == 6  # 96 train rows
    skipped = list(ours.epoch(1, start_batch=4))
    assert len(skipped) == 2 and skipped[0][0].tobytes() == list(ours.epoch(1))[4][0].tobytes()


def test_pad_and_step_count_match_jax():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(5, 4, 4, 3)).astype(np.uint8)
    labels = np.arange(5, dtype=np.int32)
    for target in (5, 8, 13):
        got = trainer.pad_batch(images, labels, target)
        want = jax_trainer.pad_batch(images, labels, target)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for n, b, drop in ((100, 16, True), (100, 16, False), (96, 16, False)):
        assert trainer.global_step_count(n, b, drop) == jax_trainer.global_step_count(n, b, drop)


def _cfg(tmp_path, **kw):
    base = dict(
        debug=True, debug_sample_size=60, num_classes=64500, width=32, height=32,
        batch_size=16, num_epochs=1, compute_dtype="float32", input_dtype="uint8",
        fused_stem=True, loader_workers=2, log_every_steps=1,
        checkpoint_dir=str(tmp_path / "ckpt"), log_file=str(tmp_path / "training.log"),
        metrics_file=str(tmp_path / "metrics.jsonl"), **CSV,
    )
    base.update(kw)
    return Config(**base)


def test_train_checkpoints_and_resumes(tmp_path):
    """One epoch, then a resume to three epochs with keep-last-2: the epoch
    counter continues from the checkpoint, the restored state is the saved
    one bit for bit, and only the last two checkpoints remain."""
    cfg = _cfg(tmp_path, keep_checkpoints=2)
    first = trainer.train(cfg, device="cpu")
    assert first.epochs_run == 1 and len(first.step_losses) == 3  # 48 rows / 16
    assert np.all(np.isfinite(first.step_losses)) and first.val_accuracy is not None
    path = ckpt.latest_checkpoint(cfg.checkpoint_dir)
    assert path == first.checkpoint_path and ckpt.checkpoint_epoch(path) == 0

    state, _ = trainer.build_training(cfg, torch.device("cpu"))
    epoch, loss = ckpt.restore_checkpoint(path, state)
    assert (epoch, loss, state.step) == (0, pytest.approx(first.final_loss), 3)
    saved = torch.load(path, weights_only=True)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    moments = state.optimizer.state_dict()["state"]
    assert len(moments) == len(list(state.model.parameters()))

    resumed = trainer.train(dataclasses.replace(cfg, num_epochs=3, from_checkpoint=True), device="cpu")
    assert resumed.epochs_run == 2 and len(resumed.step_losses) == 6
    names = [os.path.basename(p) for p in ckpt.checkpoint_paths(cfg.checkpoint_dir)]
    assert names == ["ckpt_00001.pt", "ckpt_00002.pt"]
    records = [l for l in open(cfg.metrics_file).read().splitlines() if '"kind": "epoch"' in l]
    assert [int(r.split('"epoch": ')[1].split(",")[0]) for r in records] == [0, 1, 2]
    state, _ = trainer.build_training(cfg, torch.device("cpu"))
    assert ckpt.restore_checkpoint(ckpt.latest_checkpoint(cfg.checkpoint_dir), state)[0] == 2
    assert state.step == 9


def test_train_aborts_on_a_non_finite_step(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path, validate=False)
    real = trainer.make_train_step

    def poisoned(dtype, bad_step_skip=False, **kw):
        step = real(dtype, bad_step_skip, **kw)

        def run(state, images, labels):
            m = step(state, images, labels)
            m["loss"] = m["loss"] * float("nan")
            return m

        return run

    monkeypatch.setattr(trainer, "make_train_step", poisoned)
    with pytest.raises(trainer.NonFiniteLossError, match="bad_step_policy=abort"):
        trainer.train(cfg, device="cpu")


def test_vit_cli_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    """vit_s16 at full width through ``python -m mpi_pytorch_tpu_torch.train``'s
    ``main`` on the CPU (``MPT_PLATFORM=cpu``), 32 px with the tiny-S
    attention and fused q/k/v: two epochs, a checkpoint per epoch, then a
    resume to three that continues the epoch and step counters."""
    monkeypatch.setenv("MPT_PLATFORM", "cpu")
    argv = [
        "--model-name", "vit_s16", "--attn-impl", "fused-small", "--qkv-fused", "true",
        "--image-size", "32", "--batch-size", "16", "--debug-sample-size", "60",
        "--num-classes", "1000", "--compute-dtype", "float32",
        "--input-dtype", "uint8", "--loader-workers", "2", "--keep-checkpoints", "2",
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-file", str(tmp_path / "training.log"),
        "--metrics-file", str(tmp_path / "metrics.jsonl"),
        "--train-csv", CSV["train_csv"], "--test-csv", CSV["test_csv"],
    ]
    first = trainer.main(argv + ["--num-epochs", "2"])
    assert first.epochs_run == 2 and len(first.step_losses) == 6  # 48 rows / 16, twice
    assert np.all(np.isfinite(first.step_losses)) and first.val_accuracy is not None
    names = [os.path.basename(p) for p in ckpt.checkpoint_paths(str(tmp_path / "ckpt"))]
    assert names == ["ckpt_00000.pt", "ckpt_00001.pt"]
    saved = torch.load(ckpt.latest_checkpoint(str(tmp_path / "ckpt")), weights_only=True)
    assert saved["step"] == 6 and "blocks.11.attn.q.weight" in saved["model"]
    assert not any("running" in k for k in saved["model"])  # no batchnorm anywhere

    resumed = trainer.main(argv + ["--num-epochs", "3", "--from-checkpoint", "true"])
    assert resumed.epochs_run == 1 and len(resumed.step_losses) == 3
    cfg = parse_config(argv + ["--num-epochs", "3"])
    state, _ = trainer.build_training(cfg, torch.device("cpu"))
    assert ckpt.restore_checkpoint(ckpt.latest_checkpoint(cfg.checkpoint_dir), state)[0] == 2
    assert state.step == 9

