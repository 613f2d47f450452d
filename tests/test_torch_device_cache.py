"""The port's device-resident training set (``--device-cache``,
``--scan-epoch``, validation from the cache) in one process, against the
JAX package and against the port's own streaming path, on the CPU.

resnet18 at 64 px with the fused stem (its plain versions here; the JAX
Pallas pair in interpret mode), f32, SGD with momentum at 4e-4, batch 8,
the DEBUG sample of 32 rows: 25 train rows over a 64-wide head (the
contiguous label remap), ``drop_remainder`` off, so an epoch is three full
steps and a tail of one real row.

Held against the JAX functions:

- ``cached_index_batches`` yields JAX's (idx, valid) for several
  (n, batch, epoch, shuffle, start_step);
- ``validate_config`` refuses the device cache in spmd mode and the scan
  epoch without the cache, with JAX's words;
- ``build_device_cache``'s rows are byte-identical to JAX's on a
  one-device mesh, uint8 and f32;
- every gathered batch of two epochs (``step._gather_batch``) is
  byte-identical to JAX's ``_gather_batch`` (run eagerly: under ``jit``
  XLA rounds the uint8 normalize's division differently, by an ulp) and
  to the streaming loader's padded batch for the same step;
- three cached steps (uint8 rows) match JAX's ``make_cached_train_step``:
  losses rtol 1e-4 (``tests/test_torch_train_step.py``'s tolerance).

And of the port itself, two epochs through ``trainer.train``: the cached
run's step losses and final weights equal the streaming run's bit for
bit, and the scanned run's equal the cached run's (the same eager
operations on the same batches); validation from the cache gives the
streaming validation's accuracy exactly and its loss rtol 1e-6; under
``bad_step_policy`` skip and abort, a poisoned cache row makes the scanned
and the per-step cached runs skip or stop alike.
"""

import json
import os

import numpy as np
import pytest
import torch

from mpi_pytorch_tpu import config as jax_config
from mpi_pytorch_tpu.data import pipeline as jax_pipeline
from mpi_pytorch_tpu.train import trainer as jax_trainer
from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import Config, parse_config
from mpi_pytorch_tpu_torch.data.manifest import load_manifests
from mpi_pytorch_tpu_torch.data.pipeline import epoch_order
from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training
from mpi_pytorch_tpu_torch.train import trainer
from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer
from mpi_pytorch_tpu_torch.train.step import (
    _gather_batch,
    ingest_images,
    make_cached_train_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
BATCH = 8
SIZE = 64
CLASSES = 64
LR = 4e-4


def _cfg(tmp: str = "", **kw) -> Config:
    base = dict(
        debug=True, debug_sample_size=32, num_classes=CLASSES, width=SIZE, height=SIZE,
        batch_size=BATCH, num_epochs=2, compute_dtype="float32", input_dtype="uint8",
        fused_stem=True, drop_remainder=False, loader_workers=2, log_every_steps=1,
        optimizer="sgd", learning_rate=LR, keep_checkpoints=1,
        test_csv=os.path.join(REPO, "data", "test_sample.csv"),
        checkpoint_dir=os.path.join(tmp, "ckpt"), log_file=os.path.join(tmp, "training.log"),
        metrics_file=os.path.join(tmp, "metrics.jsonl"),
    )
    return Config(**{**base, **kw})


def _records(cfg: Config) -> list[dict]:
    with open(cfg.metrics_file) as f:
        return [json.loads(line) for line in f]


def _weights(cfg: Config) -> dict:
    return ckpt.load_for_eval(ckpt.latest_checkpoint(cfg.checkpoint_dir))[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two epochs each: streaming, device cache, device cache + scan."""
    out = {}
    for name, kw in (("streaming", {}), ("cached", {"device_cache": True}),
                     ("scanned", {"device_cache": True, "scan_epoch": True})):
        cfg = _cfg(str(tmp_path_factory.mktemp(name)), **kw)
        out[name] = (cfg, trainer.train(cfg, device="cpu"))
    return out


@pytest.mark.parametrize("n,batch,epoch,shuffle,start_step", [
    (25, 8, 0, True, 0), (25, 8, 1, True, 0), (25, 8, 1, True, 2), (24, 8, 0, False, 0),
    (7, 4, 3, True, 1), (3, 8, 2, True, 0), (0, 4, 0, True, 0),
])
def test_cached_index_batches_match_jax(n, batch, epoch, shuffle, start_step):
    n_steps = max(1, -(-n // batch))
    got = list(trainer.cached_index_batches(
        Config(seed=5), n, batch, epoch, n_steps, shuffle=shuffle, start_step=start_step))
    want = list(jax_trainer.cached_index_batches(
        jax_config.Config(seed=5), n, batch, epoch, n_steps, shuffle=shuffle,
        start_step=start_step))
    assert len(got) == len(want) == n_steps - start_step
    for (gi, gv), (wi, wv) in zip(got, want):
        assert gi.dtype == wi.dtype == np.int32 and gv.dtype == wv.dtype == np.bool_
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)
    if n % batch:  # the tail repeats its own rows, masked
        tail_idx, tail_valid = got[-1]
        assert not tail_valid[n % batch:].any() and tail_valid[:n % batch].all()


@pytest.mark.parametrize("kw", [{"device_cache": True, "spmd_mode": True},
                                {"scan_epoch": True}], ids=["spmd", "scan_without_cache"])
def test_config_refusals_match_jax(kw):
    with pytest.raises(ValueError) as got:
        Config(**kw).validate_config()
    with pytest.raises(ValueError) as want:
        jax_config.Config(**kw).validate_config()
    assert str(got.value) == str(want.value)
    flags = parse_config(["--device-cache", "true", "--scan-epoch", "true"])
    assert (flags.device_cache, flags.scan_epoch) == (True, True)


def _jax_loader(manifest, dtype: str):
    return jax_pipeline.DataLoader(
        manifest, batch_size=BATCH, image_size=(SIZE, SIZE), shuffle=True, seed=0,
        drop_remainder=False, synthetic=True, num_workers=2, image_dtype=dtype)


def _one_device_mesh():
    import jax

    from mpi_pytorch_tpu.config import MeshConfig
    from mpi_pytorch_tpu.parallel import create_mesh

    return create_mesh(MeshConfig(), devices=jax.devices()[:1])


def _caches(dtype: str):
    """(cfg, train manifest, the port's cache, JAX's cache on one device)."""
    cfg = _cfg(input_dtype=dtype)
    train_m, _ = load_manifests(cfg)
    loader = trainer.make_loader(cfg, train_m, train=True)
    port = trainer.build_device_cache(cfg, train_m, loader, CPU)
    ref = jax_trainer.build_device_cache(
        jax_config.Config(), train_m, _jax_loader(train_m, dtype), _one_device_mesh())
    return cfg, train_m, loader, port, ref


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_cache_rows_match_jax(dtype):
    _, train_m, _, (dataset, labels), (ref_rows, ref_labels) = _caches(dtype)
    assert dataset.shape == (len(train_m), SIZE, SIZE, 3) == ref_rows.shape
    assert dataset.dtype == getattr(torch, dtype) and labels.dtype == torch.int32
    assert dataset.numpy().tobytes() == np.asarray(ref_rows).tobytes()
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_gathered_batches_match_jax_and_the_loader(dtype):
    """Both epochs' batches, the one-row tail included: the port's gather,
    JAX's, and the streaming loader's padded batch after ingest."""
    import jax.numpy as jnp

    from mpi_pytorch_tpu.train.step import _gather_batch as jax_gather_batch

    cfg, train_m, loader, (dataset, labels), (ref_rows, ref_labels) = _caches(dtype)
    mesh = _one_device_mesh()
    n_steps = trainer.global_step_count(len(train_m), BATCH, drop_remainder=False)
    assert n_steps == 4
    for epoch in (0, 1):
        walk = trainer.cached_index_batches(cfg, len(train_m), BATCH, epoch, n_steps)
        stream = trainer.synchronized_batches(loader, epoch, n_steps)
        for (idx, valid), (images, lbl) in zip(walk, stream):
            got_x, got_y = _gather_batch(dataset, labels, torch.from_numpy(idx),
                                         torch.from_numpy(valid), torch.float32)
            want_x, want_y = jax_gather_batch(mesh, jnp.float32, ref_rows, ref_labels, idx, valid)
            assert got_x.numpy().tobytes() == np.asarray(want_x).tobytes()
            np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
            images, lbl = trainer.pad_batch(images, lbl, BATCH)
            assert got_x.numpy().tobytes() == ingest_images(
                torch.from_numpy(images), torch.float32).numpy().tobytes()
            np.testing.assert_array_equal(got_y.numpy(), lbl)
    assert (got_y.numpy() == -1).sum() == BATCH - 1  # the tail: one real row


def test_three_cached_steps_match_jax(monkeypatch):
    import jax
    import jax.numpy as jnp

    from mpi_pytorch_tpu.models.resnet import resnet18 as jax_resnet18
    from mpi_pytorch_tpu.train.state import TrainState as JaxTrainState
    from mpi_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
    from mpi_pytorch_tpu.train.step import make_cached_train_step as jax_cached_step
    from mpi_pytorch_tpu.train.step import place_state_on_mesh
    from mpi_pytorch_tpu_torch.models.convert import to_flax_variables

    monkeypatch.setenv("MPT_STEM_INTERPRET", "1")
    cfg, train_m, _, (dataset, labels), (ref_rows, ref_labels) = _caches("uint8")
    mesh = _one_device_mesh()
    bundle = create_model_bundle("resnet18", CLASSES, seed=0, fused_stem=True)
    jax_state = place_state_on_mesh(JaxTrainState.create(
        apply_fn=jax_resnet18(CLASSES, dtype=jnp.float32, fused_stem=True, dp_mesh=mesh).apply,
        variables=jax.tree_util.tree_map(
            jnp.asarray, to_flax_variables(bundle.model.state_dict(), "resnet18")),
        tx=jax_make_optimizer(LR, optimizer="sgd"), rng=jax.random.PRNGKey(1),
    ), mesh)
    jax_step = jax_cached_step(mesh, jnp.float32)
    model = prepare_for_training(bundle.model, CPU)
    opt, schedule = make_optimizer(model, LR, optimizer="sgd")
    state = TrainState(model=model, optimizer=opt, schedule=schedule)
    step = make_cached_train_step(torch.float32)
    got, want = [], []
    for idx, valid in trainer.cached_index_batches(cfg, len(train_m), BATCH, 0, 3):
        m = step(state, dataset, labels, torch.from_numpy(idx), torch.from_numpy(valid))
        got.append((float(m["loss"]), int(m["count"])))
        jax_state, jm = jax_step(jax_state, ref_rows, ref_labels, idx, valid)
        want.append((float(jm["loss"]), int(jm["count"])))
    assert [c for _, c in got] == [c for _, c in want] == [BATCH] * 3
    np.testing.assert_allclose([x for x, _ in got], [x for x, _ in want], rtol=1e-4)


def test_cached_run_is_the_streaming_run(runs):
    (s_cfg, stream), (c_cfg, cached) = runs["streaming"], runs["cached"]
    assert len(cached.step_losses) == 8 and np.all(np.isfinite(cached.step_losses))
    assert cached.step_losses == stream.step_losses
    assert cached.epoch_losses == stream.epoch_losses
    a, b = _weights(c_cfg), _weights(s_cfg)
    for k in b:
        assert a[k].numpy().tobytes() == b[k].numpy().tobytes(), k
    assert cached.cache_build_s is not None and stream.cache_build_s is None
    with open(c_cfg.log_file) as f:
        assert "device cache: 25 images, rows sharded over 1 rank(s) (0.3 MB/rank uint8)" in f.read()


def test_scanned_run_is_the_cached_run(runs):
    (c_cfg, cached), (x_cfg, scanned) = runs["cached"], runs["scanned"]
    assert scanned.step_losses == cached.step_losses
    assert scanned.epoch_losses == cached.epoch_losses
    a, b = _weights(x_cfg), _weights(c_cfg)
    for k in b:
        assert a[k].numpy().tobytes() == b[k].numpy().tobytes(), k
    timing = ("ts", "time_s", "images_per_sec")

    def records(cfg):
        return [{k: v for k, v in r.items() if k not in timing} for r in _records(cfg)]

    assert records(x_cfg) == records(c_cfg)


def test_validation_from_the_cache_is_the_streaming_validation(runs):
    (s_cfg, stream), (c_cfg, cached) = runs["streaming"], runs["cached"]
    got = [r for r in _records(c_cfg) if r["kind"] == "val"]
    want = [r for r in _records(s_cfg) if r["kind"] == "val"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["accuracy"] == w["accuracy"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-6)
    # And against the streaming evaluation of the same weights.
    model = prepare_for_training(
        create_model_bundle("resnet18", CLASSES, seed=0, fused_stem=True).model, CPU)
    model.load_state_dict(_weights(c_cfg))
    train_m, _ = load_manifests(c_cfg)
    dataset, labels = trainer.build_device_cache(
        c_cfg, train_m, trainer.make_loader(c_cfg, train_m, train=True), CPU)
    acc, loss = trainer.evaluate_cached(c_cfg, model, dataset, labels)
    ref_acc, ref_loss = trainer.evaluate_manifest(c_cfg, model, train_m)
    assert acc == ref_acc == cached.val_accuracy
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)


def _poisoned(monkeypatch, row: int):
    """Make the cache's f32 row ``row`` NaN, so any step that gathers it is
    non-finite."""
    real = trainer.build_device_cache

    def build(*args, **kw):
        dataset, labels = real(*args, **kw)
        dataset[row] = float("nan")
        return dataset, labels

    monkeypatch.setattr(trainer, "build_device_cache", build)


@pytest.mark.parametrize("policy", ["skip", "abort"])
def test_scan_checks_at_the_epoch_end_as_the_per_step_path(policy, monkeypatch, tmp_path):
    """One poisoned row (epoch 0's step 1 gathers it): under skip both runs
    skip that step alike and go on; under abort both raise before the
    epoch's checkpoint, having written the same step records."""
    train_m, _ = load_manifests(_cfg())
    order = epoch_order(0, 0, len(train_m), True)
    _poisoned(monkeypatch, int(order[BATCH + 2]))
    out = {}
    for name, scan in (("cached", False), ("scanned", True)):
        cfg = _cfg(str(tmp_path / name), input_dtype="float32", num_epochs=1,
                   device_cache=True, scan_epoch=scan, bad_step_policy=policy)
        if policy == "abort":
            with pytest.raises(trainer.NonFiniteLossError, match="epoch 0 step 1"):
                trainer.train(cfg, device="cpu")
            assert not os.path.exists(cfg.checkpoint_dir) or not os.listdir(cfg.checkpoint_dir)
            out[name] = _records(cfg)
        else:
            summary = trainer.train(cfg, device="cpu")
            out[name] = (summary.step_losses, summary.epoch_losses, _records(cfg))
    if policy == "abort":
        assert [r["step"] for r in out["scanned"]] == [0, 1]
        assert [r["loss"] for r in out["scanned"]][:1] == [r["loss"] for r in out["cached"]][:1]
        return
    (c_steps, c_epochs, c_recs), (s_steps, s_epochs, s_recs) = out["cached"], out["scanned"]
    assert [r.get("skipped") for r in s_recs if r["kind"] == "step"] == [0, 1, 0, 0]
    np.testing.assert_array_equal(s_steps, c_steps)  # NaN in the same place
    assert s_epochs == c_epochs and np.isfinite(s_epochs[0])
