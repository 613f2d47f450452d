"""The port's device cache on two gloo ranks against the JAX package's on
a two-device mesh, and against one process, on the CPU.

Each rank of a two-rank world (``parallel.launch.run_world``, torchrun's
environment, 120 s, two threads a rank) builds the cache of the DEBUG
sample's 25 train rows at 64 px in uint8 and in f32, gathers every batch
of epoch 0 from each (global batch 8, so 4 rows a rank; three full steps
and a one-row tail), then runs ``python -m mpi_pytorch_tpu_torch.train``'s
``main`` with ``--device-cache true``: resnet18 with the fused stem, f32,
SGD with momentum at 4e-4, ``drop_remainder`` on (three steps), one
epoch, validation from the cache.

- Each rank holds ⌈25/2⌉ = 13 rows, byte-identical to its shard of JAX's
  ``build_device_cache`` on a two-device mesh (the padding row zeros).
- Each rank's gathered slice, in uint8 and f32, is byte-identical to its
  rows of JAX's ``_gather_batch`` on that mesh (eagerly, as
  ``tests/test_torch_device_cache.py`` says why): the sum over the ranks
  is exact on gloo for both dtypes.
- The three step losses match JAX's ``make_cached_train_step`` on that
  mesh fed the same global index batches, rtol 1e-4
  (``tests/test_torch_train_step.py``'s tolerance), and the port's own
  one-process cached run at the ranks' thread count, rtol 1e-4; the ranks
  report the same losses.
- Validation from the cache on two ranks gives one process's streaming
  evaluation of the saved checkpoint (at the ranks' thread count): the
  same accuracy, the mean loss rtol 1e-6.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import Config, parse_config
from mpi_pytorch_tpu_torch.data.manifest import load_manifests
from mpi_pytorch_tpu_torch.parallel import distributed
from mpi_pytorch_tpu_torch.parallel.launch import run_world
from mpi_pytorch_tpu_torch.train import trainer
from test_torch_dp_step import RANK_ENV, rank_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(REPO, "tests")
WORLD = 2
BATCH = 8
CLASSES = 64
DTYPES = ("uint8", "float32")


def _argv(tmp: str) -> list[str]:
    return [
        "--debug", "true", "--debug-sample-size", "32", "--num-classes", str(CLASSES),
        "--image-size", "64", "--batch-size", str(BATCH), "--num-epochs", "1",
        "--compute-dtype", "float32", "--input-dtype", "uint8", "--fused-stem", "true",
        "--drop-remainder", "true", "--device-cache", "true", "--loader-workers", "2",
        "--log-every-steps", "1", "--optimizer", "sgd",
        "--test-csv", os.path.join(REPO, "data", "test_sample.csv"),
        "--checkpoint-dir", os.path.join(tmp, "ckpt"),
        "--log-file", os.path.join(tmp, "training.log"),
        "--metrics-file", os.path.join(tmp, "metrics.jsonl"),
    ]


def _walk(cfg: Config, n: int):
    """Epoch 0's index batches, the tail included."""
    return list(trainer.cached_index_batches(cfg, n, BATCH, 0, -(-n // BATCH)))


def cache_worker(payload: dict) -> dict:
    """One rank: its cache rows and gathered slices in each dtype, then the
    trainer's CLI entry point with the device cache."""
    from mpi_pytorch_tpu_torch.train.step import _gather_batch

    cpu = torch.device("cpu")
    distributed.maybe_initialize_distributed(cpu)
    rank = distributed.rank()
    cfg = parse_config(payload["argv"])
    train_m, _ = load_manifests(cfg)
    rows, gathered = {}, {}
    for dtype in DTYPES:
        c = dataclasses.replace(cfg, input_dtype=dtype)
        loader = trainer.make_loader(c, train_m, train=True)
        dataset, labels = trainer.build_device_cache(c, train_m, loader, cpu)
        rows[dtype] = dataset.numpy().copy()
        gathered[dtype] = [
            tuple(t.numpy().copy() for t in _gather_batch(
                dataset, labels, torch.from_numpy(i), torch.from_numpy(v), torch.float32))
            for i, v in _walk(c, len(train_m))
        ]
    summary = trainer.main(payload["argv"])
    return {"rank": rank, "rows": rows, "gathered": gathered,
            "summary": dataclasses.asdict(summary)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp_cache"))
    ranks = run_world("test_torch_dp_device_cache:cache_worker", WORLD, {"argv": _argv(tmp)},
                      timeout_s=120, env=RANK_ENV, pythonpath=[HERE])
    return tmp, sorted(ranks, key=lambda r: r["rank"])


@functools.lru_cache(maxsize=None)
def _jax_mesh():
    import jax

    from mpi_pytorch_tpu.config import MeshConfig
    from mpi_pytorch_tpu.parallel import create_mesh

    return create_mesh(MeshConfig(), devices=jax.devices()[:WORLD])


def _jax_cache(tmp: str, dtype: str):
    from mpi_pytorch_tpu import config as jax_config
    from mpi_pytorch_tpu.data import pipeline as jax_pipeline
    from mpi_pytorch_tpu.train import trainer as jax_trainer

    cfg = parse_config(_argv(tmp))
    train_m, _ = load_manifests(cfg)
    loader = jax_pipeline.DataLoader(
        train_m, batch_size=BATCH // WORLD, image_size=cfg.image_size, shuffle=True, seed=0,
        drop_remainder=True, synthetic=True, num_workers=2, image_dtype=dtype)
    return cfg, train_m, jax_trainer.build_device_cache(
        jax_config.Config(), train_m, loader, _jax_mesh())


@pytest.mark.parametrize("dtype", DTYPES)
def test_rank_rows_and_gathered_slices_match_jax(run, dtype):
    import jax.numpy as jnp

    from mpi_pytorch_tpu.train.step import _gather_batch as jax_gather_batch

    tmp, ranks = run
    cfg, train_m, (ref_rows, ref_labels) = _jax_cache(tmp, dtype)
    per = -(-len(train_m) // WORLD)
    assert per == 13 and ref_rows.shape[0] == per * WORLD
    shards = sorted(ref_rows.addressable_shards, key=lambda s: s.index[0].start or 0)
    for r, shard in zip(ranks, shards):
        assert r["rows"][dtype].shape == (per, 64, 64, 3)
        assert r["rows"][dtype].tobytes() == np.asarray(shard.data).tobytes()
    assert not ranks[1]["rows"][dtype][-1].any()  # the padding row
    walk = _walk(cfg, len(train_m))
    assert len(walk) == 4
    for step, (idx, valid) in enumerate(walk):
        want_x, want_y = jax_gather_batch(_jax_mesh(), jnp.float32, ref_rows, ref_labels,
                                          idx, valid)
        want_x, want_y = np.asarray(want_x), np.asarray(want_y)
        for r in ranks:
            mine = slice(r["rank"] * BATCH // WORLD, (r["rank"] + 1) * BATCH // WORLD)
            got_x, got_y = r["gathered"][dtype][step]
            assert got_x.dtype == np.float32 and got_x.shape == (BATCH // WORLD, 64, 64, 3)
            assert got_x.tobytes() == want_x[mine].tobytes(), (step, r["rank"])
            np.testing.assert_array_equal(got_y, want_y[mine])
    # The tail: one real row, on rank 0.
    tail = [r["gathered"][dtype][3][1] for r in ranks]
    assert tail[0][0] >= 0 and (tail[0][1:] == -1).all() and (tail[1] == -1).all()


def test_loss_trajectory_matches_jax_cached_step_and_one_process(run, monkeypatch):
    import jax
    import jax.numpy as jnp

    from mpi_pytorch_tpu.models.resnet import resnet18 as jax_resnet18
    from mpi_pytorch_tpu.train.state import TrainState as JaxTrainState
    from mpi_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
    from mpi_pytorch_tpu.train.step import make_cached_train_step as jax_cached_step
    from mpi_pytorch_tpu.train.step import place_state_on_mesh
    from mpi_pytorch_tpu_torch.models.convert import to_flax_variables
    from mpi_pytorch_tpu_torch.models.registry import create_model_bundle

    tmp, ranks = run
    got = ranks[0]["summary"]["step_losses"]
    assert len(got) == 3 and ranks[1]["summary"]["step_losses"] == got
    monkeypatch.setenv("MPT_STEM_INTERPRET", "1")
    cfg, train_m, (ref_rows, ref_labels) = _jax_cache(tmp, "uint8")
    mesh = _jax_mesh()
    bundle = create_model_bundle("resnet18", CLASSES, seed=0, fused_stem=True)
    state = place_state_on_mesh(JaxTrainState.create(
        apply_fn=jax_resnet18(CLASSES, dtype=jnp.float32, fused_stem=True, dp_mesh=mesh).apply,
        variables=jax.tree_util.tree_map(
            jnp.asarray, to_flax_variables(bundle.model.state_dict(), "resnet18")),
        tx=jax_make_optimizer(4e-4, optimizer="sgd"), rng=jax.random.PRNGKey(1),
    ), mesh)
    step = jax_cached_step(mesh, jnp.float32)
    want = []
    for idx, valid in _walk(cfg, len(train_m))[:3]:
        state, m = step(state, ref_rows, ref_labels, idx, valid)
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)

    one_dir = os.path.join(tmp, "one")
    with rank_threads():
        one = trainer.train(parse_config(_argv(one_dir)), device="cpu")
    np.testing.assert_allclose(got, one.step_losses, rtol=1e-4)


def test_validation_from_the_cache_matches_one_process(run):
    from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training

    tmp, ranks = run
    cfg = parse_config(_argv(tmp))
    with open(cfg.log_file) as f:
        log = f.read()
    assert "device cache: 25 images, rows sharded over 2 rank(s) (0.2 MB/rank uint8)" in log
    model = prepare_for_training(
        create_model_bundle("resnet18", CLASSES, seed=0, fused_stem=True).model,
        torch.device("cpu"))
    model.load_state_dict(ckpt.load_for_eval(ckpt.latest_checkpoint(cfg.checkpoint_dir))[0])
    train_m, _ = load_manifests(cfg)
    with rank_threads():
        acc, loss = trainer.evaluate_manifest(cfg, model, train_m)
    for r in ranks:
        assert r["summary"]["val_accuracy"] == acc
    with open(cfg.metrics_file) as f:
        (val,) = [r for r in map(json.loads, f) if r["kind"] == "val"]
    np.testing.assert_allclose(val["loss"], loss, rtol=1e-6)
