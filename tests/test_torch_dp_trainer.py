"""The port's trainer on two gloo ranks against the JAX package, on the CPU.

``python -m mpi_pytorch_tpu_torch.train``'s ``main`` runs in each rank of
a two-rank world (``parallel.launch.run_world``, torchrun's environment,
120 s): resnet18 at 64 px (64 px for the reason ``tests/test_torch_dp_step.py``
gives), the fused stem, f32, SGD with momentum at 4e-4, global batch 8 (4 rows a rank),
``drop_remainder`` off, one epoch, validation on the train split. The DEBUG
sample of 32 rows has 25 train rows over 32 classes (a 64-wide head, the
contiguous label remap), so the ranks' shards hold 13 and 12 rows: four
steps, the fourth with 1 valid row on rank 0 and a filler batch (every
label −1) on rank 1.

Held against the JAX package:

- the step count is JAX ``global_step_count`` with two processes, for the
  run's and other shapes;
- each rank's ``synchronized_batches`` are byte-identical to the JAX ones
  over the same shard (the JAX ``DataLoader`` over the port's manifest);
- the run's four global-mean losses match the JAX auto step on a
  two-device mesh fed the rank-major concatenation of those batches, and
  the port's own one-process step on them: rtol 1e-4
  (``tests/test_torch_train_step.py``'s tolerance), but for the JAX
  loss of the fourth step, rtol 5e-4: that loss is one row's, with no
  mean over rows to damp the f32 rounding three steps have carried, and
  the one-process port already sits 1.1e-4 from JAX there (the two-rank
  port 2.0e-6 from the one-process one). The one-process steps run at
  the ranks' thread count (``rank_threads``): the CPU convolutions'
  backward splits its sums by thread, and at the 8 threads of an 8-core
  host against the ranks' 2 the fourth losses drift 1.6e-4 apart. SGD,
  as ``tests/test_parallel.py``'s equivalence tests: with Adam that step
  drifts by 3e-4 between any two of the three, as m/√v turns f32
  summation order on near-zero gradients into ±lr steps.

And of the port itself: only rank 0 writes checkpoint files (each rank
counts its writes) and the metrics file holds each record once; the
sharded validation accuracy equals one process's evaluation of the saved
checkpoint on the whole split (at the ranks' thread count), and its mean
loss rtol 1e-6 (the sums of two shards against one).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import Config
from mpi_pytorch_tpu_torch.data.manifest import load_manifests
from mpi_pytorch_tpu_torch.parallel import distributed
from mpi_pytorch_tpu_torch.parallel.launch import run_world
from mpi_pytorch_tpu_torch.train import trainer
from test_torch_dp_step import RANK_ENV, rank_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(REPO, "tests")
WORLD = 2
SHAPES = ((25, 4, False), (25, 4, True), (100, 16, False), (96, 16, True), (7, 2, False))


def _argv(tmp: str) -> list[str]:
    return [
        "--debug", "true", "--debug-sample-size", "32", "--num-classes", "64",
        "--image-size", "64", "--batch-size", "8", "--num-epochs", "1",
        "--compute-dtype", "float32", "--input-dtype", "uint8", "--fused-stem", "true",
        "--drop-remainder", "false", "--loader-workers", "2", "--log-every-steps", "1",
        "--keep-checkpoints", "2", "--optimizer", "sgd",
        "--test-csv", os.path.join(REPO, "data", "test_sample.csv"),
        "--checkpoint-dir", os.path.join(tmp, "ckpt"),
        "--log-file", os.path.join(tmp, "training.log"),
        "--metrics-file", os.path.join(tmp, "metrics.jsonl"),
    ]


def trainer_worker(payload: dict) -> dict:
    """One rank: its shard's synchronized batches and the step counts in
    the world, then the CLI entry point, counting this rank's checkpoint
    writes."""
    from mpi_pytorch_tpu_torch.config import parse_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.maybe_initialize_distributed(torch.device("cpu"))
    cfg = parse_config(payload["argv"])
    train_m, _ = load_manifests(cfg)
    shard = train_m.shard(distributed.world_size(), distributed.rank())
    loader = trainer.make_loader(cfg, shard, train=True)
    n_steps = trainer.global_step_count(len(train_m), loader.batch_size, cfg.drop_remainder)
    batches = list(trainer.synchronized_batches(loader, 0, n_steps))
    counts = [trainer.global_step_count(n, b, d) for n, b, d in SHAPES]
    writes = []
    real = ckpt._write

    def counted(*args, **kw):
        writes.append(os.path.basename(args[1]))
        return real(*args, **kw)

    ckpt._write = counted
    summary = trainer.main(payload["argv"])
    return {"rank": int(os.environ["RANK"]), "batches": batches, "n_steps": n_steps,
            "counts": counts, "writes": writes, "summary": dataclasses.asdict(summary)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp_train"))
    ranks = run_world("test_torch_dp_trainer:trainer_worker", WORLD, {"argv": _argv(tmp)},
                      timeout_s=120, env=RANK_ENV, pythonpath=[HERE])
    return tmp, ranks


def test_step_counts_match_jax(run, monkeypatch):
    import jax

    from mpi_pytorch_tpu.train import trainer as jax_trainer

    _, ranks = run
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    want = [jax_trainer.global_step_count(n, b, d) for n, b, d in SHAPES]
    assert [r["counts"] for r in ranks] == [want, want]
    assert [r["n_steps"] for r in ranks] == [4, 4] == [want[0]] * 2


def test_synchronized_batches_match_jax(run):
    from mpi_pytorch_tpu.data import pipeline as jax_pipeline
    from mpi_pytorch_tpu.train import trainer as jax_trainer
    from mpi_pytorch_tpu_torch.config import parse_config

    tmp, ranks = run
    cfg = parse_config(_argv(tmp))
    train_m, _ = load_manifests(cfg)
    for r in ranks:
        ref = jax_pipeline.DataLoader(
            train_m.shard(WORLD, r["rank"]), batch_size=4, image_size=cfg.image_size,
            shuffle=True, seed=0, drop_remainder=False, synthetic=True, num_workers=2,
            image_dtype="uint8",
        )
        want = list(jax_trainer.synchronized_batches(ref, 0, r["n_steps"]))
        assert len(r["batches"]) == len(want) == 4
        for (gi, gl), (wi, wl) in zip(r["batches"], want):
            assert gi.dtype == wi.dtype and gi.tobytes() == wi.tobytes()
            np.testing.assert_array_equal(gl, wl)
    filler = ranks[1]["batches"][3]
    assert (filler[1] == -1).all() and filler[0].tobytes() == ranks[1]["batches"][2][0].tobytes()


def test_loss_trajectory_matches_jax_auto_step(run, monkeypatch):
    import jax
    import jax.numpy as jnp

    from mpi_pytorch_tpu.config import MeshConfig
    from mpi_pytorch_tpu.models.resnet import resnet18 as jax_resnet18
    from mpi_pytorch_tpu.parallel import create_mesh, shard_batch
    from mpi_pytorch_tpu.train.state import TrainState as JaxTrainState
    from mpi_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
    from mpi_pytorch_tpu.train.step import make_train_step as jax_make_train_step
    from mpi_pytorch_tpu.train.trainer import pad_batch as jax_pad_batch
    from mpi_pytorch_tpu.train.step import place_state_on_mesh
    from mpi_pytorch_tpu_torch.models.convert import to_flax_variables
    from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training
    from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer
    from mpi_pytorch_tpu_torch.train.step import make_train_step

    _, ranks = run
    monkeypatch.setenv("MPT_STEM_INTERPRET", "1")
    mesh = create_mesh(MeshConfig(), devices=jax.devices()[:WORLD])
    bundle = create_model_bundle("resnet18", 64, seed=0, fused_stem=True)
    state = JaxTrainState.create(
        apply_fn=jax_resnet18(64, dtype=jnp.float32, fused_stem=True, dp_mesh=mesh).apply,
        variables=jax.tree_util.tree_map(
            jnp.asarray, to_flax_variables(bundle.model.state_dict(), "resnet18")),
        tx=jax_make_optimizer(4e-4, optimizer="sgd"), rng=jax.random.PRNGKey(1),
    )
    state = place_state_on_mesh(state, mesh)
    step = jax_make_train_step(jnp.float32)
    model = prepare_for_training(bundle.model, torch.device("cpu"))
    opt, schedule = make_optimizer(model, 4e-4, optimizer="sgd")
    one = TrainState(model=model, optimizer=opt, schedule=schedule)
    one_step = make_train_step(torch.float32)
    want, one_process = [], []
    for i in range(4):
        padded = [jax_pad_batch(*r["batches"][i], 4) for r in ranks]
        images = np.concatenate([p[0] for p in padded])
        labels = np.concatenate([p[1] for p in padded])
        state, m = step(state, shard_batch((images, labels), mesh))
        want.append(float(m["loss"]))
        with rank_threads():
            m = one_step(one, torch.from_numpy(images), torch.from_numpy(labels))
        one_process.append(float(m["loss"]))
    got = ranks[0]["summary"]["step_losses"]
    np.testing.assert_allclose(got, one_process, rtol=1e-4)
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=5e-4)
    assert ranks[0]["summary"]["step_losses"] == ranks[1]["summary"]["step_losses"]


def test_rank0_writes_and_validation_matches_one_process(run):
    from mpi_pytorch_tpu_torch.config import parse_config
    from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training

    tmp, ranks = run
    assert ranks[0]["writes"] == ["ckpt_00000.pt"] and ranks[1]["writes"] == []
    cfg = parse_config(_argv(tmp))
    assert [os.path.basename(p) for p in ckpt.checkpoint_paths(cfg.checkpoint_dir)] == [
        "ckpt_00000.pt"]
    with open(cfg.metrics_file) as f:
        records = [json.loads(line) for line in f]
    assert [r["kind"] for r in records] == ["step"] * 4 + ["epoch", "val"]
    with open(cfg.log_file) as f:
        log = f.read()
    assert "MPT_R0" in log and "MPT_R1" not in log and "world 2 (process group backend gloo)" in log

    # One process, the saved weights, the whole train split.
    model = prepare_for_training(create_model_bundle("resnet18", 64, seed=0, fused_stem=True)
                                 .model, torch.device("cpu"))
    model.load_state_dict(ckpt.load_for_eval(ckpt.latest_checkpoint(cfg.checkpoint_dir))[0])
    train_m, _ = load_manifests(cfg)
    with rank_threads():
        acc, loss = trainer.evaluate_manifest(cfg, model, train_m)
    for r in ranks:
        assert r["summary"]["val_accuracy"] == acc
    np.testing.assert_allclose(records[-1]["loss"], loss, rtol=1e-6)
