"""The port's data-parallel train step on two gloo ranks against the JAX
package's step on a two-device mesh, on the CPU, in f32.

resnet18 at 64 px with a 10-class head, global batch 8 (4 rows a rank),
SGD with momentum at 4e-4 (``make_optimizer(..., "sgd")`` on both sides), two
steps from the port's seeded init carried into the JAX tree by
``to_flax_variables``:

- step 1: a tail batch, rank 0 with 3 valid rows and rank 1 with 1, where
  auto mode (count-weighted global mean) and spmd mode (the unweighted
  mean over ranks of each rank's local mean) give different gradients;
- step 2: every row valid but the last (rank 1 holds 3 valid rows).

The port ranks are real processes (``parallel.launch.run_world``, 120 s a
world); the JAX side is ``create_mesh(MeshConfig(), devices=jax.devices()
[:2])``, ``place_state_on_mesh`` and ``shard_batch``, as
``tests/test_parallel.py`` drives it, with the fused stem's Pallas pair in
interpret mode.

The cases: auto mode with the fused stem on and off (JAX
``make_train_step`` on the mesh), and spmd mode with the plain stem, with
and without ``sync_batchnorm`` (JAX ``make_spmd_train_step``). Each step's
loss, ``correct`` and ``count``, and the step-1 grad norm: rtol 1e-4; after
step 1 (the uneven batch), every running statistic rtol 1e-5 plus atol
1e-6: the tolerances of ``tests/test_torch_train_step.py``, which holds the
state after the first step only (later steps amplify f32 noise through
the batchnorm backward). Every parameter after step 1: rtol 1e-5 plus
atol 2e-6, not that test's 1e-7: on this step-1 batch the two packages'
ONE-process steps already differ by 1.4e-6 on ``conv1`` (the deepest
gradient, summed through 18 batchnorm backwards in other f32 orders; the
batchnorm scales' small, cancelling gradients differ by up to 0.4 %
norm-wise), while the two-device JAX step sits 7e-9 from the one-device
one and the two-rank port step 7e-9 from the one-process one. In auto
mode the two-rank port step is also held against the port's one-process
step on the concatenated batches after both steps, parameters rtol 1e-5
plus atol 2e-6 (9e-7 apart on ``conv1`` after step 2: two ranks' partial
sums against one sum) and statistics rtol 1e-5 plus atol 1e-6.

64 px, not 32, for the reason given in that test: at 32 px the last stage
is 1×1, its batchnorm normalizes 8 values a channel (4 a rank in spmd
mode), and the backward through statistics that few turns f32 summation
order into step-1 grad norms 3e-4 apart — between the one-process port and
the JAX mesh alike. Both ranks end bit-identical to each other in every
parameter and statistic (the same reduced gradients; spmd's averaged
statistics are one all-reduce's result).
"""

import contextlib
import functools
import os

import numpy as np
import pytest
import torch

from mpi_pytorch_tpu_torch.models.common import set_batchnorm_sync
from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training
from mpi_pytorch_tpu_torch.ops.losses import accuracy_count, classification_loss, valid_count
from mpi_pytorch_tpu_torch.parallel import distributed
from mpi_pytorch_tpu_torch.parallel.launch import run_world
from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer
from mpi_pytorch_tpu_torch.train.step import (
    grad_norm,
    ingest_images,
    make_spmd_train_step,
    make_train_step,
)

NUM_CLASSES = 10
SIZE = 64
BATCH = 8
WORLD = 2
LR = 4e-4
HERE = os.path.dirname(os.path.abspath(__file__))
# Two threads a rank: the ranks and the suite's workers share the cores.
RANK_ENV = {"MPT_PLATFORM": "cpu", "OMP_NUM_THREADS": "2"}
# One intra-op thread a test process, unless its environment sets the
# count (the ranks' ``RANK_ENV``, which import this file too). The suite
# runs its files on six xdist workers, and each worker imports every test
# file when it collects, so this line sets every worker's torch to one
# thread: torch's default, a thread a core in each of six workers (and in
# the ranks they start), oversubscribes the cores many times over, and its
# spinning OpenMP pool then slowed the port's files 2–100× (a module
# fixture of test_torch_device_cache.py: 8.3 s alone, 784 s in the suite).
# A one-process twin of a rank run still runs under ``rank_threads``.
if "OMP_NUM_THREADS" not in os.environ:
    torch.set_num_threads(1)


@contextlib.contextmanager
def rank_threads():
    """This process at the ranks' thread count (``RANK_ENV``), the previous
    count restored after: the CPU kernels split their sums by thread, so a
    one-process twin held against the ranks must sum in their order,
    whatever cores the machine has."""
    threads = torch.get_num_threads()
    torch.set_num_threads(int(RANK_ENV["OMP_NUM_THREADS"]))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _batches():
    rng = np.random.default_rng(11)
    out = []
    for valid in ((3, 1), (4, 3)):
        images = rng.integers(0, 256, size=(BATCH, SIZE, SIZE, 3)).astype(np.uint8)
        labels = rng.integers(0, NUM_CLASSES, size=(BATCH,)).astype(np.int32)
        for r, n in enumerate(valid):
            labels[r * 4 + n:(r + 1) * 4] = -1
        out.append((images, labels))
    return out


def _port_state(fused: bool) -> TrainState:
    bundle = create_model_bundle("resnet18", NUM_CLASSES, seed=0, fused_stem=fused)
    model = prepare_for_training(bundle.model, torch.device("cpu"))
    opt, schedule = make_optimizer(model, LR, optimizer="sgd")
    return TrainState(model=model, optimizer=opt, schedule=schedule)


def _numpy_state(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()
            if k != "num_batches_tracked" and not k.endswith(".num_batches_tracked")}


def port_step_worker(payload: dict) -> dict:
    """One rank: its rows of each batch through the port's step; the
    metrics of every step and the state after each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cpu")
    distributed.maybe_initialize_distributed(dev)
    rank, world = distributed.rank(), distributed.world_size()
    state = _port_state(payload["fused"])
    set_batchnorm_sync(state.model, payload["mode"] == "auto" or payload["sync_bn"])
    factory = make_spmd_train_step if payload["mode"] == "spmd" else make_train_step
    step = factory(torch.float32)
    rows = BATCH // world
    metrics, states = [], []
    for images, labels in _batches():
        sl = slice(rank * rows, (rank + 1) * rows)
        m = step(state, torch.from_numpy(images[sl]), torch.from_numpy(labels[sl]))
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_numpy_state(state.model))
    return {"rank": rank, "metrics": metrics, "states": states}


@functools.lru_cache(maxsize=None)
def _jax_run(mode: str, fused: bool, sync_bn: bool) -> dict:
    import jax
    import jax.numpy as jnp

    from mpi_pytorch_tpu.config import MeshConfig
    from mpi_pytorch_tpu.models.resnet import resnet18
    from mpi_pytorch_tpu.parallel import create_mesh, shard_batch
    from mpi_pytorch_tpu.train.state import TrainState as JaxTrainState
    from mpi_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
    from mpi_pytorch_tpu.train.step import (
        make_spmd_train_step as jax_spmd_step,
        make_train_step as jax_auto_step,
        place_state_on_mesh,
    )
    from mpi_pytorch_tpu_torch.models.convert import to_flax_variables

    mesh = create_mesh(MeshConfig(), devices=jax.devices()[:WORLD])
    model = resnet18(
        NUM_CLASSES, dtype=jnp.float32, fused_stem=fused, dp_mesh=mesh if fused else None,
        bn_axis_name="data" if (mode == "spmd" and sync_bn) else None,
    )
    variables = jax.tree_util.tree_map(
        jnp.asarray, to_flax_variables(_port_state(fused).model.state_dict(), "resnet18"))
    state = JaxTrainState.create(
        apply_fn=model.apply, variables=variables,
        tx=jax_make_optimizer(LR, optimizer="sgd"), rng=jax.random.PRNGKey(1),
    )
    state = place_state_on_mesh(state, mesh)
    step = jax_auto_step(jnp.float32) if mode == "auto" else jax_spmd_step(mesh, jnp.float32)
    metrics, trees = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPT_STEM_INTERPRET", "1")
        for images, labels in _batches():
            state, m = step(state, shard_batch((images, labels), mesh))
            metrics.append({k: float(v) for k, v in m.items()})
            trees.append({
                "params": jax.tree_util.tree_map(np.asarray, state.params),
                "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats),
            })
    return {"metrics": metrics, "trees": trees}


CASES = {
    "auto_fused": ("auto", True, False),
    "auto_plain": ("auto", False, False),
    "spmd_plain": ("spmd", False, False),
    "spmd_plain_sync_bn": ("spmd", False, True),
}


def _port_one_process(fused: bool) -> list[dict]:
    """The port's auto step in this process on the whole batches, at the
    ranks' thread count."""
    state = _port_state(fused)
    step = make_train_step(torch.float32)
    out = []
    with rank_threads():
        for images, labels in _batches():
            step(state, torch.from_numpy(images), torch.from_numpy(labels))
            out.append(_numpy_state(state.model))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_step_matches_jax_mesh(case):
    import jax

    from mpi_pytorch_tpu_torch.models.convert import to_flax_variables

    mode, fused, sync_bn = CASES[case]
    ranks = run_world(
        "test_torch_dp_step:port_step_worker", WORLD,
        {"mode": mode, "fused": fused, "sync_bn": sync_bn},
        timeout_s=120, env=RANK_ENV, pythonpath=[HERE],
    )
    ref = _jax_run(mode, fused, sync_bn)
    got = ranks[0]
    for r in ranks[1:]:  # every rank reports the same metrics and state
        assert r["metrics"] == got["metrics"]
        for a, b in zip(r["states"], got["states"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"rank {r['rank']} {k}")
    for key in ("loss", "correct", "count"):
        np.testing.assert_allclose([m[key] for m in got["metrics"]],
                                   [m[key] for m in ref["metrics"]], rtol=1e-4, err_msg=key)
    assert [m["count"] for m in got["metrics"]] == [4, 7]
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"], ref["metrics"][0]["grad_norm"],
                               rtol=1e-4)
    for i, (port_state, tree) in enumerate(zip(got["states"][:1], ref["trees"])):
        port_vars = to_flax_variables(
            {k: torch.from_numpy(v) for k, v in port_state.items()}, "resnet18")
        for key in ("params", "batch_stats"):
            for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(port_vars[key]),
                                    jax.tree_util.tree_leaves(tree[key])):
                np.testing.assert_allclose(
                    a, b, rtol=1e-5, atol=1e-6 if key == "batch_stats" else 2e-6,
                    err_msg=f"step {i + 1} {key}{jax.tree_util.keystr(path)}")
    if mode == "auto":
        for i, (two, one) in enumerate(zip(got["states"], _port_one_process(fused))):
            for k in one:
                atol = 1e-6 if "running" in k else 2e-6
                np.testing.assert_allclose(two[k], one[k], rtol=1e-5, atol=atol,
                                           err_msg=f"step {i + 1} {k}, one process")


def test_modes_differ_on_the_uneven_tail():
    """The tail batch's ranks hold 3 and 1 valid rows: auto mode's
    count-weighted gradient and spmd mode's unweighted mean over ranks are
    different numbers, so the cases above could not pass with one
    reduction in place of the other. Checked on the JAX side alone, on
    step 1 from the same state, with batchnorm over the global batch in
    both (auto mode's, and spmd mode's with ``sync_batchnorm``), so the
    reduction is all that differs: the grad norms differ by ten times the
    tolerance."""
    auto = _jax_run("auto", False, False)["metrics"][0]["grad_norm"]
    spmd = _jax_run("spmd", False, True)["metrics"][0]["grad_norm"]
    assert abs(auto / spmd - 1) > 1e-3


def _one_process_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor) -> dict:
    """The train step as it was before data parallelism, written out: the
    masked mean CE of the whole batch, its backward, the global grad norm
    and the optimizer update."""
    model = state.model
    model.train()
    model.zero_grad(set_to_none=True)
    logits = model(ingest_images(images, torch.float32).permute(0, 3, 1, 2))
    loss = classification_loss(logits, labels)
    loss.backward()
    metrics = {"loss": loss.detach(), "correct": accuracy_count(logits.detach(), labels),
               "count": valid_count(labels), "grad_norm": grad_norm(model)}
    state.set_learning_rate()
    state.optimizer.step()
    state.step += 1
    return metrics


def test_a_world_of_one_is_bitwise_the_one_process_step():
    """At world size 1 the data-parallel step computes what the step
    computed before data parallelism, bit for bit: a one-rank gloo world
    (a process group, as ``torchrun --nproc-per-node 1`` makes) running
    the auto step with the batchnorms set to sync gives the metrics and
    state of :func:`_one_process_step` in this process — every collective
    is the identity for one rank. This process runs with the rank's thread
    count, so the CPU kernels sum in the same order."""
    (one_rank,) = run_world(
        "test_torch_dp_step:port_step_worker", 1, {"mode": "auto", "fused": True, "sync_bn": False},
        timeout_s=120, env=RANK_ENV, pythonpath=[HERE],
    )
    with rank_threads():
        state = _port_state(True)
        for i, (images, labels) in enumerate(_batches()):
            m = _one_process_step(state, torch.from_numpy(images), torch.from_numpy(labels))
            assert {k: float(v) for k, v in m.items()} == one_rank["metrics"][i]
            for k, v in _numpy_state(state.model).items():
                assert v.tobytes() == one_rank["states"][i][k].tobytes(), (i, k)
