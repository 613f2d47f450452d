"""The hierarchical gradient sync (``--mesh-pods``) on four gloo ranks laid
out as two pods of two, against the JAX package's nested mesh, on the CPU,
in f32.

resnet18 at 64 px with the fused stem and a 10-class head, as
``tests/test_torch_grad_sync.py`` (whose helpers this file uses), global
batch 16 — 4 rows a rank, so each rank's last batchnorm still normalizes
16 values a channel, as the two-rank tests' do — and two steps, the first
the uneven tail (3, 1, 4 and 2 valid rows). The JAX side is
``make_spmd_train_step`` on ``create_mesh(MeshConfig(pods=2),
devices=jax.devices()[:4])``.

Two levers, each with SGD and with Adam: the hierarchical sync alone
(three phases a tensor: ici reduce-scatter, pod all-reduce, ici
all-gather), and the hierarchical sync with ZeRO and 1 MiB buckets (an ici
reduce-scatter and a pod all-reduce a bucket, the parameters all-gathered
within the pod). Held:

- against JAX, with the tolerances and the rule of
  ``tests/test_torch_grad_sync.py``: the metrics of both steps (of step 1
  with Adam, and step 2's count), the step-1 grad norm, after step 1 the
  running statistics, and with SGD the parameters;
- the hierarchical sync with ZeRO and buckets against it alone, with each
  optimizer: parameters, moments and statistics after both steps rtol
  1e-6 plus atol 1e-7, the grad norms rtol 1e-6 (measured: 0);
- the ledger's ici and dcn bytes of one step equal the JAX ``LEDGER``'s;
  the dcn bytes carry exactly 1/ici of the payload a flat four-rank step
  all-reduces (and at most 1/ici of its bytes, as
  ``tests/test_hierarchical.py`` bounds it); nothing but the pod
  all-reduce crosses pods;
- against the port's flat four-rank step (same ranks, same batches):
  parameters and statistics after both steps rtol 1e-5 plus atol 1e-6 —
  the two layouts sum four ranks' gradients in different orders (measured:
  4.8e-7 apart at most, the losses equal);
- rank ``p·2 + i`` holds ZeRO slice ``i``: its moment slices are those of
  the unsharded moments, bit-identical across the pods;
- the hierarchical ZeRO run's checkpoint (moments in 2 shards) loads into
  a flat four-rank ZeRO run (4 shards) and gathers back to the same file;
- ``python -m mpi_pytorch_tpu_torch.train --spmd-mode true --mesh-pods 2``
  on the four ranks: two steps, the nested layout in the log.

Every case runs in ONE four-rank world (``run_world``, a module fixture).
"""

import functools
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import MeshConfig
from mpi_pytorch_tpu_torch.parallel import collectives, distributed
from mpi_pytorch_tpu_torch.parallel.launch import run_world
from mpi_pytorch_tpu_torch.parallel.mesh import create_mesh, pod_shape, zero_shard_axis
from mpi_pytorch_tpu_torch.train import trainer
from mpi_pytorch_tpu_torch.train.state import owned_slice
from test_torch_dp_step import RANK_ENV
from test_torch_grad_sync import (
    NUM_CLASSES,
    _digest,
    _jax_steps,
    _moments,
    assert_metrics_match_jax,
    assert_state_matches_jax,
    lever_state,
    run_lever,
)

WORLD, PODS, ICI = 4, 2, 2
BATCH = 16
SIZE = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(REPO, "tests")
# One rank a thread: four ranks and the suite's workers share the cores.
ENV = {**RANK_ENV, "OMP_NUM_THREADS": "1"}
LEVERS = {"hier": (False, 0.0), "hier_zero_buckets": (True, 1.0)}
OPTIMIZERS = ("sgd", "adam")


def _batches():
    rng = np.random.default_rng(12)
    out = []
    for valid in ((3, 1, 4, 2), (4, 4, 4, 3)):
        images = rng.integers(0, 256, size=(BATCH, SIZE, SIZE, 3)).astype(np.uint8)
        labels = rng.integers(0, NUM_CLASSES, size=(BATCH,)).astype(np.int32)
        rows = BATCH // WORLD
        for r, n in enumerate(valid):
            labels[r * rows + n:(r + 1) * rows] = -1
        out.append((images, labels))
    return out


def hier_worker(payload: dict) -> dict:
    """One rank: the flat four-rank baseline, each lever × optimizer on the
    2 × 2 layout, the checkpoint across layouts, then the CLI (which
    leaves the world)."""
    distributed.maybe_initialize_distributed(torch.device("cpu"))
    rank = distributed.rank()
    rows = slice(rank * BATCH // WORLD, (rank + 1) * BATCH // WORLD)
    flat, nested = create_mesh(MeshConfig()), create_mesh(MeshConfig(pods=PODS))
    steps = _batches()
    out = {"rank": rank, "runs": {}, "layout": [(a.name, a.size, a.index) for a in nested.axes]}
    for name, mesh, optimizer, (zero, bucket_mb) in [
        ("flat-sgd", flat, "sgd", (False, 0.0)),
        *[(f"{lever}-{o}", nested, o, LEVERS[lever]) for lever in LEVERS for o in OPTIMIZERS],
    ]:
        run = run_lever(optimizer, zero, bucket_mb, mesh, rows, steps)
        state = run.pop("state")
        if name == "hier_zero_buckets-adam":
            directory = os.path.join(payload["tmp"], "hier_zero")
            ckpt.save_checkpoint(directory, epoch=0, state=state, loss=1.0)
            other = lever_state("adam", True, flat)
            ckpt.restore_checkpoint(ckpt.latest_checkpoint(directory), other)
            out["reloaded_flat_zero"] = _moments(other.optimizer)
            out["flat_zero_shards"] = zero_shard_axis(flat)[1]
        del state
        run["digests"] = [_digest(s) for s in run["states"]]
        run["moments_digest"] = _digest(run["moments"])
        if rank:
            del run["states"], run["moments"]
        out["runs"][name] = run
    argv = [*payload["argv"], "--checkpoint-dir", os.path.join(payload["tmp"], "cli", "ckpt"),
            "--log-file", os.path.join(payload["tmp"], "cli", "training.log"),
            "--metrics-file", os.path.join(payload["tmp"], "cli", "metrics.jsonl")]
    out["cli"] = trainer.main(argv).step_losses
    return out


def cli_argv() -> list[str]:
    """Two steps of 8 rows (2 a rank) over the DEBUG sample's 16 train
    rows, one checkpoint."""
    return [
        "--debug", "true", "--debug-sample-size", "20", "--num-classes", "64",
        "--image-size", "64", "--batch-size", "8", "--num-epochs", "1",
        "--compute-dtype", "float32", "--fused-stem", "true", "--optimizer", "sgd",
        "--spmd-mode", "true", "--mesh-pods", "2", "--validate", "false",
        "--loader-workers", "1", "--log-every-steps", "1",
        "--train-csv", os.path.join(REPO, "data", "train_sample.csv"),
        "--test-csv", os.path.join(REPO, "data", "test_sample.csv"),
    ]


@pytest.fixture(scope="module")
def world():
    with tempfile.TemporaryDirectory(prefix="mpt_hier_") as tmp:
        ranks = run_world("test_torch_hierarchical:hier_worker", WORLD,
                          {"tmp": tmp, "argv": cli_argv()}, timeout_s=300, env=ENV,
                          pythonpath=[HERE])
        ranks[0]["tmp"] = tmp
        yield ranks


@functools.lru_cache(maxsize=None)
def jax_run(lever: str, optimizer: str) -> dict:
    import jax

    from mpi_pytorch_tpu.config import MeshConfig as JaxMeshConfig
    from mpi_pytorch_tpu.parallel import create_mesh as jax_create_mesh

    zero, bucket_mb = LEVERS[lever]
    mesh = jax_create_mesh(JaxMeshConfig(pods=PODS), devices=jax.devices()[:WORLD])
    return _jax_steps(mesh, optimizer, zero, bucket_mb, _batches())


def test_the_layout_is_pod_major(world):
    for r in world:
        p, i = divmod(r["rank"], ICI)
        assert r["layout"] == [("pod", PODS, p), ("ici", ICI, i)]


CASES = [f"{lever}-{o}" for lever in LEVERS for o in OPTIMIZERS]


@pytest.mark.parametrize("case", CASES)
def test_four_ranks_match_jax_nested_mesh(world, case):
    lever, optimizer = case.split("-")
    got = world[0]["runs"][case]
    for r in world[1:]:  # every rank ends with the same metrics and state
        assert r["runs"][case]["metrics"] == got["metrics"]
        assert r["runs"][case]["digests"] == got["digests"]
        assert r["runs"][case]["moments_digest"] == got["moments_digest"]
    ref = jax_run(lever, optimizer)
    assert_metrics_match_jax(got["metrics"], ref["metrics"], case,
                             None if optimizer == "sgd" else 1)
    assert [m["count"] for m in got["metrics"]] == [10, 15]
    assert_state_matches_jax(got["states"][0], ref["tree"], f"{case} step 1",
                             ("params", "batch_stats") if optimizer == "sgd" else ("batch_stats",))


@pytest.mark.parametrize("lever", list(LEVERS))
def test_ledger_bytes_match_jax(world, lever):
    got = world[0]["runs"][f"{lever}-sgd"]["ledger"]
    ref = jax_run(lever, "sgd")["ledger"]
    assert {k: got[k]["bytes"] for k in ("ici", "dcn")} == {
        k: ref[k]["bytes"] for k in ("ici", "dcn")}
    assert got["ici"]["by_op"] == ref["ici"]["by_op"]
    assert got["dcn"]["by_op"] == ref["dcn"]["by_op"]


@pytest.mark.parametrize("lever", list(LEVERS))
def test_dcn_carries_one_ici_th_of_the_flat_payload(world, lever):
    """The cross-pod bytes are the pod all-reduce of 1/ici of what a flat
    four-rank step all-reduces (gradients and statistics; ring factors
    2(P-1)/P of each), so at most 1/ici of its bytes; no all-gather or
    reduce-scatter crosses pods."""
    flat = world[0]["runs"]["flat-sgd"]["ledger"]
    got = world[0]["runs"][f"{lever}-sgd"]["ledger"]
    assert flat["dcn"]["bytes"] == 0
    flat_bytes = flat["ici"]["by_op"]["all_reduce"]
    flat_payload = flat_bytes / (2 * (WORLD - 1) / WORLD)
    dcn = got["dcn"]["bytes"]
    assert dcn / (2 * (PODS - 1) / PODS) == flat_payload / ICI
    assert 0 < dcn <= flat_bytes / ICI
    assert set(got["dcn"]["by_op"]) == {"all_reduce"}


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_zero_and_buckets_match_the_hierarchical_baseline(world, optimizer):
    base = world[0]["runs"][f"hier-{optimizer}"]
    got = world[0]["runs"][f"hier_zero_buckets-{optimizer}"]
    for a, b in zip(got["metrics"], base["metrics"]):
        assert (a["loss"], a["correct"], a["count"]) == (b["loss"], b["correct"], b["count"])
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-6, atol=0)
    for i, (a, b) in enumerate(zip(got["states"], base["states"])):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i + 1} {k}")
    assert got["moments"].keys() == base["moments"].keys()
    for k, v in base["moments"].items():
        np.testing.assert_allclose(got["moments"][k], v, rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("lever", list(LEVERS))
def test_hierarchical_matches_the_flat_four_rank_step(world, lever):
    flat, got = world[0]["runs"]["flat-sgd"], world[0]["runs"][f"{lever}-sgd"]
    for a, b in zip(got["metrics"], flat["metrics"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    for i, (a, b) in enumerate(zip(got["states"], flat["states"])):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i + 1} {k}")


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_rank_p_ici_plus_i_holds_slice_i(world, optimizer):
    """Each rank's own moment slices are slice ``i`` (its ici position) of
    the gathered moments, and the two pods' ranks at one ici position hold
    the same bits."""
    case = f"hier_zero_buckets-{optimizer}"
    full = world[0]["runs"][case]["moments"]
    for r in world:
        _, i = divmod(r["rank"], ICI)
        local = r["runs"][case]["local_moments"]
        assert local.keys() == {k for k, v in full.items() if v.ndim > 0}
        for k, v in local.items():
            np.testing.assert_array_equal(v, owned_slice(torch.from_numpy(full[k]), ICI, i).numpy(),
                                          err_msg=f"rank {r['rank']} {k}")
            twin = world[(r["rank"] + ICI) % WORLD]["runs"][case]["local_moments"][k]
            assert v.tobytes() == twin.tobytes()
    sizes = {k: v.size for k, v in full.items() if v.ndim > 0}
    got = world[0]["runs"][case]["moment_numel"]
    assert got == sum(-(-n // ICI) for n in sizes.values())


def test_a_checkpoint_crosses_layouts(world):
    """The 2 × 2 ZeRO run's file (moments in 2 shards over ici) loads into a
    flat four-rank ZeRO optimizer (4 shards) and gathers back to the
    moments it was written from."""
    assert world[0]["flat_zero_shards"] == 4
    written = world[0]["runs"]["hier_zero_buckets-adam"]["moments"]
    for r in world:
        got = r["reloaded_flat_zero"]
        assert got.keys() == written.keys()
        for k, v in written.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_the_cli_runs_two_pods(world):
    tmp = world[0]["tmp"]
    losses = [r["cli"] for r in world]
    assert all(len(v) == 2 and v == losses[0] for v in losses) and np.isfinite(losses[0]).all()
    with open(os.path.join(tmp, "cli", "training.log")) as f:
        log = f.read()
    assert "spmd mode, pod 2 × ici 2" in log and "hierarchical sync (2 pod(s) × 2 ici)" in log
    with open(os.path.join(tmp, "cli", "metrics.jsonl")) as f:
        (sync,) = [r for r in map(json.loads, f) if r["kind"] == "grad_sync"]
    assert sync["dcn_by_op"].keys() == {"all_reduce"} and sync["dcn_bytes_per_step"] > 0
    # The checkpoint and its topology sidecar.
    assert sorted(os.listdir(os.path.join(tmp, "cli", "ckpt"))) == [
        "ckpt_00000.pt", "ckpt_00000.pt.manifest.json"]


def test_layout_helpers_on_one_process():
    """A world of one is the flat layout of one rank: no group, ZeRO over
    one shard, one pod."""
    mesh = create_mesh()
    assert mesh.axis_names == ("data",) and pod_shape(mesh) == (1, 1)
    axis, n = zero_shard_axis(mesh)
    assert (axis.name, n, axis.group) == ("data", 1, None)
    with pytest.raises(ValueError, match="not divisible by pods=2"):
        create_mesh(MeshConfig(pods=2))
    collectives.LEDGER.reset()
