"""The spmd step's gradient-sync levers on two gloo ranks (a flat layout)
against the JAX package, on the CPU, in f32: ``--zero-opt-state``,
``--grad-sync-buckets`` and both, beside the baseline
(``make_spmd_train_step``, ``train/state.ZeroOptimizer``, ``GradBuckets``).

The conventions of ``tests/test_torch_dp_step.py``: resnet18 at 64 px with
the fused stem and a 10-class head, global batch 8 (4 rows a rank), the
port's seeded init carried into the JAX tree by ``to_flax_variables``, the
JAX fused stem's Pallas pair in interpret mode, and the same two batches
(step 1 the uneven tail: 3 and 1 valid rows). Each lever combination runs
two steps with SGD and two with Adam (as ``tests/test_grad_sync.py``
limits its resnet Adam check); the buckets are 1 MiB (22 of them).

- Against the JAX step (``make_spmd_train_step`` on a two-device mesh
  with the same lever): each step's loss, ``correct`` and ``count`` and
  the step-1 grad norm rtol 1e-4; after step 1 every running statistic
  rtol 1e-5 plus atol 1e-6, and with SGD every parameter rtol 1e-5 plus
  atol 2e-6 — the tolerances of ``tests/test_torch_dp_step.py``, for its
  reasons. With Adam only step 1 — its metrics, grad norm and
  statistics — and step 2's count are held against JAX. Adam's first
  update is lr·g/(|g|+ε), a ±lr step whose sign is the gradient's, so a
  gradient within f32 rounding of zero lands a whole 2·lr apart: 3 of
  ``layer2.0.conv1``'s 73 728 weights, 5e-4, on this data, lever or not.
  Its moments after step 1 (m = 0.1·g) would be held at a tolerance that
  the gradients do not meet: the stem batchnorm's bias gradient is a
  cancelling sum, 0.6 % (2-rank) to 6 % (4-rank,
  ``tests/test_torch_hierarchical.py``) apart between the packages —
  harmless to SGD's parameters (lr·g), which are held. Step 2, from
  Adam's step-1 parameters, moves with them: its loss sits 1.04e-4 from
  JAX's on four ranks. The Adam parameters, moments and every step's
  metrics are held against the port's own baseline below.
  The ledger's bytes of one step equal the JAX ``LEDGER``'s, kind by kind.
- Against the port's own baseline on the same ranks: parameters, moments
  and running statistics after both steps rtol 1e-6 plus atol 1e-7, the
  grad norms rtol 1e-6. The levers change which collective carries a sum
  of two terms (order-free) and slice elementwise updates, so 0 is what
  they differ by, and 0 is what was measured on this CPU.

Then what the levers promise of the state: each rank's moments are
exactly Σ 2·chunk elements (Adam), frozen parameters stay bit-identical,
a skipped bad step leaves the sliced state bit-identical,
every bucket is issued from a hook (each parameter's post-accumulate hook
fired once a step, the fused stem's and the batchnorm scales' too), and a
ZeRO run's checkpoint is an unsharded run's file: either loads into the
other with an equal state, and into a world of another size. The config's
refusals are the JAX ``validate_config``'s, word for word. One ``python -m
mpi_pytorch_tpu_torch.train`` run closes the world: two ranks,
``--spmd-mode true --zero-opt-state true --grad-sync-buckets 1``, two
steps and one checkpoint.

Every case runs in ONE two-rank world (``run_world``, a module fixture).
"""

import functools
import glob
import hashlib
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import Config, MeshConfig, parse_config
from mpi_pytorch_tpu_torch.models.common import set_batchnorm_sync
from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training
from mpi_pytorch_tpu_torch.parallel import collectives, distributed
from mpi_pytorch_tpu_torch.parallel.launch import run_world
from mpi_pytorch_tpu_torch.parallel.mesh import Axis, create_mesh, zero_shard_axis
from mpi_pytorch_tpu_torch.train import trainer
from mpi_pytorch_tpu_torch.train.state import (
    TrainState,
    ZeroOptimizer,
    make_optimizer,
    zero_shard_spec,
)
from mpi_pytorch_tpu_torch.train.step import (
    bucket_overlap_frac,
    grad_bucket_plan,
    hier_dcn_overlap_frac,
    make_spmd_train_step,
    synced_params,
)
from test_torch_dp_step import RANK_ENV, _batches, _numpy_state

NUM_CLASSES = 10
WORLD = 2
LR = 4e-4
BUCKET_MB = 1.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(REPO, "tests")
LEVERS = {
    "none": (False, 0.0),
    "zero": (True, 0.0),
    "buckets": (False, BUCKET_MB),
    "zero_buckets": (True, BUCKET_MB),
}
OPTIMIZERS = ("sgd", "adam")


def lever_state(optimizer: str, zero: bool, mesh, trainable_mask=None) -> TrainState:
    """resnet18 (fused stem, seed 0) for spmd mode: local batchnorm, the
    optimizer sharded over the mesh's ZeRO axis with ``zero``."""
    bundle = create_model_bundle("resnet18", NUM_CLASSES, seed=0, fused_stem=True)
    model = prepare_for_training(bundle.model, torch.device("cpu"))
    set_batchnorm_sync(model, False)
    opt, schedule = make_optimizer(model, LR, trainable_mask, optimizer=optimizer,
                                   zero_axis=zero_shard_axis(mesh)[0] if zero else None)
    return TrainState(model=model, optimizer=opt, schedule=schedule)


def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def _moments(opt) -> dict:
    """The unsharded optimizer state's tensors, ``"index.key"`` → numpy
    (a ZeRO optimizer's ``state_dict`` gathers: every rank calls it)."""
    return {f"{i}.{k}": v.detach().cpu().numpy().copy()
            for i, st in opt.state_dict()["state"].items() for k, v in st.items()
            if torch.is_tensor(v)}


def run_lever(optimizer: str, zero: bool, bucket_mb: float, mesh, rows: slice, steps: list,
              mask: dict | None = None) -> dict:
    """The steps of one lever on this rank's rows: metrics, the state after
    each step, the (gathered) moments after the last, this rank's own
    moment slices under ZeRO, the first step's
    ledger, the hook firings and the bucket timeline."""
    state = lever_state(optimizer, zero, mesh, mask)
    step = make_spmd_train_step(torch.float32, zero_opt_state=zero, grad_bucket_mb=bucket_mb,
                                mesh=mesh)
    fired = {}
    for name, p in state.model.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda _p, name=name: fired.__setitem__(name, fired.get(name, 0) + 1))
    out = {"metrics": [], "states": [], "fired": [], "timeline": []}
    for i, (images, labels) in enumerate(steps):
        fired.clear()
        collectives.LEDGER.reset()
        m = step(state, torch.from_numpy(images[rows]), torch.from_numpy(labels[rows]))
        if i == 0:
            out["ledger"] = collectives.LEDGER.snapshot()
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(_numpy_state(state.model))
        out["fired"].append(dict(fired))
        if step.grad_sync.buckets is not None:
            out["timeline"].append(step.grad_sync.buckets.timeline)
    out["moments"] = _moments(state.optimizer)
    out["moment_numel"] = sum(
        v.numel() for st in (state.optimizer.inner if zero else state.optimizer).state.values()
        for v in st.values() if torch.is_tensor(v) and v.dim() > 0)
    out["chunks"] = [zero_shard_spec(p.shape, mesh.axes[-1].size)[0]
                     for p in state.optimizer.params] if zero else None
    out["local_moments"] = {f"{i}.{k}": v.numpy().copy()
                            for i, st in state.optimizer.inner.state_dict()["state"].items()
                            for k, v in st.items() if v.dim() > 0} if zero else None
    out["state"] = state
    return out


def _checkpoint_cases(tmp: str, mesh, rows: slice, steps: list) -> dict:
    """A ZeRO run's checkpoint into an unsharded state and the reverse
    (Adam, two steps each), every rank restoring; the gathered states."""
    out = {}
    for name, zero in (("zero", True), ("unsharded", False)):
        run = run_lever("adam", zero, 0.0, mesh, rows, steps)
        directory = os.path.join(tmp, name)
        ckpt.save_checkpoint(directory, epoch=0, state=run["state"], loss=1.0)
        other = lever_state("adam", not zero, mesh)
        ckpt.restore_checkpoint(ckpt.latest_checkpoint(directory), other)
        out[name] = {"written": run["moments"], "params": _digest(run["states"][-1]),
                     "loaded": _moments(other.optimizer),
                     "loaded_params": _digest(_numpy_state(other.model)),
                     "path": ckpt.latest_checkpoint(directory)}
    return out


def _skip_case(mesh, rows: slice, steps: list) -> dict:
    """``--bad-step-policy skip`` under ZeRO with buckets (Adam): a good
    step, a step whose rank-0 rows hold a NaN pixel (every rank's verdict:
    skip), then a good step; the state's digests (parameters and
    statistics, the gathered moments, this rank's moment slices) around
    the bad one."""
    state = lever_state("adam", True, mesh)
    step = make_spmd_train_step(torch.float32, bad_step_skip=True, zero_opt_state=True,
                                grad_bucket_mb=BUCKET_MB, mesh=mesh)

    def digests():
        local = {f"{i}.{k}": v.numpy() for i, st in
                 state.optimizer.inner.state_dict()["state"].items() for k, v in st.items()}
        return (_digest(_numpy_state(state.model)), _digest(_moments(state.optimizer)),
                _digest(local), state.step)

    (images, labels), (images2, labels2) = steps
    bad = images.astype(np.float32)
    bad[0, 0, 0, 0] = np.nan
    skipped = [int(step(state, torch.from_numpy(images[rows]),
                        torch.from_numpy(labels[rows]))["skipped"])]
    before = digests()
    skipped.append(int(step(state, torch.from_numpy(bad[rows]),
                            torch.from_numpy(labels[rows]))["skipped"]))
    after = digests()
    m = step(state, torch.from_numpy(images2[rows]), torch.from_numpy(labels2[rows]))
    skipped.append(int(m["skipped"]))
    return {"skipped": skipped, "before": before, "after": after,
            "finite": bool(np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])))}


def grad_sync_worker(payload: dict) -> dict:
    """One rank: every lever × optimizer, the frozen-parameter runs, the
    checkpoint cases, then the CLI (which leaves the world)."""
    distributed.maybe_initialize_distributed(torch.device("cpu"))
    rank = distributed.rank()
    mesh = create_mesh(MeshConfig())
    rows = slice(rank * 4, (rank + 1) * 4)
    steps = _batches()
    out = {"rank": rank, "runs": {}}
    for optimizer in OPTIMIZERS:
        for lever in LEVERS:
            run = run_lever(optimizer, *LEVERS[lever], mesh, rows, steps)
            del run["state"]
            run["digests"] = [_digest(s) for s in run["states"]]
            run["moments_digest"] = _digest(run["moments"])
            del run["local_moments"]
            if rank:
                del run["states"], run["moments"]
            out["runs"][f"{optimizer}-{lever}"] = run
    mask = {name: name.startswith("fc.") for name, _ in
            create_model_bundle("resnet18", NUM_CLASSES, seed=0).model.named_parameters()}
    for lever in ("none", "zero_buckets"):
        run = run_lever("adam", *LEVERS[lever], mesh, rows, steps, mask)
        out[f"frozen-{lever}"] = {"states": run["states"], "moment_numel": run["moment_numel"]}
    out["checkpoints"] = _checkpoint_cases(payload["tmp"], mesh, rows, steps)
    out["skip"] = _skip_case(mesh, rows, steps)
    argv = [*payload["argv"], "--checkpoint-dir", os.path.join(payload["tmp"], "cli", "ckpt"),
            "--log-file", os.path.join(payload["tmp"], "cli", "training.log"),
            "--metrics-file", os.path.join(payload["tmp"], "cli", "metrics.jsonl")]
    summary = trainer.main(argv)
    out["cli"] = {"step_losses": summary.step_losses, "checkpoint": summary.checkpoint_path}
    return out


def cli_argv() -> list[str]:
    """Two steps (16 train rows of the DEBUG sample in global batches of
    8), one epoch, one checkpoint."""
    return [
        "--debug", "true", "--debug-sample-size", "20", "--num-classes", "64",
        "--image-size", "64", "--batch-size", "8", "--num-epochs", "1",
        "--compute-dtype", "float32", "--fused-stem", "true", "--optimizer", "adam",
        "--spmd-mode", "true", "--zero-opt-state", "true", "--grad-sync-buckets", "1",
        "--validate", "false", "--loader-workers", "2", "--log-every-steps", "1",
        "--train-csv", os.path.join(REPO, "data", "train_sample.csv"),
        "--test-csv", os.path.join(REPO, "data", "test_sample.csv"),
    ]


@pytest.fixture(scope="module")
def world():
    with tempfile.TemporaryDirectory(prefix="mpt_grad_sync_") as tmp:
        ranks = run_world("test_torch_grad_sync:grad_sync_worker", WORLD,
                          {"tmp": tmp, "argv": cli_argv()}, timeout_s=300, env=RANK_ENV,
                          pythonpath=[HERE])
        ranks[0]["tmp"] = tmp
        yield ranks


@functools.lru_cache(maxsize=None)
def jax_run(optimizer: str, lever: str) -> dict:
    """The JAX spmd step with the same lever on a two-device mesh: each
    step's metrics, the state after step 1, the first step's ledger."""
    import jax

    from mpi_pytorch_tpu.config import MeshConfig as JaxMeshConfig
    from mpi_pytorch_tpu.parallel import create_mesh as jax_create_mesh

    zero, bucket_mb = LEVERS[lever]
    mesh = jax_create_mesh(JaxMeshConfig(), devices=jax.devices()[:WORLD])
    return _jax_steps(mesh, optimizer, zero, bucket_mb, _batches())


def _jax_steps(mesh, optimizer: str, zero: bool, bucket_mb: float, batches) -> dict:
    """``make_spmd_train_step`` on ``mesh`` from the port's seeded init:
    each step's metrics, the state after step 1, the first step's ledger
    (booked when the step is traced, at its first call)."""
    import jax
    import jax.numpy as jnp

    from mpi_pytorch_tpu.models.resnet import resnet18
    from mpi_pytorch_tpu.parallel import shard_batch
    from mpi_pytorch_tpu.parallel.collectives import LEDGER
    from mpi_pytorch_tpu.train.state import TrainState as JaxTrainState
    from mpi_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
    from mpi_pytorch_tpu.train.state import zero_shard_opt_state
    from mpi_pytorch_tpu.train.step import make_spmd_train_step as jax_spmd_step
    from mpi_pytorch_tpu.train.step import place_state_on_mesh
    from mpi_pytorch_tpu_torch.models.convert import to_flax_variables

    model = resnet18(NUM_CLASSES, dtype=jnp.float32, fused_stem=True, dp_mesh=mesh)
    port = lever_state(optimizer, False, create_mesh(MeshConfig()))
    variables = jax.tree_util.tree_map(
        jnp.asarray, to_flax_variables(port.model.state_dict(), "resnet18"))
    state = JaxTrainState.create(
        apply_fn=model.apply, variables=variables,
        tx=jax_make_optimizer(LR, optimizer=optimizer), rng=jax.random.PRNGKey(1),
    )
    state = place_state_on_mesh(state, mesh)
    if zero:
        state = state.replace(opt_state=zero_shard_opt_state(state.opt_state, mesh))
    step = jax_spmd_step(mesh, jnp.float32, zero_opt_state=zero, grad_bucket_mb=bucket_mb)
    metrics = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPT_STEM_INTERPRET", "1")
        LEDGER.reset()
        for i, (images, labels) in enumerate(batches):
            state, m = step(state, shard_batch((images, labels), mesh))
            if i == 0:
                ledger = LEDGER.snapshot()
                tree = {"params": jax.tree_util.tree_map(np.asarray, state.params),
                        "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}
            metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "tree": tree, "ledger": ledger}


def assert_state_matches_jax(port_state: dict, tree: dict, what: str,
                             keys=("params", "batch_stats")) -> None:
    """A port state_dict (numpy) against a JAX tree after the same step:
    parameters rtol 1e-5 plus atol 2e-6, statistics rtol 1e-5 plus atol
    1e-6 (``tests/test_torch_dp_step.py``)."""
    import jax

    from mpi_pytorch_tpu_torch.models.convert import to_flax_variables

    port_vars = to_flax_variables({k: torch.from_numpy(v) for k, v in port_state.items()},
                                  "resnet18")
    for key in keys:
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(port_vars[key]),
                                jax.tree_util.tree_leaves(tree[key])):
            np.testing.assert_allclose(
                a, b, rtol=1e-5, atol=1e-6 if key == "batch_stats" else 2e-6,
                err_msg=f"{what} {key}{jax.tree_util.keystr(path)}")


def assert_metrics_match_jax(port: list[dict], ref: list[dict], what: str,
                             steps: int | None = None) -> None:
    """Each step's loss, ``correct`` and ``count`` rtol 1e-4 (the first
    ``steps`` steps' loss and ``correct``, every step's count) and the
    step-1 grad norm rtol 1e-4."""
    for key in ("loss", "correct", "count"):
        held = None if key == "count" else steps
        np.testing.assert_allclose([m[key] for m in port[:held]], [m[key] for m in ref[:held]],
                                   rtol=1e-4, err_msg=f"{what} {key}")
    np.testing.assert_allclose(port[0]["grad_norm"], ref[0]["grad_norm"], rtol=1e-4,
                               err_msg=f"{what} step-1 grad norm")


CASES = [f"{o}-{lever}" for o in OPTIMIZERS for lever in LEVERS]


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_match_jax_two_device_mesh(world, case):
    optimizer, lever = case.split("-")
    got = world[0]["runs"][case]
    for r in world[1:]:  # every rank ends with the same metrics and state
        assert r["runs"][case]["metrics"] == got["metrics"]
        assert r["runs"][case]["digests"] == got["digests"]
        assert r["runs"][case]["moments_digest"] == got["moments_digest"]
    ref = jax_run(optimizer, lever)
    assert_metrics_match_jax(got["metrics"], ref["metrics"], case,
                             None if optimizer == "sgd" else 1)
    assert [m["count"] for m in got["metrics"]] == [4, 7]
    assert_state_matches_jax(got["states"][0], ref["tree"], f"{case} step 1",
                             ("params", "batch_stats") if optimizer == "sgd" else ("batch_stats",))


@pytest.mark.parametrize("lever", list(LEVERS))
def test_ledger_bytes_match_jax(world, lever):
    """One step's per-rank bytes, ici and dcn, as the JAX step books them
    (SGD; the optimizer moves no bytes)."""
    got = world[0]["runs"][f"sgd-{lever}"]["ledger"]
    ref = jax_run("sgd", lever)["ledger"]
    assert {k: got[k]["bytes"] for k in ("ici", "dcn")} == {
        k: ref[k]["bytes"] for k in ("ici", "dcn")}
    assert got["dcn"]["bytes"] == 0  # a flat layout never crosses pods
    assert got["ici"]["by_op"] == ref["ici"]["by_op"]


@pytest.mark.parametrize("case", [c for c in CASES if not c.endswith("-none")])
def test_levers_match_the_port_baseline(world, case):
    optimizer, _ = case.split("-")
    base, got = world[0]["runs"][f"{optimizer}-none"], world[0]["runs"][case]
    for i, (a, b) in enumerate(zip(got["metrics"], base["metrics"])):
        for key in ("loss", "correct", "count"):
            assert a[key] == b[key], (i, key)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-6, atol=0)
    for i, (a, b) in enumerate(zip(got["states"], base["states"])):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i + 1} {k}")
    assert got["moments"].keys() == base["moments"].keys()
    for k, v in base["moments"].items():
        np.testing.assert_allclose(got["moments"][k], v, rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", [c for c in CASES if "buckets" in c])
def test_every_bucket_is_issued_from_a_hook(world, case):
    """Every parameter's post-accumulate hook fired once a step (the fused
    stem's batchnorm scale and bias, through the stem's autograd Function,
    among them), and every bucket's collective was issued by a hook, none
    by the sync after the backward."""
    got = world[0]["runs"][case]
    names = list(world[0]["runs"][case]["states"][0])
    params = [k for k in names if "running" not in k and "num_batches" not in k]
    for fired in got["fired"]:
        assert fired == {k: 1 for k in params}
    assert "bn1.weight" in params and "conv1.weight" in params
    plan = grad_bucket_plan(_synced(), BUCKET_MB)
    for timeline in got["timeline"]:
        assert sorted(t["bucket"] for t in timeline) == list(range(len(plan))) and all(
            t["by_hook"] for t in timeline)


def _synced() -> list[torch.Tensor]:
    model = create_model_bundle("resnet18", NUM_CLASSES, seed=0, fused_stem=True).model
    return synced_params(prepare_for_training(model, torch.device("cpu")))


def test_zero_moments_are_two_chunks_a_parameter(world):
    """Each rank holds exactly Σ 2·chunk moment elements under ZeRO Adam
    (chunk = ⌈numel / 2⌉), against 2·Σ numel unsharded."""
    for r in world:
        zero, full = r["runs"]["adam-zero"], r["runs"]["adam-none"]
        assert zero["moment_numel"] == 2 * sum(zero["chunks"])
        numel = sum(p.numel() for p in _synced())
        assert full["moment_numel"] == 2 * numel
        assert zero["moment_numel"] < full["moment_numel"] / 2 + 2 * len(zero["chunks"])
        assert r["runs"]["sgd-zero"]["moment_numel"] == sum(zero["chunks"])


def test_frozen_parameters_are_respected(world):
    """feature-extract (only the head trains): under ZeRO with buckets the
    frozen parameters stay bit-identical, the head moves, the state equals
    the unsharded run's, and only the head's slices have moments."""
    init = _numpy_state(create_model_bundle("resnet18", NUM_CLASSES, seed=0,
                                            fused_stem=True).model)
    frozen, base = world[0]["frozen-zero_buckets"], world[0]["frozen-none"]
    for k, v in frozen["states"][-1].items():
        if k.startswith("fc."):
            assert not np.array_equal(v, init[k]), k
        elif "running" not in k:
            np.testing.assert_array_equal(v, init[k], err_msg=k)
        np.testing.assert_allclose(v, base["states"][-1][k], rtol=1e-6, atol=1e-7, err_msg=k)
    head = sum(zero_shard_spec(s, WORLD)[0] for s in ((NUM_CLASSES, 512), (NUM_CLASSES,)))
    assert frozen["moment_numel"] == 2 * head


def test_a_skipped_step_leaves_the_sliced_state_bit_identical(world):
    """Under ZeRO with buckets a non-finite step is skipped on every rank
    (the verdict reads the synced loss and the ZeRO-axis norm) and leaves
    the parameters, statistics, moments — gathered and each rank's own
    slices — and the step count bit-identical; the next step runs."""
    for r in world:
        got = r["skip"]
        assert got["skipped"] == [0, 1, 0] and got["finite"]
        assert got["after"] == got["before"]


def test_a_zero_checkpoint_loads_into_an_unsharded_run(world):
    got = world[0]["checkpoints"]["zero"]
    assert got["loaded"].keys() == got["written"].keys()
    for k, v in got["written"].items():
        np.testing.assert_array_equal(got["loaded"][k], v, err_msg=k)
    assert got["loaded_params"] == got["params"]


def test_an_unsharded_checkpoint_loads_into_a_zero_run(world):
    """...and the ZeRO state it loads gathers back to the unsharded one,
    on every rank."""
    for r in world:
        got = r["checkpoints"]["unsharded"]
        assert got["loaded"].keys() == got["written"].keys()
        for k, v in got["written"].items():
            np.testing.assert_array_equal(got["loaded"][k], v, err_msg=k)


def test_a_zero_checkpoint_is_an_unsharded_file(world):
    """The ZeRO run's file holds the optimizer ``state_dict`` of an
    unsharded run: the same keys, parameter order, shapes and groups, and
    the same moments (the two runs computed the same state)."""
    cases = world[0]["checkpoints"]
    zero = torch.load(cases["zero"]["path"], map_location="cpu", weights_only=True)
    full = torch.load(cases["unsharded"]["path"], map_location="cpu", weights_only=True)
    assert zero.keys() == full.keys()
    zo, fo = zero["optimizer"], full["optimizer"]
    assert zo["param_groups"] == fo["param_groups"]
    assert list(zo["state"]) == list(fo["state"])
    for i in fo["state"]:
        assert zo["state"][i].keys() == fo["state"][i].keys()
        for k, v in fo["state"][i].items():
            assert zo["state"][i][k].shape == v.shape, (i, k)
            np.testing.assert_allclose(zo["state"][i][k].numpy(), v.cpu().numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{i}.{k}")


def test_a_zero_checkpoint_loads_at_another_world_size(world):
    """The two-rank ZeRO file into a ZeRO optimizer of one shard (this
    process) and of four (a layout of four ranks, seen from each rank's
    index): the slices each keeps tile the file's moments."""
    path = world[0]["checkpoints"]["zero"]["path"]
    payload = torch.load(path, map_location="cpu", weights_only=True)
    one = lever_state("adam", False, create_mesh(MeshConfig()))
    params = [p for p in one.model.parameters()]
    for n in (1, 4):
        parts = []
        for index in range(n):
            opt = ZeroOptimizer(params, lambda ps: torch.optim.Adam(ps, lr=LR), Axis("data", n, index))
            opt.load_state_dict(payload["optimizer"])
            parts.append(opt.inner.state_dict()["state"])
        for i, st in payload["optimizer"]["state"].items():
            for k, v in st.items():
                if v.dim() == 0:
                    assert all(torch.equal(p[i][k], v) for p in parts)
                    continue
                tiled = torch.cat([p[i][k] for p in parts])[:v.numel()]
                assert torch.equal(tiled, v.reshape(-1)), (n, i, k)
    with pytest.raises(ValueError, match="shape"):
        ZeroOptimizer(params[1:], lambda ps: torch.optim.Adam(ps, lr=LR),
                      Axis("data", 2, 0)).load_state_dict(payload["optimizer"])


def test_the_cli_runs_zero_and_buckets(world):
    """``python -m mpi_pytorch_tpu_torch.train --spmd-mode true
    --zero-opt-state true --grad-sync-buckets 1`` on the two ranks: two
    finite steps equal on both ranks, one checkpoint in the unsharded
    format, the plan and the ledger in the log and the ``grad_sync``
    record."""
    tmp = world[0]["tmp"]
    assert [len(r["cli"]["step_losses"]) for r in world] == [2, 2]
    assert world[0]["cli"]["step_losses"] == world[1]["cli"]["step_losses"]
    assert np.isfinite(world[0]["cli"]["step_losses"]).all()
    # The checkpoint and its topology sidecar.
    assert sorted(os.listdir(os.path.join(tmp, "cli", "ckpt"))) == [
        "ckpt_00000.pt", "ckpt_00000.pt.manifest.json"]
    payload = torch.load(world[0]["cli"]["checkpoint"], map_location="cpu", weights_only=True)
    for i, st in payload["optimizer"]["state"].items():
        assert st["exp_avg"].shape == payload["model"][_param_names()[i]].shape
    with open(os.path.join(tmp, "cli", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    (sync,) = [r for r in records if r["kind"] == "grad_sync"]
    assert sync["zero_shards"] == 2 and sync["buckets"] > 1 and sync["dcn_bytes_per_step"] == 0
    assert set(sync["ici_by_op"]) == {"all_reduce", "reduce_scatter", "all_gather"}
    with open(os.path.join(tmp, "cli", "training.log")) as f:
        log = f.read()
    assert "grad-sync buckets:" in log and "reduce-scatter (ZeRO slices)" in log
    assert "ZeRO opt-state sharding: moments partitioned 1/2 over 'data'" in log
    assert len(glob.glob(os.path.join(tmp, "cli", "ckpt", "*.pt"))) == 1


def _param_names() -> list[str]:
    model = create_model_bundle("resnet18", 64, seed=0, fused_stem=True).model
    return [n for n, _ in model.named_parameters()]


# --- pure functions against the JAX ones ---------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_zero_shard_spec_matches_jax(n_shards):
    from mpi_pytorch_tpu.train.state import zero_shard_spec as jax_spec

    for shape in [(), (1,), (7,), (64,), (10, 512), (64, 3, 7, 7), (13, 5, 3)]:
        assert zero_shard_spec(shape, n_shards) == jax_spec(shape, n_shards), shape


@pytest.mark.parametrize("bucket_mb", [0.0001, 0.5, 1.0, 4.0, 25.0, 64.0])
def test_bucket_plan_matches_jax(bucket_mb):
    """The port's plan over its parameters equals the JAX plan over a list
    of numpy arrays in the port's order (JAX flattens a list in order), and
    so do the overlap fractions; a cap below every tensor gives each its
    own bucket, the last bucket holds the first parameter (the stem)."""
    from mpi_pytorch_tpu.train.step import bucket_overlap_frac as jax_frac
    from mpi_pytorch_tpu.train.step import grad_bucket_plan as jax_plan
    from mpi_pytorch_tpu.train.step import hier_dcn_overlap_frac as jax_dcn_frac

    params = _synced()
    arrays = [p.detach().numpy() for p in params]
    plan = grad_bucket_plan(params, bucket_mb)
    assert plan == jax_plan(arrays, bucket_mb)
    assert bucket_overlap_frac(params, plan) == jax_frac(arrays, plan)
    assert hier_dcn_overlap_frac(params, plan) == jax_dcn_frac(arrays, plan)
    assert sorted(i for b in plan for i in b) == list(range(len(params)))
    assert plan[-1][-1] == 0 and plan[0][0] == len(params) - 1
    if bucket_mb == 0.0001:
        assert len(plan) == len(params)
    if bucket_mb == 64.0:  # above the model's 44.7 MB
        assert len(plan) == 1 and bucket_overlap_frac(params, plan) == 0.0


def test_ledger_ring_factors_match_jax():
    """Each collective's booked bytes and kind equal the JAX ``_account``'s
    over axes of 1, 2, 4 and 8 (bound by ``jax.vmap``)."""
    import jax
    import jax.numpy as jnp

    from mpi_pytorch_tpu.parallel import collectives as jc

    for name in ("data", "ici", "pod"):
        assert collectives.axis_kind(name) == jc.axis_kind(name)
    assert collectives.axis_kind(("pod", "ici")) == jc.axis_kind(("pod", "ici")) == "dcn"
    for size in (1, 2, 4, 8):
        for name in ("data", "ici", "pod"):
            for op in ("all_reduce", "reduce_scatter", "all_gather"):
                jc.LEDGER.reset()
                jax.vmap(lambda x: (jc._account(op, name, 1000.0), x)[1],
                         axis_name=name)(jnp.zeros(size))
                collectives.LEDGER.reset()
                collectives._account(op, Axis(name, size, 0), 1000.0)
                assert collectives.LEDGER.snapshot() == jc.LEDGER.snapshot(), (size, name, op)
    collectives.LEDGER.reset()


# --- config: the JAX refusals, in its words ------------------------------

REFUSED = [
    {"zero_opt_state": True},
    {"grad_sync_buckets": 25.0},
    {"grad_sync_buckets": -1.0, "spmd_mode": True},
    {"mesh.pods": 2},
    {"mesh.pods": 0, "spmd_mode": True},
]


def _apply(cfg, overrides: dict):
    for key, val in overrides.items():
        if key.startswith("mesh."):
            setattr(cfg.mesh, key[5:], val)
        else:
            setattr(cfg, key, val)
    return cfg


@pytest.mark.parametrize("overrides", REFUSED, ids=str)
def test_lever_refusals_are_jax_words(overrides):
    from mpi_pytorch_tpu import config as jc

    with pytest.raises(ValueError) as jax_error:
        _apply(jc.Config(), overrides).validate_config()
    with pytest.raises(ValueError) as port_error:
        _apply(Config(), overrides).validate_config()
    assert str(port_error.value) == str(jax_error.value)


def test_levers_compose_and_the_rest_stay_refused():
    """The spmd levers compose; the auto step's levers are refused with
    spmd mode in the JAX ``validate_config``'s words, and the pipe axis
    is still not ported."""
    from mpi_pytorch_tpu import config as jc

    Config(spmd_mode=True, zero_opt_state=True, grad_sync_buckets=25.0,
           mesh=MeshConfig(pods=2)).validate_config()
    for overrides in ({"zero_optimizer": True}, {"fsdp": True}, {"mesh.model_parallel": 2}):
        with pytest.raises(ValueError) as jax_error:
            _apply(jc.Config(spmd_mode=True), overrides).validate_config()
        with pytest.raises(ValueError) as port_error:
            _apply(Config(spmd_mode=True), overrides).validate_config()
        assert str(port_error.value) == str(jax_error.value)
    with pytest.raises(ValueError, match=r"not ported yet \(ROADMAP A7\)"):
        _apply(Config(spmd_mode=True), {"mesh.pipe_parallel": 2}).validate_config()


def test_mesh_pods_alias_and_world_divisibility(monkeypatch):
    """``--mesh-pods`` is ``--mesh.pods``; a world the pods do not divide
    is refused in the JAX ``create_mesh``'s words."""
    import jax

    from mpi_pytorch_tpu.config import MeshConfig as JaxMeshConfig
    from mpi_pytorch_tpu.parallel import create_mesh as jax_create_mesh

    for key in list(os.environ):
        if key.startswith("MPT_"):
            monkeypatch.delenv(key)
    assert parse_config(["--mesh-pods", "2", "--spmd-mode", "true"]).mesh.pods == 2
    assert parse_config(["--mesh.pods", "2", "--spmd-mode", "true"]).mesh.pods == 2
    assert parse_config([]).mesh.pods == 1
    with pytest.raises(ValueError) as jax_error:
        jax_create_mesh(JaxMeshConfig(pods=2), devices=jax.devices()[:3])
    with pytest.raises(ValueError) as port_error:
        MeshConfig(pods=2).check_world(3)
    assert str(port_error.value) == str(jax_error.value)
    MeshConfig(pods=2).check_world(4)
