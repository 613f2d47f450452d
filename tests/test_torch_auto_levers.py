"""The auto step's ZeRO-1 (``--zero-optimizer``) and FSDP (``--fsdp``) on
two gloo ranks (a flat layout) against the JAX package's placed auto
step, on the CPU, in f32 (``train/state.place_model``, ``make_train_step``).

The conventions of ``tests/test_torch_grad_sync.py``: resnet18 at 64 px
with the fused stem and a 10-class head, global batch 8 (4 rows a rank),
the port's seeded init carried into the JAX tree by ``to_flax_variables``,
the JAX fused stem's Pallas pair in interpret mode, and the two batches of
``tests/test_torch_dp_step.py`` (step 1 the uneven tail: 3 and 1 valid
rows). Each lever — ZeRO-1, FSDP and both — runs two steps with SGD and
two with Adam, beside the unplaced auto step on the same ranks.

- Against JAX (``make_train_step`` after ``place_state_on_mesh(...,
  zero_optimizer=..., fsdp=...)`` on a two-device mesh, as
  ``tests/test_parallel.py`` runs it: ZeRO-1 with Adam, FSDP with SGD):
  the tolerances and the Adam rule of
  ``tests/test_torch_grad_sync.py`` — each step's loss, ``correct`` and
  ``count`` and the step-1 grad norm rtol 1e-4; after step 1 every
  running statistic rtol 1e-5 plus atol 1e-6 and with SGD every parameter
  rtol 1e-5 plus atol 2e-6; with Adam step 1's metrics and statistics and
  step 2's count.
- Against the port's own unplaced step on the same ranks: parameters,
  moments and running statistics after both steps rtol 1e-6 plus atol
  1e-7, the grad norms rtol 1e-6, the losses, counts and ``correct``
  equal. A sum of two terms does not depend on its order (a reduce-scatter
  or an all-reduce), the gathered weights are the weights, and the
  updates are elementwise, so 0 is expected; measured on this CPU: 0.

Then the layout: each rank's moment numel, and under FSDP its parameter
numel, is the rule's (``parallel.mesh.param_specs``,
``shard_first_divisible`` over 2: every resnet18 parameter has an even
dimension, so each rank holds half of every one, ``layer4``'s largest
convolution included); a skipped bad step leaves every block and moment
bit-identical; checkpoints cross layouts (a ZeRO-1 and an FSDP run's file
loads into a one-process run with an equal state and holds an unsharded
run's keys and shapes; a one-process file loads into both layouts); and
``python -m mpi_pytorch_tpu_torch.train --zero-optimizer true --fsdp true
--accum-steps 2`` runs two steps and writes one checkpoint.

Every case runs in ONE two-rank world (``run_world``, a module fixture).
"""

import functools
import hashlib
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import MeshConfig
from mpi_pytorch_tpu_torch.models.common import set_batchnorm_sync
from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training
from mpi_pytorch_tpu_torch.parallel import distributed
from mpi_pytorch_tpu_torch.parallel.launch import run_world
from mpi_pytorch_tpu_torch.parallel.mesh import (
    create_mesh,
    data_axis,
    param_specs,
    shard_first_divisible,
)
from mpi_pytorch_tpu_torch.train import trainer
from mpi_pytorch_tpu_torch.train.state import (
    TrainState,
    full_state_dict,
    make_optimizer,
    place_model,
)
from mpi_pytorch_tpu_torch.train.step import make_train_step
from test_torch_dp_step import RANK_ENV, _batches, rank_threads

NUM_CLASSES = 10
WORLD = 2
LR = 4e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(REPO, "tests")
LEVERS = {"zero": (True, False), "fsdp": (False, True), "zero_fsdp": (True, True)}
OPTIMIZERS = ("sgd", "adam")
CHECKPOINT_LEVERS = ("zero", "fsdp")


def placed_state(optimizer: str, mesh=None, *, zero: bool = False, fsdp: bool = False,
                 model_name: str = "resnet18", num_classes: int = NUM_CLASSES,
                 **bundle_kw) -> TrainState:
    """The seeded model (resnet18 with the fused stem by default) for the
    auto step: batchnorm over ``mesh``'s data axis, laid out on ``mesh``
    with the levers (the trainer's rule: placed when a lever or a model
    axis is on; ``mesh`` None is one process)."""
    if model_name == "resnet18":
        bundle_kw.setdefault("fused_stem", True)
    bundle = create_model_bundle(model_name, num_classes, seed=0, **bundle_kw)
    model = prepare_for_training(bundle.model, torch.device("cpu"))
    placed = mesh is not None and (zero or fsdp or mesh.model.size > 1)
    set_batchnorm_sync(model, True, data_axis(mesh) if placed else None)
    placement = place_model(model, mesh, fsdp=fsdp, zero=zero) if placed else None
    opt, schedule = make_optimizer(model, LR, optimizer=optimizer, placement=placement)
    return TrainState(model=model, optimizer=opt, schedule=schedule, placement=placement)


def numpy_state(state: TrainState) -> dict:
    """The unsharded state_dict (a collective for a placed state: every
    rank calls it) as numpy, without the batch counters."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in full_state_dict(state.model, state.placement).items()
            if not k.endswith("num_batches_tracked")}


def moments(opt) -> dict:
    """The unsharded optimizer state's tensors, ``"index.key"`` → numpy (a
    sharded optimizer's ``state_dict`` gathers: every rank calls it)."""
    return {f"{i}.{k}": v.detach().cpu().numpy().copy()
            for i, st in opt.state_dict()["state"].items() for k, v in st.items()
            if torch.is_tensor(v)}


def digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def held_numel(state: TrainState) -> tuple[int, int, dict]:
    """(parameter elements, moment elements) this rank holds, and each
    held parameter's elements by name."""
    held = ({n: p.numel() for n, p in state.placement.held.items()} if state.placement
            else {n: p.numel() for n, p in state.model.named_parameters()})
    opt = getattr(state.optimizer, "inner", state.optimizer)
    moment = sum(v.numel() for st in opt.state.values() for v in st.values()
                 if torch.is_tensor(v) and v.dim() > 0)
    return sum(held.values()), moment, held


def run_steps(state: TrainState, step, rows: slice, batches) -> dict:
    """The steps on this rank's rows: each step's metrics and unsharded
    state, the unsharded moments after the last, the held numels."""
    out = {"metrics": [], "states": []}
    for images, labels in batches:
        m = step(state, torch.from_numpy(images[rows]), torch.from_numpy(labels[rows]))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(numpy_state(state))
    out["moments"] = moments(state.optimizer)
    out["param_numel"], out["moment_numel"], out["held"] = held_numel(state)
    return out


def _skip_case(mesh, rows: slice, steps: list) -> dict:
    """``--bad-step-policy skip`` under ZeRO-1 and FSDP (Adam): a good
    step, a step whose rank-0 rows hold a NaN pixel (every rank skips),
    then a good step; digests of the unsharded state, the unsharded
    moments and this rank's own blocks and moments around the bad one."""
    state = placed_state("adam", mesh, zero=True, fsdp=True)
    step = make_train_step(torch.float32, bad_step_skip=True, mesh=mesh)

    def digests():
        local = {n: p.detach().numpy().copy() for n, p in state.placement.held.items()}
        local.update({f"{i}.{k}": v.numpy().copy() for i, st in
                      state.optimizer.inner.state_dict()["state"].items() for k, v in st.items()})
        return digest(numpy_state(state)), digest(moments(state.optimizer)), digest(local)

    (images, labels), (images2, labels2) = steps
    bad = images.astype(np.float32)
    bad[0, 0, 0, 0] = np.nan
    skipped = [int(step(state, torch.from_numpy(images[rows]),
                        torch.from_numpy(labels[rows]))["skipped"])]
    before = (*digests(), state.step)
    skipped.append(int(step(state, torch.from_numpy(bad[rows]),
                            torch.from_numpy(labels[rows]))["skipped"]))
    after = (*digests(), state.step)
    m = step(state, torch.from_numpy(images2[rows]), torch.from_numpy(labels2[rows]))
    skipped.append(int(m["skipped"]))
    return {"skipped": skipped, "before": before, "after": after,
            "finite": bool(np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])))}


def _checkpoint_cases(tmp: str, mesh, rows: slice, steps: list, runs: dict) -> dict:
    """Each lever's Adam run written (rank 0, after a gather), and the
    one-process file (``tmp/one``) loaded into each layout: the unsharded
    state and moments it gathers back to."""
    out = {}
    for lever in CHECKPOINT_LEVERS:
        zero, fsdp = LEVERS[lever]
        state = runs[lever]
        directory = os.path.join(tmp, lever)
        ckpt.save_checkpoint(directory, epoch=0, state=state, loss=1.0)
        other = placed_state("adam", mesh, zero=zero, fsdp=fsdp)
        ckpt.restore_checkpoint(ckpt.latest_checkpoint(os.path.join(tmp, "one")), other)
        out[lever] = {"path": ckpt.latest_checkpoint(directory),
                      "loaded_params": numpy_state(other), "loaded_moments": moments(other.optimizer)}
    return out


def levers_worker(payload: dict) -> dict:
    """One rank: the baseline and every lever × optimizer, the skip case,
    the checkpoint cases, then the CLI (which leaves the world)."""
    distributed.maybe_initialize_distributed(torch.device("cpu"))
    rank = distributed.rank()
    mesh = create_mesh(MeshConfig())
    rows = slice(rank * 4, (rank + 1) * 4)
    steps = _batches()
    out = {"rank": rank, "runs": {}}
    adam_states = {}
    for optimizer in OPTIMIZERS:
        base = placed_state(optimizer)
        out["runs"][f"{optimizer}-none"] = run_steps(
            base, make_train_step(torch.float32, mesh=mesh), rows, steps)
        for lever, (zero, fsdp) in LEVERS.items():
            state = placed_state(optimizer, mesh, zero=zero, fsdp=fsdp)
            out["runs"][f"{optimizer}-{lever}"] = run_steps(
                state, make_train_step(torch.float32, mesh=mesh), rows, steps)
            if optimizer == "adam":
                adam_states[lever] = state
    out["skip"] = _skip_case(mesh, rows, steps)
    out["checkpoints"] = _checkpoint_cases(payload["tmp"], mesh, rows, steps, adam_states)
    argv = [*payload["argv"], "--checkpoint-dir", os.path.join(payload["tmp"], "cli", "ckpt"),
            "--log-file", os.path.join(payload["tmp"], "cli", "training.log"),
            "--metrics-file", os.path.join(payload["tmp"], "cli", "metrics.jsonl")]
    summary = trainer.main(argv)
    out["cli"] = {"step_losses": summary.step_losses, "checkpoint": summary.checkpoint_path}
    return out


def cli_argv(*levers: str) -> list[str]:
    """Two steps (16 train rows of the DEBUG sample in global batches of
    8), one epoch, one checkpoint, with ``levers`` appended."""
    return [
        "--debug", "true", "--debug-sample-size", "20", "--num-classes", "64",
        "--image-size", "64", "--batch-size", "8", "--num-epochs", "1",
        "--compute-dtype", "float32", "--fused-stem", "true", "--optimizer", "adam",
        "--validate", "false", "--loader-workers", "2", "--log-every-steps", "1",
        "--train-csv", os.path.join(REPO, "data", "train_sample.csv"),
        "--test-csv", os.path.join(REPO, "data", "test_sample.csv"), *levers,
    ]


def one_process_adam(directory: str) -> dict:
    """The unplaced step in this process on the whole batches (Adam, the
    ranks' thread count), its checkpoint written to ``directory``; the
    state and moments after both steps."""
    with rank_threads():
        state = placed_state("adam")
        step = make_train_step(torch.float32)
        for images, labels in _batches():
            step(state, torch.from_numpy(images), torch.from_numpy(labels))
        ckpt.save_checkpoint(directory, epoch=0, state=state, loss=1.0)
        return {"params": numpy_state(state), "moments": moments(state.optimizer)}


@pytest.fixture(scope="module")
def world():
    with tempfile.TemporaryDirectory(prefix="mpt_auto_levers_") as tmp:
        one = one_process_adam(os.path.join(tmp, "one"))
        ranks = run_world("test_torch_auto_levers:levers_worker", WORLD,
                          {"tmp": tmp, "argv": cli_argv("--zero-optimizer", "true", "--fsdp",
                                                        "true", "--accum-steps", "2")},
                          timeout_s=400, env=RANK_ENV, pythonpath=[HERE])
        ranks[0]["tmp"], ranks[0]["one"] = tmp, one
        yield ranks


def jax_auto_steps(mesh, optimizer: str, batches, *, zero: bool = False, fsdp: bool = False,
                   accum_steps: int = 1, fused: bool = True, port_model=None) -> dict:
    """The JAX auto step (``make_train_step``) on ``mesh`` after
    ``place_state_on_mesh(..., zero_optimizer=zero, fsdp=fsdp)``, from the
    port's seeded init (``port_model``, else resnet18, with the fused stem
    — whose Pallas pair runs in interpret mode — unless ``fused`` is
    off): each step's metrics and the state after step 1."""
    import jax
    import jax.numpy as jnp

    from mpi_pytorch_tpu.parallel import shard_batch
    from mpi_pytorch_tpu.train.state import TrainState as JaxTrainState
    from mpi_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
    from mpi_pytorch_tpu.train.step import make_train_step as jax_auto_step
    from mpi_pytorch_tpu.train.step import place_state_on_mesh
    from mpi_pytorch_tpu_torch.models.convert import to_flax_variables

    if port_model is None:
        from mpi_pytorch_tpu.models.resnet import resnet18

        jax_model = resnet18(NUM_CLASSES, dtype=jnp.float32, fused_stem=fused,
                             dp_mesh=mesh if fused else None)
        variables = to_flax_variables(placed_state(optimizer, fused_stem=fused).model.state_dict(),
                                      "resnet18")
    else:
        jax_model, variables = port_model
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    state = JaxTrainState.create(
        apply_fn=jax_model.apply, variables=variables,
        tx=jax_make_optimizer(LR, optimizer=optimizer), rng=jax.random.PRNGKey(1),
    )
    state = place_state_on_mesh(state, mesh, zero_optimizer=zero, fsdp=fsdp)
    step = jax_auto_step(jnp.float32, accum_steps=accum_steps,
                         mesh=mesh if accum_steps > 1 else None)
    metrics = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPT_STEM_INTERPRET", "1")
        for i, (images, labels) in enumerate(batches):
            state, m = step(state, shard_batch((images, labels), mesh))
            if i == 0:
                tree = {"params": jax.tree_util.tree_map(np.asarray, state.params),
                        "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}
            metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "tree": tree}


@functools.lru_cache(maxsize=None)
def jax_run(optimizer: str, lever: str) -> dict:
    import jax

    from mpi_pytorch_tpu.config import MeshConfig as JaxMeshConfig
    from mpi_pytorch_tpu.parallel import create_mesh as jax_create_mesh

    zero, fsdp = LEVERS[lever]
    mesh = jax_create_mesh(JaxMeshConfig(), devices=jax.devices()[:WORLD])
    return jax_auto_steps(mesh, optimizer, _batches(), zero=zero, fsdp=fsdp)


def assert_state_matches_jax(port_state: dict, tree: dict, what: str,
                             keys=("params", "batch_stats"), arch: str = "resnet18",
                             num_heads: int | None = None) -> None:
    """A port state_dict (numpy) against a JAX tree after the same step:
    parameters rtol 1e-5 plus atol 2e-6, statistics rtol 1e-5 plus atol
    1e-6 (``tests/test_torch_dp_step.py``)."""
    import jax

    from mpi_pytorch_tpu_torch.models.convert import to_flax_variables

    port_vars = to_flax_variables({k: torch.from_numpy(v) for k, v in port_state.items()},
                                  arch, num_heads)
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


def assert_states_close(got: dict, base: dict, what: str, rtol: float = 1e-6,
                        atol: float = 1e-7) -> None:
    assert got.keys() == base.keys(), what
    for k, v in base.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol, err_msg=f"{what} {k}")


CASES = [f"{o}-{lever}" for o in OPTIMIZERS for lever in LEVERS]
# Against JAX as tests/test_parallel.py runs the two levers — ZeRO-1 with
# Adam, FSDP with SGD; every case against the port's baseline.
JAX_CASES = ["adam-zero", "sgd-fsdp"]


@pytest.mark.parametrize("case", JAX_CASES)
def test_two_ranks_match_jax_placed_step(world, case):
    optimizer, lever = case.split("-")
    got = world[0]["runs"][case]
    for r in world[1:]:  # every rank ends with the same metrics and unsharded state
        assert r["runs"][case]["metrics"] == got["metrics"]
        assert [digest(s) for s in r["runs"][case]["states"]] == [
            digest(s) for s in got["states"]]
    ref = jax_run(optimizer, lever)
    assert_metrics_match_jax(got["metrics"], ref["metrics"], case,
                             None if optimizer == "sgd" else 1)
    assert [m["count"] for m in got["metrics"]] == [4, 7]
    assert_state_matches_jax(got["states"][0], ref["tree"], f"{case} step 1",
                             ("params", "batch_stats") if optimizer == "sgd" else ("batch_stats",))


@pytest.mark.parametrize("case", CASES)
def test_levers_match_the_port_baseline(world, case):
    optimizer, _ = case.split("-")
    base, got = world[0]["runs"][f"{optimizer}-none"], world[0]["runs"][case]
    for i, (a, b) in enumerate(zip(got["metrics"], base["metrics"])):
        for key in ("loss", "correct", "count"):
            assert a[key] == b[key], (case, i, key)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-6, atol=0)
    for i, (a, b) in enumerate(zip(got["states"], base["states"])):
        assert_states_close(a, b, f"{case} step {i + 1}")
    assert_states_close(got["moments"], base["moments"], f"{case} moments")


def _rule_numel(shape, n: int) -> int:
    numel = int(np.prod(shape))
    return numel // n if shard_first_divisible(shape, n) is not None else numel


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_the_rules_share(world, case):
    """Moments (Adam two a parameter, SGD one) and, under FSDP, parameters:
    each rank's elements are the rule's — half of every resnet18
    parameter, which all have an even dimension; the largest leaf
    (``layer4``'s 3×3 convolutions) too."""
    optimizer, lever = case.split("-")
    zero, fsdp = LEVERS[lever]
    shapes = {k: v.shape for k, v in world[0]["runs"][case]["states"][0].items()
              if "running" not in k}
    per = {n: _rule_numel(s, WORLD) for n, s in shapes.items()}
    whole = {n: int(np.prod(s)) for n, s in shapes.items()}
    assert all(per[n] * WORLD == whole[n] for n in shapes)
    k = 2 if optimizer == "adam" else 1
    largest = max(whole, key=whole.get)
    for r in world:
        run = r["runs"][case]
        assert run["moment_numel"] == k * sum(per.values())
        assert run["param_numel"] == sum((per if fsdp else whole).values())
        assert run["held"][largest] == (whole[largest] // WORLD if fsdp else whole[largest])
        base = r["runs"][f"{optimizer}-none"]
        assert base["moment_numel"] == k * sum(whole.values())


def test_the_placement_rule_is_jaxs_on_resnet18():
    """The sharded set and each device's bytes of the port's rule equal the
    JAX placement's addressable shards, for resnet18 under FSDP and
    ZeRO-1 over 2 and 4 data devices, the TP head over (1, 2) and (2, 2),
    and (2, 2) with FSDP and with ZeRO-1."""
    import jax
    import jax.numpy as jnp

    from mpi_pytorch_tpu.config import MeshConfig as JaxMeshConfig
    from mpi_pytorch_tpu.models.resnet import resnet18
    from mpi_pytorch_tpu.parallel import create_mesh as jax_create_mesh
    from mpi_pytorch_tpu.parallel.mesh import param_specs as jax_param_specs
    from mpi_pytorch_tpu.train.state import TrainState as JaxTrainState
    from mpi_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
    from mpi_pytorch_tpu.train.step import place_state_on_mesh
    from mpi_pytorch_tpu_torch.models.convert import to_flax_variables

    port = create_model_bundle("resnet18", NUM_CLASSES, seed=0).model
    shapes = {n: tuple(p.shape) for n, p in port.named_parameters()}
    variables = jax.tree_util.tree_map(
        jnp.asarray, to_flax_variables(port.state_dict(), "resnet18"))
    order = _jax_order(shapes)
    for dp, mp, fsdp, zero in ((2, 1, True, False), (4, 1, True, False), (2, 1, False, True),
                               (4, 1, False, True), (1, 2, False, False), (2, 2, False, False),
                               (2, 2, True, False), (2, 2, False, True)):
        mesh = jax_create_mesh(JaxMeshConfig(model_parallel=mp), devices=jax.devices()[:dp * mp])
        state = JaxTrainState.create(
            apply_fn=resnet18(NUM_CLASSES, dtype=jnp.float32).apply, variables=variables,
            tx=jax_make_optimizer(LR, optimizer="sgd"), rng=jax.random.PRNGKey(1))
        placed = place_state_on_mesh(state, mesh, zero_optimizer=zero, fsdp=fsdp)
        specs = param_specs(shapes, dp, mp, fsdp)
        jspecs = jax.tree_util.tree_leaves(jax_param_specs(state.params, mesh, fsdp=fsdp),
                                           is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        jparams = jax.tree_util.tree_leaves(placed.params)
        jmoments = [leaf for leaf in jax.tree_util.tree_leaves(placed.opt_state)
                    if hasattr(leaf, "addressable_shards") and leaf.ndim > 0]
        what = f"dp {dp} mp {mp} fsdp {fsdp} zero {zero}"
        assert [specs[n].sharded for n in order] == [any(a is not None for a in s)
                                                     for s in jspecs], what
        for n, leaf in zip(order, jparams):
            want = leaf.addressable_shards[0].data.nbytes
            size = {"data": dp, "model": mp}.get(specs[n].axis, 1)
            assert 4 * int(np.prod(shapes[n])) // size == want, (what, n)
        moment_bytes = sum(leaf.addressable_shards[0].data.nbytes for leaf in jmoments)
        placement_moments = 0
        for n in order:
            spec = specs[n]
            dim = (shard_first_divisible(shapes[n], dp) if zero and dp > 1 and not spec.sharded
                   else None)
            size = ({"data": dp, "model": mp}[spec.axis] if spec.sharded
                    else dp if dim is not None else 1)
            placement_moments += 4 * int(np.prod(shapes[n])) // size
        assert placement_moments == moment_bytes, what


def n_is_buffer(key: str) -> bool:
    return "running" in key or key.endswith("num_batches_tracked")


def _jax_order(shapes: dict) -> list[str]:
    """The port's parameter names in the JAX params tree's leaf order."""
    import jax

    from mpi_pytorch_tpu_torch.models.convert import to_flax_variables

    tagged = {n: torch.full(s, float(i)) for i, (n, s) in enumerate(shapes.items())}
    buffers = create_model_bundle("resnet18", NUM_CLASSES, seed=0).model.state_dict()
    tagged.update({k: v for k, v in buffers.items() if n_is_buffer(k)})
    leaves = jax.tree_util.tree_leaves(to_flax_variables(tagged, "resnet18")["params"])
    names = list(shapes)
    return [names[int(np.asarray(leaf).reshape(-1)[0])] for leaf in leaves]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_shard_first_divisible_matches_jax(n):
    from jax.sharding import PartitionSpec as P

    from mpi_pytorch_tpu.parallel.mesh import shard_first_divisible as jax_rule

    for shape in [(), (1,), (7,), (64,), (10, 512), (512, 10), (64, 3, 7, 7), (3, 3, 64, 128),
                  (13, 5, 3), (0, 4)]:
        spec = jax_rule(shape, "data", n)
        want = None if spec == P() else list(spec).index("data")
        assert shard_first_divisible(shape, n) == want, (shape, n)


def test_a_skipped_step_leaves_every_block_bit_identical(world):
    for r in world:
        got = r["skip"]
        assert got["skipped"] == [0, 1, 0] and got["finite"]
        assert got["after"] == got["before"]


@pytest.mark.parametrize("lever", CHECKPOINT_LEVERS)
def test_a_sharded_checkpoint_loads_into_one_process(world, lever):
    """The lever's file: the unsharded run's keys, shapes and parameter
    order; loaded into a one-process state it is the world's gathered
    state and moments."""
    got = world[0]["runs"][f"adam-{lever}"]
    path = world[0]["checkpoints"][lever]["path"]
    payload = torch.load(path, map_location="cpu", weights_only=True)
    one = placed_state("adam")
    assert list(payload["model"]) == list(one.model.state_dict())
    for k, v in one.model.state_dict().items():
        assert payload["model"][k].shape == v.shape, k
    ckpt.restore_checkpoint(path, one)
    assert_states_close(numpy_state(one), got["states"][-1], f"{lever} loaded", 0, 0)
    assert_states_close(moments(one.optimizer), got["moments"], f"{lever} moments", 0, 0)
    params = [p for p in one.model.parameters()]
    for i, st in payload["optimizer"]["state"].items():
        assert st["exp_avg"].shape == params[i].shape


@pytest.mark.parametrize("lever", CHECKPOINT_LEVERS)
def test_a_one_process_checkpoint_loads_into_each_layout(world, lever):
    one = world[0]["one"]
    for r in world:
        got = r["checkpoints"][lever]
        assert_states_close(got["loaded_params"], one["params"], f"{lever} params", 0, 0)
        assert_states_close(got["loaded_moments"], one["moments"], f"{lever} moments", 0, 0)


def test_the_cli_runs_zero_fsdp_and_accumulation(world):
    """``python -m mpi_pytorch_tpu_torch.train --zero-optimizer true --fsdp
    true --accum-steps 2`` on the two ranks: two finite steps equal on both
    ranks, one checkpoint in the unsharded format, the placement in the
    log and in its metrics record."""
    tmp = world[0]["tmp"]
    assert [len(r["cli"]["step_losses"]) for r in world] == [2, 2]
    assert world[0]["cli"]["step_losses"] == world[1]["cli"]["step_losses"]
    assert np.isfinite(world[0]["cli"]["step_losses"]).all()
    # The checkpoint and its topology sidecar.
    assert sorted(os.listdir(os.path.join(tmp, "cli", "ckpt"))) == [
        "ckpt_00000.pt", "ckpt_00000.pt.manifest.json"]
    payload = torch.load(world[0]["cli"]["checkpoint"], map_location="cpu", weights_only=True)
    model = create_model_bundle("resnet18", 64, seed=0, fused_stem=True).model
    assert {k: v.shape for k, v in payload["model"].items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    with open(os.path.join(tmp, "cli", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    (placement,) = [r for r in records if r["kind"] == "placement"]
    assert placement["mesh"] == {"data": 2, "model": 1}
    assert (placement["zero_shards"], placement["fsdp_shards"], placement["accum_steps"]) == (
        2, 2, 2)
    whole_mb = sum(p.numel() * 4 for p in model.parameters()) / 1e6
    np.testing.assert_allclose(placement["param_mb_per_rank"], whole_mb / 2, rtol=1e-9)
    np.testing.assert_allclose(placement["moment_mb_per_rank"], whole_mb, rtol=1e-9)
    with open(os.path.join(tmp, "cli", "training.log")) as f:
        log = f.read()
    assert "2 microbatches a step" in log
    assert "ZeRO-1 moments 1/2 over 'data', FSDP parameters 1/2 over 'data'" in log


def test_param_specs_head_and_fsdp_rule():
    """The rule on its own: the head over ``model`` when the axis divides
    its classes, else replicated (and then not FSDP-sharded, as JAX's
    ``param_specs`` keeps it); every other parameter over ``data`` on its
    first even dimension under FSDP."""
    shapes = {"conv1.weight": (64, 3, 7, 7), "bn1.weight": (64,), "fc.weight": (15, 512),
              "fc.bias": (15,), "odd.weight": (3, 5)}
    specs = param_specs(shapes, 2, 2, fsdp=True)
    assert specs["conv1.weight"].axis == "data" and specs["conv1.weight"].dim == 0
    assert not specs["fc.weight"].sharded and not specs["fc.bias"].sharded
    assert not specs["odd.weight"].sharded
    specs = param_specs({**shapes, "fc.weight": (16, 512), "fc.bias": (16,)}, 2, 2, fsdp=True)
    assert (specs["fc.weight"].axis, specs["fc.weight"].dim) == ("model", 0)
    assert (specs["fc.bias"].axis, specs["fc.bias"].dim) == ("model", 0)
    specs = param_specs({**shapes, "fc.weight": (15, 512)}, 2, 1, fsdp=True)
    assert (specs["fc.weight"].axis, specs["fc.weight"].dim) == ("data", 1)


@pytest.mark.parametrize("dp,mp,fsdp", [(2, 1, True), (4, 1, True), (1, 2, False),
                                        (2, 2, False), (2, 2, True)])
def test_shard_and_unshard_state_dict_round_trip(dp, mp, fsdp):
    """``models.convert.shard_state_dict`` cuts each rank's tensors of the
    seeded init on a (dp, mp) layout by the rule (each split parameter a
    block of 1/dp or 1/mp of its elements, the rest whole), and
    ``unshard_state_dict`` of every rank's gives the init back."""
    from mpi_pytorch_tpu_torch.models.convert import shard_state_dict, unshard_state_dict

    full = create_model_bundle("resnet18", NUM_CLASSES, seed=0).model.state_dict()
    shapes = {k: tuple(v.shape) for k, v in full.items() if not n_is_buffer(k)}
    specs = param_specs(shapes, dp, mp, fsdp)
    ranks = {(d, m): shard_state_dict(full, specs, {"data": (dp, d), "model": (mp, m)})
             for d in range(dp) for m in range(mp)}
    for (d, m), sd in ranks.items():
        assert list(sd) == list(full)
        for k, v in sd.items():
            size = {"data": dp, "model": mp}.get(specs[k].axis, 1) if k in specs else 1
            assert v.numel() * size == full[k].numel(), (k, d, m)
    back = unshard_state_dict(ranks, specs)
    assert list(back) == list(full)
    for k, v in full.items():
        assert torch.equal(back[k], v), k
