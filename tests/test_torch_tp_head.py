"""The vocab-sharded head (``--mesh.model-parallel``) of the auto step on
gloo ranks against the JAX package's ``MeshConfig(model_parallel=...)``
mesh, on the CPU, in f32 (``models.common.VocabParallelDense``,
``ops.losses.vocab_parallel_ce_sum``, ``train/state.place_model``).

The conventions of ``tests/test_torch_auto_levers.py``: resnet18 at 64 px
with a 10-class head (V divides by 2) — the plain stem on both sides,
which keeps the JAX step's compile short (the fused stem's Function under
FSDP is that file's) — the two batches of ``tests/test_torch_dp_step.py``
(global batch 8, a tail step), SGD, two steps from the port's seeded
init. vit_s16 at 32 px has vit_s16's widths (hidden 384, 6 heads, MLP
1536, 16-px patches) at depth 2.

One four-rank world holds every case. The 1 × 2 layouts run on two model
groups of two ranks ({0, 1} and {2, 3}, a data axis of one), the 2 × 2
layout on the world (``create_mesh(MeshConfig(model_parallel=2))``: rank
``d·2 + m``). Held:

- 1 × 2 against JAX's ``model_parallel=2`` step on two devices, resnet18
  and vit_s16 (``tests/test_parallel.py``'s TP case), with the
  tolerances of ``tests/test_torch_dp_step.py`` (loss, ``correct``,
  ``count`` and the step-1 grad norm rtol 1e-4, after step 1 every
  parameter rtol 1e-5 plus atol 2e-6 and statistic rtol 1e-5 plus atol
  1e-6) — tighter than that test's loss rtol 2e-4 and head atol 2e-4;
- 1 × 2 against the port's one-process step on the same rows: losses
  and grad norms rtol 1e-5, the state after both steps rtol 1e-5 plus
  atol 2e-6 (statistics 1e-6): the loss, the count and every gradient
  are the one-process step's, which no world-wide reduction could give
  (the ranks of a model group hold the same rows);
- 2 × 2 with FSDP against JAX's (2, 2) mesh with ``fsdp=True``, the same
  tolerances;
- the trunk's parameters and statistics bit-identical on the two ranks
  of every model group;
- the device cache's step on the 2 × 2 FSDP layout (rows sharded over the
  data index) equal to the streaming step bit for bit;
- 15 classes at mp = 2: the head stays whole on every rank (as JAX's
  ``param_specs`` replicates it), and the step is the one-process one;
- alexnet in train mode (dropout 0.5 before fc1 and fc2) on 1 × 2: the
  two ranks of a model group draw the same masks, the one-process step's
  on the same rows, so the losses, grad norms and state are that step's;
- the vocab-parallel CE sum, its gradient and the first-index argmax on
  each model group against ``masked_ce_sum``, ``F.cross_entropy``'s
  gradient, ``torch.argmax`` and ``jnp.argmax`` of the whole logits, with
  ties planted across the shard boundary (the first index wins), f32 and
  bf16;
- checkpoints: a 1 × 2 and a 2 × 2 FSDP run's file loads into one process
  with an equal state and has an unsharded run's keys and shapes; a
  one-process file loads into both layouts;
- the CLIs: ``python -m mpi_pytorch_tpu_torch.train
  --mesh.model-parallel 2`` on the four ranks (two steps, sharded
  validation equal to a one-process evaluation of its checkpoint), then
  ``evaluate --mesh.model-parallel 2 --fused-head-eval true
  --predictions-file``: rank 0 writes one CSV, equal to a one-process
  ``evaluate``'s.
"""

import functools
import os
import tempfile

import numpy as np
import pytest
import torch

from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch import evaluate as port_evaluate
from mpi_pytorch_tpu_torch.config import MeshConfig, parse_config
from mpi_pytorch_tpu_torch.data.manifest import load_manifests
from mpi_pytorch_tpu_torch.models.common import Dropout, VocabParallelDense
from mpi_pytorch_tpu_torch.models.registry import prepare_for_training
from mpi_pytorch_tpu_torch.models.vit import VisionTransformer
from mpi_pytorch_tpu_torch.ops.losses import (
    masked_ce_sum,
    vocab_parallel_argmax,
    vocab_parallel_ce_sum,
)
from mpi_pytorch_tpu_torch.parallel import distributed
from mpi_pytorch_tpu_torch.parallel.launch import run_world
from mpi_pytorch_tpu_torch.parallel.mesh import MODEL_AXIS, Axis, Mesh, create_mesh
from mpi_pytorch_tpu_torch.train import trainer
from mpi_pytorch_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
    place_model,
)
from mpi_pytorch_tpu_torch.train.step import make_cached_train_step, make_train_step
from test_torch_auto_levers import (
    LR,
    NUM_CLASSES,
    assert_metrics_match_jax,
    assert_state_matches_jax,
    assert_states_close,
    cli_argv,
    jax_auto_steps,
    numpy_state,
    placed_state,
)
from test_torch_dp_step import RANK_ENV, _batches, rank_threads

WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(REPO, "tests")
VIT = dict(patch_size=16, hidden=384, depth=2, num_heads=6, mlp_dim=1536)
VIT_SIZE = 32
PLAIN = {"fused_stem": False}


def vit_batches():
    rng = np.random.default_rng(12)
    out = []
    for valid in (5, 8):
        images = rng.integers(0, 256, size=(8, VIT_SIZE, VIT_SIZE, 3)).astype(np.uint8)
        labels = rng.integers(0, NUM_CLASSES, size=(8,)).astype(np.int32)
        labels[valid:] = -1
        out.append((images, labels))
    return out


def vit_state(mesh=None) -> TrainState:
    """vit_s16's widths at depth 2, 32 px, seeded; placed over ``mesh``."""
    model = VisionTransformer(NUM_CLASSES, VIT_SIZE, **VIT)
    model.init_weights(torch.Generator().manual_seed(0))
    model = prepare_for_training(model, torch.device("cpu"))
    placement = place_model(model, mesh) if mesh is not None else None
    opt, schedule = make_optimizer(model, LR, optimizer="sgd", placement=placement)
    return TrainState(model=model, optimizer=opt, schedule=schedule, placement=placement)


def _trunk_digest(state: TrainState) -> str:
    """A digest of every tensor this rank holds that the model axis
    replicates (all but the head's blocks)."""
    import hashlib

    h = hashlib.sha256()
    for n, p in state.placement.held.items():
        if state.placement.specs[n].axis != MODEL_AXIS:
            h.update(n.encode())
            h.update(p.detach().numpy().tobytes())
    for n, b in state.model.named_buffers():
        h.update(n.encode())
        h.update(b.numpy().tobytes())
    return h.hexdigest()


def _run(state: TrainState, mesh, batches, rows: slice) -> dict:
    step = make_train_step(torch.float32, mesh=mesh)
    out = {"metrics": [], "states": []}
    for images, labels in batches:
        m = step(state, torch.from_numpy(images[rows]), torch.from_numpy(labels[rows]))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(numpy_state(state))
    out["trunk"] = _trunk_digest(state)
    out["head"] = type(state.model.fc).__name__, tuple(state.placement.held["fc.weight"].shape)
    return out


ALEX_SAMPLE = 97  # alexnet's state compared: every 97th entry of each tensor


def alexnet_state(mesh=None) -> TrainState:
    """alexnet (dropout 0.5 before fc1 and fc2) with the 10-class head,
    seeded, its masks from the state's generator; placed over ``mesh``
    (None: one process)."""
    state = placed_state("sgd", mesh, model_name="alexnet")
    state.generator, state.rng_seed = torch.Generator(), 7
    return state


def _dropout_run(state: TrainState, mesh, rows: slice) -> dict:
    """:func:`_run`'s two steps on a dropout model in train mode, with a
    digest of the generator's state at each mask a Dropout draws (the same
    state draws the same mask) and every ``ALEX_SAMPLE``-th entry of each
    tensor of the state after each step (the whole of it is ~0.2 GB)."""
    import hashlib

    masks = []
    hooks = [m.register_forward_pre_hook(lambda m, _: masks.append(
        hashlib.sha256(m.generator.get_state().numpy().tobytes()).hexdigest()))
        for m in state.model.modules() if isinstance(m, Dropout)]
    step = make_train_step(torch.float32, mesh=mesh)
    out = {"metrics": [], "states": []}
    for images, labels in _batches():
        m = step(state, torch.from_numpy(images[rows]), torch.from_numpy(labels[rows]))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append({k: v.ravel()[::ALEX_SAMPLE].copy()
                              for k, v in numpy_state(state).items()})
    for h in hooks:
        h.remove()
    out["masks"] = masks
    out["trunk"] = _trunk_digest(state) if state.placement is not None else None
    return out


def _run_cached(state: TrainState, mesh) -> dict:
    """:func:`_run`'s steps through the device cache's step: each batch's
    rows held as the cache holds them (this data index's half) and
    gathered by index."""
    step = make_cached_train_step(torch.float32, mesh=mesh)
    d = mesh.axes[0].index
    out = {"metrics": [], "states": []}
    for images, labels in _batches():
        dataset = torch.from_numpy(images[4 * d:4 * d + 4])
        m = step(state, dataset, torch.from_numpy(np.maximum(labels, 0)),
                 torch.arange(8, dtype=torch.int32), torch.from_numpy(labels >= 0))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(numpy_state(state))
    return out


def _vocab_cases(axis: Axis) -> dict:
    """The vocab-parallel CE sum, its gradient and the argmax on this
    rank's block of seeded logits with planted ties, f32 and bf16."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        logits, labels = tied_logits()
        logits = logits.to(dtype)
        rows = NUM_CLASSES // axis.size
        start = axis.index * rows
        local = logits[:, start:start + rows].clone().requires_grad_(True)
        ce = vocab_parallel_ce_sum(local, torch.from_numpy(labels), start, axis)
        ce.backward()
        out[str(dtype)] = {"ce": float(ce), "grad": local.grad.float().numpy(),
                           "argmax": vocab_parallel_argmax(local.detach(), start, axis).numpy()}
    return out


def tied_logits():
    """[16, 10] logits (seeded) with ties planted across the shard
    boundary of mp = 2 (columns 4 | 5), within a shard, and of three;
    labels with −1 rows."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(16, NUM_CLASSES)).astype(np.float32)
    top = logits.max(axis=1) + 1.0
    logits[0, [4, 5]] = top[0]
    logits[1, [5, 4]] = top[1]
    logits[2, [2, 7]] = top[2]
    logits[3, [6, 8]] = top[3]
    logits[4, [1, 5, 9]] = top[4]
    labels = rng.integers(0, NUM_CLASSES, size=(16,)).astype(np.int32)
    labels[[3, 9]] = -1
    return torch.from_numpy(logits), labels


def tp_worker(payload: dict) -> dict:
    """One rank: the 1 × 2 runs on its pair, the 2 × 2 FSDP run on the
    world, the vocab-parallel cases, the checkpoints, then the CLIs."""
    import torch.distributed as dist

    distributed.maybe_initialize_distributed(torch.device("cpu"))
    rank = distributed.rank()
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = Mesh((Axis("data", 1, 0),), Axis(MODEL_AXIS, 2, rank % 2, pairs[rank // 2]))
    mesh = create_mesh(MeshConfig(model_parallel=2))
    every, half = slice(0, 8), slice(4 * (rank // 2), 4 * (rank // 2) + 4)
    out = {"rank": rank, "vocab": _vocab_cases(pair.model)}
    resnet = placed_state("sgd", pair, **PLAIN)
    out["resnet_1x2"] = _run(resnet, pair, _batches(), every)
    out["vit_1x2"] = _run(vit_state(pair), pair, vit_batches(), every)
    out["resnet15_1x2"] = _run(placed_state("sgd", pair, num_classes=15, **PLAIN), pair,
                               _batches(), every)
    out["alexnet_1x2"] = _dropout_run(alexnet_state(pair), pair, every)
    fsdp = placed_state("sgd", mesh, fsdp=True, **PLAIN)
    out["resnet_2x2_fsdp"] = _run(fsdp, mesh, _batches(), half)
    out["resnet_2x2_fsdp_cached"] = _run_cached(
        placed_state("sgd", mesh, fsdp=True, **PLAIN), mesh)
    tmp = payload["tmp"]
    out["checkpoints"] = {}
    for name, state, layout, fsdp_on in (("1x2", resnet, pair, False),
                                         ("2x2_fsdp", fsdp, mesh, True)):
        ckpt.save_checkpoint(os.path.join(tmp, name), epoch=0, state=state, loss=1.0)
        other = placed_state("sgd", layout, fsdp=fsdp_on)
        ckpt.restore_checkpoint(ckpt.latest_checkpoint(os.path.join(tmp, "one")), other)
        out["checkpoints"][name] = {
            "path": ckpt.latest_checkpoint(os.path.join(tmp, name)),
            "loaded": numpy_state(other)}
    cfg = parse_config([*payload["argv"], "--checkpoint-dir", os.path.join(tmp, "cli", "ckpt"),
                        "--log-file", os.path.join(tmp, "cli", "training.log"),
                        "--metrics-file", os.path.join(tmp, "cli", "metrics.jsonl")])
    summary = trainer.train(cfg)
    out["cli"] = {"step_losses": summary.step_losses, "val": summary.val_accuracy}
    cfg.predictions_file = os.path.join(tmp, "cli", "predictions.csv")
    cfg.fused_head_eval = True
    port_evaluate.evaluate(cfg)
    return out


def one_process(state: TrainState, batches) -> dict:
    """The unplaced step in this process on the whole batches, at the
    ranks' thread count."""
    step = make_train_step(torch.float32)
    out = {"metrics": [], "states": []}
    with rank_threads():
        for images, labels in batches:
            m = step(state, torch.from_numpy(images), torch.from_numpy(labels))
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["states"].append(numpy_state(state))
    return out


@pytest.fixture(scope="module")
def world():
    with tempfile.TemporaryDirectory(prefix="mpt_tp_head_") as tmp:
        with rank_threads():
            one = placed_state("sgd")
            for images, labels in _batches():
                make_train_step(torch.float32)(one, torch.from_numpy(images),
                                               torch.from_numpy(labels))
            ckpt.save_checkpoint(os.path.join(tmp, "one"), epoch=0, state=one, loss=1.0)
        argv = cli_argv("--mesh.model-parallel", "2", "--validate", "true",
                        "--optimizer", "sgd")
        ranks = run_world("test_torch_tp_head:tp_worker", WORLD, {"tmp": tmp, "argv": argv},
                          timeout_s=400, env=RANK_ENV,
                          pythonpath=[HERE])
        ranks[0].update(tmp=tmp, one=numpy_state(one), argv=argv)
        yield ranks


@functools.lru_cache(maxsize=None)
def jax_run(case: str) -> dict:
    import jax
    import jax.numpy as jnp

    from mpi_pytorch_tpu.config import MeshConfig as JaxMeshConfig
    from mpi_pytorch_tpu.parallel import create_mesh as jax_create_mesh

    if case == "resnet_2x2_fsdp":
        mesh = jax_create_mesh(JaxMeshConfig(model_parallel=2), devices=jax.devices()[:4])
        return jax_auto_steps(mesh, "sgd", _batches(), fsdp=True, fused=False)
    mesh = jax_create_mesh(JaxMeshConfig(model_parallel=2), devices=jax.devices()[:2])
    if case == "resnet_1x2":
        return jax_auto_steps(mesh, "sgd", _batches(), fused=False)
    from mpi_pytorch_tpu.models.vit import VisionTransformer as JaxViT
    from mpi_pytorch_tpu_torch.models.convert import to_flax_variables

    variables = to_flax_variables(vit_state().model.state_dict(), "vit_s16", VIT["num_heads"])
    jax_model = JaxViT(num_classes=NUM_CLASSES, dtype=jnp.float32, **VIT)
    return jax_auto_steps(mesh, "sgd", vit_batches(),
                          port_model=(jax_model, {"params": variables["params"]}))


JAX_CASES = ["resnet_1x2", "vit_1x2", "resnet_2x2_fsdp"]


@pytest.mark.parametrize("case", JAX_CASES)
def test_tp_matches_jax_model_parallel_mesh(world, case):
    got = world[0][case]
    for r in world[1:]:  # every rank reports the same metrics and unsharded state
        assert r[case]["metrics"] == got["metrics"]
        for a, b in zip(r[case]["states"], got["states"]):
            assert_states_close(a, b, f"rank {r['rank']} {case}", 0, 0)
    ref = jax_run(case)
    assert_metrics_match_jax(got["metrics"], ref["metrics"], case)
    vit = case.startswith("vit")
    assert_state_matches_jax(got["states"][0], ref["tree"], f"{case} step 1",
                             ("params",) if vit else ("params", "batch_stats"),
                             "vit_s16" if vit else "resnet18", VIT["num_heads"] if vit else None)


@pytest.mark.parametrize("case", ["resnet_1x2", "vit_1x2", "resnet15_1x2"])
def test_tp_matches_the_one_process_step(world, case):
    """Losses, counts, ``correct`` and grad norms (rtol 1e-5) and the state
    after both steps (rtol 1e-5, atol 2e-6; statistics 1e-6)."""
    if case == "vit_1x2":
        state, batches = vit_state(), vit_batches()
    elif case == "resnet15_1x2":
        state, batches = placed_state("sgd", num_classes=15, **PLAIN), _batches()
    else:
        state, batches = placed_state("sgd", **PLAIN), _batches()
    ref = one_process(state, batches)
    got = world[0][case]
    for a, b in zip(got["metrics"], ref["metrics"]):
        assert (a["count"], a["correct"]) == (b["count"], b["correct"])
        np.testing.assert_allclose([a["loss"], a["grad_norm"]], [b["loss"], b["grad_norm"]],
                                   rtol=1e-5, atol=0, err_msg=case)
    for i, (a, b) in enumerate(zip(got["states"], ref["states"])):
        for k, v in b.items():
            np.testing.assert_allclose(a[k], v, rtol=1e-5, atol=1e-6 if "running" in k else 2e-6,
                                       err_msg=f"{case} step {i + 1} {k}")


def test_the_device_cache_takes_the_levers(world):
    """The device cache's step on the 2 × 2 layout with FSDP (each data
    index holding its half of the rows, gathered by index over the data
    axis) is the streaming step, bit for bit."""
    for r in world:
        got, want = r["resnet_2x2_fsdp_cached"], r["resnet_2x2_fsdp"]
        assert got["metrics"] == want["metrics"]
        for a, b in zip(got["states"], want["states"]):
            assert_states_close(a, b, "cached", 0, 0)


def test_tp_dropout_model_draws_one_mask_a_model_group(world):
    """alexnet in train mode on the 1 × 2 pairs: every rank draws the
    masks of its data shard (the pairs' data index is 0), which are the
    one-process step's, so the losses and grad norms (rtol 1e-5) and every
    ``ALEX_SAMPLE``-th entry of the state after each step (rtol 1e-5 plus
    atol 2e-6) are the one-process step's on the same rows."""
    with rank_threads():
        ref = _dropout_run(alexnet_state(), None, slice(0, 8))
    assert len(ref["masks"]) == 4 and len(set(ref["masks"])) == 4
    for r in world:
        got = r["alexnet_1x2"]
        assert got["masks"] == ref["masks"], f"rank {r['rank']}"
        for a, b in zip(got["metrics"], ref["metrics"]):
            assert (a["count"], a["correct"]) == (b["count"], b["correct"])
            np.testing.assert_allclose([a["loss"], a["grad_norm"]], [b["loss"], b["grad_norm"]],
                                       rtol=1e-5, atol=0, err_msg=f"rank {r['rank']}")
        for i, (a, b) in enumerate(zip(got["states"], ref["states"])):
            assert a.keys() == b.keys()
            for k, v in b.items():
                np.testing.assert_allclose(a[k], v, rtol=1e-5, atol=2e-6,
                                           err_msg=f"rank {r['rank']} step {i + 1} {k}")


@pytest.mark.parametrize("case", ["resnet_1x2", "vit_1x2", "resnet15_1x2", "resnet_2x2_fsdp",
                                  "alexnet_1x2"])
def test_the_trunk_is_equal_on_every_model_rank(world, case):
    for a, b in ((0, 1), (2, 3)):
        assert world[a][case]["trunk"] == world[b][case]["trunk"], (case, a, b)


def test_the_head_is_sharded_only_where_the_classes_divide(world):
    for r in world:
        assert r["resnet_1x2"]["head"] == ("VocabParallelDense", (5, 512))
        assert r["resnet_2x2_fsdp"]["head"] == ("VocabParallelDense", (5, 512))
        assert r["vit_1x2"]["head"] == ("VocabParallelDense", (5, 384))
        assert r["resnet15_1x2"]["head"][1] == (15, 512)
        assert r["resnet15_1x2"]["head"][0] != VocabParallelDense.__name__


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_vocab_parallel_ce_and_argmax(world, dtype):
    """Each rank's CE sum is ``masked_ce_sum`` of the whole logits (rtol
    1e-6), its gradient block is ``F.cross_entropy``'s in the logits'
    dtype (rtol 1e-5 plus atol 1e-7 in f32; in bf16 one bf16 rounding,
    rtol 2⁻⁸: the two f32 gradients round to bf16 apart when they straddle
    a rounding boundary; masked rows zero), and its argmax is
    ``torch.argmax``'s and ``jnp.argmax``'s, the first index on every
    planted tie."""
    import jax.numpy as jnp

    logits, labels = tied_logits()
    logits = logits.to(getattr(torch, dtype.split(".")[1]))
    full = logits.clone().requires_grad_(True)
    want = masked_ce_sum(full, torch.from_numpy(labels)).detach()
    masked_ce_sum(full, torch.from_numpy(labels)).backward()
    bf16 = dtype.endswith("bfloat16")
    first = torch.argmax(logits.float(), dim=-1).numpy()
    np.testing.assert_array_equal(first, np.asarray(jnp.argmax(jnp.asarray(
        logits.float().numpy()), axis=-1)))
    assert list(first[:5]) == [4, 4, 2, 6, 1]
    for r in world:
        got = r["vocab"][dtype]
        m = r["rank"] % 2
        np.testing.assert_allclose(got["ce"], float(want), rtol=1e-6)
        np.testing.assert_allclose(got["grad"], full.grad[:, 5 * m:5 * m + 5].float().numpy(),
                                   rtol=2**-8 if bf16 else 1e-5, atol=0 if bf16 else 1e-7)
        np.testing.assert_array_equal(got["argmax"], first)
        assert not got["grad"][[3, 9]].any()


@pytest.mark.parametrize("layout", ["1x2", "2x2_fsdp"])
def test_a_tp_checkpoint_loads_into_one_process(world, layout):
    case = {"1x2": "resnet_1x2", "2x2_fsdp": "resnet_2x2_fsdp"}[layout]
    path = world[0]["checkpoints"][layout]["path"]
    payload = torch.load(path, map_location="cpu", weights_only=True)
    one = placed_state("sgd")
    assert {k: v.shape for k, v in payload["model"].items()} == {
        k: v.shape for k, v in one.model.state_dict().items()}
    ckpt.restore_checkpoint(path, one)
    assert_states_close(numpy_state(one), world[0][case]["states"][-1], layout, 0, 0)
    params = list(one.model.parameters())
    for i, st in payload["optimizer"]["state"].items():
        assert st["momentum_buffer"].shape == params[i].shape


@pytest.mark.parametrize("layout", ["1x2", "2x2_fsdp"])
def test_a_one_process_checkpoint_loads_into_tp(world, layout):
    for r in world:
        assert_states_close(r["checkpoints"][layout]["loaded"], world[0]["one"], layout, 0, 0)


def test_the_clis_run_a_two_by_two_mesh(world):
    """The train CLI on the 2 × 2 mesh: two finite steps, equal on every
    rank; its sharded validation equals a one-process evaluation of its
    checkpoint on the same rows; the evaluate CLI's CSV (rank 0's, the
    fused head on the whole gathered W) equals a one-process evaluate's."""
    tmp = world[0]["tmp"]
    assert [len(r["cli"]["step_losses"]) for r in world] == [2] * WORLD
    assert all(r["cli"]["step_losses"] == world[0]["cli"]["step_losses"] for r in world)
    with open(os.path.join(tmp, "cli", "training.log")) as f:
        log = f.read()
    assert "data 2 × model 2" in log and "TP head (classes split 1/2 over 'model')" in log
    cfg = parse_config([*world[0]["argv"], "--checkpoint-dir", os.path.join(tmp, "cli", "ckpt"),
                        "--mesh.model-parallel", "1", "--log-file", os.path.join(tmp, "one.log"),
                        "--eval-log-file", os.path.join(tmp, "one_eval.log"),
                        "--metrics-file", "", "--fused-head-eval", "true",
                        "--predictions-file", os.path.join(tmp, "one.csv")])
    model = port_evaluate.build_inference(
        cfg, "cpu", ckpt.load_for_eval(ckpt.latest_checkpoint(cfg.checkpoint_dir))[0])
    with rank_threads():
        train_m = load_manifests(cfg)[0]
        acc, _ = trainer.evaluate_manifest(cfg, model, train_m)
        port_evaluate.evaluate(cfg, "cpu")
    assert acc == world[0]["cli"]["val"]
    with open(os.path.join(tmp, "cli", "predictions.csv")) as f, open(
            os.path.join(tmp, "one.csv")) as g:
        got, want = f.read(), g.read()
    assert got == want and len(want.splitlines()) > 1


# --- config and layout: the JAX refusals, in its words -------------------


@pytest.mark.parametrize("world_size,mesh_kw", [
    (3, {"model_parallel": 2}), (4, {"model_parallel": 2, "data_parallel": 3}),
    (4, {"model_parallel": 4, "data_parallel": 2}),
])
def test_layout_refusals_are_jax_create_meshs_words(world_size, mesh_kw):
    import jax

    from mpi_pytorch_tpu.config import MeshConfig as JaxMeshConfig
    from mpi_pytorch_tpu.parallel import create_mesh as jax_create_mesh

    with pytest.raises(ValueError) as jax_error:
        jax_create_mesh(JaxMeshConfig(**mesh_kw), devices=jax.devices()[:world_size])
    with pytest.raises(ValueError) as port_error:
        MeshConfig(**mesh_kw).check_world(world_size)
    assert str(port_error.value).startswith(str(jax_error.value))


def test_a_two_by_two_layout_is_data_major():
    """``MeshConfig(model_parallel=2)`` over four ranks: data size 2, and
    rank ``d·2 + m`` at data index ``d`` — the JAX mesh's device order."""
    import jax

    from mpi_pytorch_tpu.config import MeshConfig as JaxMeshConfig
    from mpi_pytorch_tpu.parallel import create_mesh as jax_create_mesh
    from mpi_pytorch_tpu_torch.parallel.mesh import data_coords

    cfg = MeshConfig(model_parallel=2)
    cfg.check_world(4)
    assert cfg.data_size(4) == 2
    devices = jax.devices()[:4]
    grid = jax_create_mesh(JaxMeshConfig(model_parallel=2), devices=devices).devices
    for rank in range(4):
        d, m = (int(x) for x in np.argwhere(grid == devices[rank])[0])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(distributed, "world_size", lambda: 4)
            mp.setattr(distributed, "rank", lambda rank=rank: rank)
            assert data_coords(2) == (2, d) and rank == d * 2 + m


def test_model_parallel_flag_parses():
    cfg = parse_config(["--mesh.model-parallel", "2"])
    assert cfg.mesh.model_parallel == 2 and cfg.mesh.data_parallel == -1
