"""The zoo slice as a whole, on the CPU: the port's train step on the
small densenet with the fused stem against the JAX package's, the
inception loss, the train-mode randomness, the ``feature_extract`` masks
and the config's refusals.

The small densenet: ``block_config=(2, 2)``, growth 8, the 64-channel
7×7 stem with ``FusedStemBNReluPool`` (the JAX Pallas pair in interpret
mode, ``MPT_STEM_INTERPRET=1``; the port's wrappers run their plain
versions), 32 px, 10 classes, SGD with momentum at 4e-4, uint8 batches of
8 with padding rows, f32 with TF32 off, weights the port's seeded init
carried to the JAX tree by ``to_flax_variables``.

- One process, three steps against JAX ``make_train_step``: each step's
  loss and count, and the step-1 grad norm, rtol 1e-4; after step 1 every
  parameter rtol 1e-5 plus atol 2e-6 and every running statistic rtol
  1e-5 plus atol 1e-6 (the tolerances of ``test_torch_dp_step.py``).
- Two gloo ranks in auto mode against JAX's step on a two-device mesh
  (the first batch's ranks hold 3 and 1 valid rows): the same checks, the
  ranks bit-identical to each other, and the two-rank state after both
  steps against the port's one-process step on the whole batches, run
  under ``rank_threads`` (parameters rtol 1e-5 plus atol 2e-6, statistics
  rtol 1e-5 plus atol 1e-6).
"""

import functools
import os

import numpy as np
import pytest
import torch

from mpi_pytorch_tpu_torch.config import parse_config
from mpi_pytorch_tpu_torch.models import densenet
from mpi_pytorch_tpu_torch.models.common import Dropout, StochasticDepth, set_batchnorm_sync
from mpi_pytorch_tpu_torch.models.convert import to_flax_variables
from mpi_pytorch_tpu_torch.models.registry import (
    create_model_bundle,
    init_weights,
    prepare_for_training,
)
from mpi_pytorch_tpu_torch.ops.losses import classification_loss
from mpi_pytorch_tpu_torch.parallel import distributed
from mpi_pytorch_tpu_torch.parallel.launch import run_world
from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer, step_seed
from mpi_pytorch_tpu_torch.train.step import make_train_step
from test_torch_dp_step import RANK_ENV, rank_threads

NUM_CLASSES = 10
SIZE = 32
BATCH = 8
LR = 4e-4
WORLD = 2
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _batches(n: int = 3):
    rng = np.random.default_rng(13)
    out = []
    for valid in ((3, 1), (4, 3), (4, 4))[:n]:
        images = rng.integers(0, 256, size=(BATCH, SIZE, SIZE, 3)).astype(np.uint8)
        labels = rng.integers(0, NUM_CLASSES, size=(BATCH,)).astype(np.int32)
        for r, k in enumerate(valid):
            labels[r * 4 + k:(r + 1) * 4] = -1
        out.append((images, labels))
    return out


def _port_state() -> TrainState:
    model = densenet.densenet121(NUM_CLASSES, block_config=(2, 2), growth_rate=8, fused_stem=True)
    init_weights(model, torch.Generator().manual_seed(0))
    model = prepare_for_training(model, torch.device("cpu"))
    opt, schedule = make_optimizer(model, LR, optimizer="sgd")
    return TrainState(model=model, optimizer=opt, schedule=schedule)


def _numpy_state(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _jax_module(mesh=None):
    import jax.numpy as jnp

    from mpi_pytorch_tpu.models.densenet import DenseNet

    return DenseNet(block_config=(2, 2), num_classes=NUM_CLASSES, growth_rate=8,
                    dtype=jnp.float32, fused_stem=True, dp_mesh=mesh)


@functools.lru_cache(maxsize=None)
def _jax_run(devices: int, n_steps: int) -> dict:
    """JAX's auto step on ``devices`` CPU devices (a mesh when 2): each
    step's metrics and the state after step 1."""
    import jax
    import jax.numpy as jnp

    from mpi_pytorch_tpu.config import MeshConfig
    from mpi_pytorch_tpu.parallel import create_mesh, shard_batch
    from mpi_pytorch_tpu.train.state import TrainState as JaxTrainState
    from mpi_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
    from mpi_pytorch_tpu.train.step import make_train_step as jax_make_train_step
    from mpi_pytorch_tpu.train.step import place_state_on_mesh

    mesh = create_mesh(MeshConfig(), devices=jax.devices()[:devices]) if devices > 1 else None
    variables = jax.tree_util.tree_map(
        jnp.asarray, to_flax_variables(_port_state().model.state_dict(), "densenet121"))
    state = JaxTrainState.create(apply_fn=_jax_module(mesh).apply, variables=variables,
                                 tx=jax_make_optimizer(LR, optimizer="sgd"),
                                 rng=jax.random.PRNGKey(1))
    if mesh is not None:
        state = place_state_on_mesh(state, mesh)
    step = jax_make_train_step(jnp.float32)
    metrics, first = [], None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPT_STEM_INTERPRET", "1")
        for images, labels in _batches(n_steps):
            batch = (jnp.asarray(images), jnp.asarray(labels))
            state, m = step(state, batch if mesh is None else shard_batch(batch, mesh))
            metrics.append({k: float(v) for k, v in m.items()})
            if first is None:
                first = {"params": jax.tree_util.tree_map(np.asarray, state.params),
                         "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}
    return {"metrics": metrics, "first": first}


def _check_against_jax(metrics: list[dict], state_after_1: dict, ref: dict) -> None:
    import jax

    for key in ("loss", "correct", "count"):
        np.testing.assert_allclose([m[key] for m in metrics], [m[key] for m in ref["metrics"]],
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(metrics[0]["grad_norm"], ref["metrics"][0]["grad_norm"], rtol=1e-4)
    port_vars = to_flax_variables({k: torch.from_numpy(v) for k, v in state_after_1.items()},
                                  "densenet121")
    for key, atol in (("params", 2e-6), ("batch_stats", 1e-6)):
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(port_vars[key]),
                                jax.tree_util.tree_leaves(ref["first"][key])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol,
                                       err_msg=f"step 1 {key}{jax.tree_util.keystr(path)}")


def test_small_densenet_three_steps_match_jax():
    state = _port_state()
    step = make_train_step(torch.float32)
    metrics, first = [], None
    for images, labels in _batches(3):
        m = step(state, torch.from_numpy(images), torch.from_numpy(labels))
        metrics.append({k: float(v) for k, v in m.items()})
        first = first or _numpy_state(state.model)
    assert [m["count"] for m in metrics] == [4, 7, 8]
    _check_against_jax(metrics, first, _jax_run(1, 3))


def densenet_rank_worker(payload: dict) -> dict:
    """One rank of the auto-mode world: its rows of each batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.maybe_initialize_distributed(torch.device("cpu"))
    rank, world = distributed.rank(), distributed.world_size()
    state = _port_state()
    set_batchnorm_sync(state.model, True)
    step = make_train_step(torch.float32)
    rows = BATCH // world
    metrics, states = [], []
    for images, labels in _batches(2):
        sl = slice(rank * rows, (rank + 1) * rows)
        m = step(state, torch.from_numpy(images[sl]), torch.from_numpy(labels[sl]))
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_numpy_state(state.model))
    return {"rank": rank, "metrics": metrics, "states": states}


def test_small_densenet_two_ranks_match_jax_mesh_and_one_process():
    ranks = run_world("test_torch_zoo_train:densenet_rank_worker", WORLD, {}, timeout_s=120,
                      env=RANK_ENV, pythonpath=[HERE])
    got = ranks[0]
    for r in ranks[1:]:
        assert r["metrics"] == got["metrics"]
        for a, b in zip(r["states"], got["states"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"rank {r['rank']} {k}")
    assert [m["count"] for m in got["metrics"]] == [4, 7]
    _check_against_jax(got["metrics"], got["states"][0], _jax_run(WORLD, 2))
    state = _port_state()
    step = make_train_step(torch.float32)
    with rank_threads():
        for i, (images, labels) in enumerate(_batches(2)):
            step(state, torch.from_numpy(images), torch.from_numpy(labels))
            for k, v in _numpy_state(state.model).items():
                atol = 1e-6 if "running" in k else 2e-6
                np.testing.assert_allclose(got["states"][i][k], v, rtol=1e-5, atol=atol,
                                           err_msg=f"step {i + 1} {k}, one process")


def test_aux_loss_matches_jax():
    """CE + 0.4·CE(aux) over the valid rows, as the JAX
    ``classification_loss`` on the ``(logits, aux)`` pair: rtol 1e-6."""
    import jax.numpy as jnp

    from mpi_pytorch_tpu.ops.losses import classification_loss as jax_loss

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(6, 11)).astype(np.float32) * 3
    aux = rng.normal(size=(6, 11)).astype(np.float32) * 3
    labels = np.array([1, 4, -1, 10, 0, -1], np.int32)
    got = classification_loss((torch.from_numpy(logits), torch.from_numpy(aux)),
                              torch.from_numpy(labels))
    expect = jax_loss((jnp.asarray(logits), jnp.asarray(aux)), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(expect), rtol=1e-6)
    plain = classification_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(plain), float(jax_loss(jnp.asarray(logits), labels)),
                               rtol=1e-6)


def test_dropout_masks_repeat_per_seed_differ_per_rank_and_scale_as_flax():
    """A mask is the generator's: the same (seed, rank, step) gives the same
    mask, another rank or step another. About 1 − p of the entries are
    kept (within 3σ of the binomial share), each as x / (1 − p) bit for
    bit, the rest exactly 0; stochastic depth keeps or drops whole
    samples."""
    p, n = 0.3, 200_000
    x = torch.randn(n // 100, 100, generator=torch.Generator().manual_seed(0))
    drop = Dropout(p).train()
    gen = torch.Generator()

    def mask(rank: int, step: int) -> torch.Tensor:
        drop.generator = gen.manual_seed(step_seed(7, rank, step))
        return drop(x)

    a = mask(0, 0)
    assert torch.equal(a, mask(0, 0))
    assert not torch.equal(a, mask(1, 0)) and not torch.equal(a, mask(0, 1))
    kept = a != 0
    share = float(kept.float().mean())
    assert abs(share - (1 - p)) < 3 * ((1 - p) * p / n) ** 0.5
    assert torch.equal(a[kept], torch.div(x, torch.tensor(1 - p))[kept])
    assert torch.equal(Dropout(p).eval()(x), x)
    depth = StochasticDepth(0.5).train()
    depth.generator = torch.Generator().manual_seed(1)
    y = depth(torch.ones(64, 3, 2, 2))
    per_sample = y.flatten(1)
    assert ((per_sample == 0).all(dim=1) | (per_sample == 2).all(dim=1)).all()
    assert 0 < int((per_sample[:, 0] == 0).sum()) < 64


def test_a_dropout_model_trains_from_the_state_generator():
    """alexnet (dropout 0.5 before each of its first two dense layers)
    takes steps through ``make_train_step`` with masks from the state's
    generator: a run repeats bit for bit from the same seed; without a
    generator the forward refuses to draw."""
    def run(seed: int) -> list[float]:
        bundle = create_model_bundle("alexnet", NUM_CLASSES, seed=0, image_size=64)
        model = prepare_for_training(bundle.model, torch.device("cpu"))
        opt, schedule = make_optimizer(model, LR, optimizer="sgd")
        state = TrainState(model=model, optimizer=opt, schedule=schedule,
                           generator=torch.Generator(), rng_seed=seed)
        step = make_train_step(torch.float32)
        rng = np.random.default_rng(0)
        out = []
        for _ in range(2):
            images = torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3)).astype(np.uint8))
            labels = torch.from_numpy(rng.integers(0, NUM_CLASSES, 4).astype(np.int32))
            out.append(float(step(state, images, labels)["loss"]))
        return out

    first = run(5)
    assert all(np.isfinite(first)) and first == run(5)
    bundle = create_model_bundle("alexnet", NUM_CLASSES, seed=0, image_size=64)
    with pytest.raises(RuntimeError, match="explicit generator"):
        bundle.model.train()(torch.zeros(2, 3, 64, 64))


@pytest.mark.parametrize("arch,size", [("squeezenet1_0", 64), ("inception_v3", 299)])
def test_feature_extract_masks_equal_jax(arch, size):
    """The parameters left trainable under ``feature_extract`` are the JAX
    ``head_filter``'s: squeezenet's 1×1 conv head, inception's head and
    auxiliary head (``AuxLogits/aux_head``, not the rest of AuxLogits)."""
    import jax
    import jax.numpy as jnp

    from mpi_pytorch_tpu.models.common import head_filter as jax_head_filter
    from mpi_pytorch_tpu.models.registry import initialize_model as jax_initialize_model

    jmodel, _ = jax_initialize_model(arch, NUM_CLASSES)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, size, size, 3), jnp.float32), train=True))
    expect = jax.tree_util.tree_map_with_path(
        lambda path, _: jax_head_filter([getattr(k, "key", str(k)) for k in path]),
        shapes["params"])
    bundle = create_model_bundle(arch, NUM_CLASSES, feature_extract=True, image_size=size)
    sd = dict(bundle.model.state_dict())
    for name, _ in bundle.model.named_parameters():
        sd[name] = torch.full_like(sd[name], float(bundle.trainable_mask[name]))
    got = to_flax_variables(sd, arch)["params"]
    flat_got = {jax.tree_util.keystr(p): bool(np.all(v == 1.0))
                for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    flat_expect = {jax.tree_util.keystr(p): v
                   for p, v in jax.tree_util.tree_flatten_with_path(expect)[0]}
    assert flat_got == flat_expect
    assert any(flat_expect.values())


ZOO = ("alexnet", "vgg11_bn", "squeezenet1_0", "densenet121", "inception_v3", "mobilenet_v2",
       "efficientnet_b0")


def _refusal(parse, argv) -> str:
    with pytest.raises(ValueError) as err:
        parse(argv)
    return str(err.value)


@pytest.mark.parametrize("argv", [
    *(["--model-name", m, "--fused-stem", "true"] for m in ZOO if m != "densenet121"),
    ["--model-name", "inception_v3", "--image-size", "128"],
    ["--model-name", "inception_v3", "--width", "224", "--height", "224"],
], ids=lambda a: "-".join(a[1::2]))
def test_config_refusals_in_jax_words(argv):
    from mpi_pytorch_tpu.config import parse_config as jax_parse_config

    assert _refusal(parse_config, argv) == _refusal(jax_parse_config, argv)


def test_config_takes_the_nine_cnns_and_refuses_the_rest_by_name():
    for m in ("resnet18", "resnet34", *ZOO):
        cfg = parse_config(["--model-name", m])
        assert cfg.image_size == ((299, 299) if m == "inception_v3" else (128, 128))
    parse_config(["--model-name", "densenet121", "--fused-stem", "true"])
    assert "MoE" in _refusal(parse_config, ["--model-name", "vit_moe_s16"])
    for m in ("squeezenet1_0", "inception_v3"):
        assert "ROADMAP A9" in _refusal(parse_config, ["--model-name", m,
                                                       "--mesh.model-parallel", "2"])


@pytest.mark.parametrize("arch,size", [("squeezenet1_0", 32), ("alexnet", 64)])
def test_server_serves_the_zoo_with_the_fused_head_or_its_fallback(arch, size):
    """``InferenceServer`` takes the zoo as the JAX one does: with
    ``--fused-head-eval`` alexnet's dense head runs the fused head (its
    plain version here) and answers as the plain server does; squeezenet's
    conv head falls back to the plain predict step (``stats()['fused_head']``
    False) with the same answers."""
    from mpi_pytorch_tpu_torch.config import Config
    from mpi_pytorch_tpu_torch.serve import InferenceServer

    images = np.random.default_rng(4).integers(0, 256, (6, size, size, 3)).astype(np.uint8)
    answers = {}
    for fused in (False, True):
        cfg = Config(model_name=arch, width=size, height=size, num_classes=300,
                     fused_head_eval=fused, serve_topk=1, input_dtype="uint8",
                     compute_dtype="float32", serve_buckets="1,8")
        with InferenceServer(cfg, device="cpu") as srv:
            answers[fused] = np.stack([f.result(timeout=120)
                                       for f in [srv.submit(im) for im in images]])
            assert srv.stats()["fused_head"] == (fused and arch != "squeezenet1_0")
    np.testing.assert_array_equal(answers[True], answers[False])
