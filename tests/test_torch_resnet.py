"""The port's resnet18, weight conversion and predict step against the JAX
package, on the CPU, in f32 on both sides.

Weights are a seeded random init of the port's model (random positive
batchnorm statistics, so the folded stem affine does real work), carried
to the JAX variable tree by ``to_flax_variables``. The JAX fused stem runs
its Pallas kernel in interpret mode (``MPT_STEM_INTERPRET=1``) and its
fused head likewise (``MPT_HEAD_INTERPRET=1``); the port runs the kernels'
plain versions. Eval logits: atol/rtol 1e-4 (f32 convolutions summed in
different orders across 18 layers). TF32 is off, so no f32 convolution or
matmul is cut to TF32 where the tests run on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.models import create_model_bundle
from mpi_pytorch_tpu.models.resnet import resnet18 as jax_resnet18
from mpi_pytorch_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from mpi_pytorch_tpu_torch.models.registry import (
    init_weights,
    initialize_model,
    prepare_for_inference,
)

NUM_CLASSES = 4100
SIZE = 32


@pytest.fixture(autouse=True)
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _port_model(fused_stem: bool, seed: int = 0):
    model, _ = initialize_model("resnet18", NUM_CLASSES, fused_stem=fused_stem)
    init_weights(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # a nonzero head bias, so its mapping is checked
        model.fc.bias.copy_(0.01 * torch.randn(NUM_CLASSES, generator=torch.Generator().manual_seed(seed + 1)))
    return prepare_for_inference(model, torch.device("cpu"), torch.float32)


def _jax_variables(model):
    return jax.tree_util.tree_map(jnp.asarray, to_flax_variables(model.state_dict(), "resnet18"))


def _images(seed: int, n: int = 4):
    return np.random.default_rng(seed).normal(size=(n, SIZE, SIZE, 3)).astype(np.float32)


def test_convert_round_trip_against_jax_tree():
    """to_flax(port) has exactly the JAX model's tree, and from_flax
    inverts it."""
    _, jax_vars = create_model_bundle(
        "resnet18", NUM_CLASSES, rng=jax.random.PRNGKey(0), image_size=SIZE
    )
    jax_vars = jax.tree_util.tree_map(np.asarray, jax_vars)
    sd = from_flax_variables(jax_vars, "resnet18")
    back = to_flax_variables(sd, "resnet18")
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jax_vars)
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jax_vars)):
        np.testing.assert_array_equal(x, y)
    model = _port_model(fused_stem=False)
    sd2 = from_flax_variables(to_flax_variables(model.state_dict(), "resnet18"), "resnet18")
    assert sd2.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(sd2[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("fused_stem", [True, False])
def test_eval_logits_match_jax(fused_stem, monkeypatch):
    monkeypatch.setenv("MPT_STEM_INTERPRET", "1")
    model = _port_model(fused_stem)
    variables = _jax_variables(model)
    jax_model = jax_resnet18(NUM_CLASSES, dtype=jnp.float32, fused_stem=fused_stem)
    x = _images(0)
    ref = np.asarray(jax_model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_fused_predict_step_matches_jax(monkeypatch):
    """The port's fused predict step (plain stem + plain streaming head on
    the CPU) against JAX ``_make_predict_step(mesh1, f32, fused_head=True)``
    with both Pallas kernels interpreted, on uint8 pixels."""
    import optax
    from jax.sharding import Mesh

    from mpi_pytorch_tpu.evaluate import _make_predict_step, _make_predict_step_impl
    from mpi_pytorch_tpu.train.state import TrainState
    from mpi_pytorch_tpu_torch.evaluate import make_predict_step

    model = _port_model(fused_stem=True, seed=3)
    jax_model = jax_resnet18(NUM_CLASSES, dtype=jnp.float32, fused_stem=True)
    state = TrainState.create(
        apply_fn=jax_model.apply, variables=_jax_variables(model),
        tx=optax.identity(), rng=jax.random.PRNGKey(1),
    )
    mesh1 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    images = np.random.default_rng(4).integers(0, 256, size=(8, SIZE, SIZE, 3)).astype(np.uint8)
    labels = np.array([3, 5, -1, 9, 0, 1, -1, 4099], np.int32)
    monkeypatch.setenv("MPT_STEM_INTERPRET", "1")
    monkeypatch.setenv("MPT_HEAD_INTERPRET", "1")
    _make_predict_step_impl.cache_clear()
    try:
        step = _make_predict_step(mesh1, jnp.float32, fused_head=True)
        ref_m, ref_p = step(state, (jnp.asarray(images), jnp.asarray(labels)))
    finally:
        _make_predict_step_impl.cache_clear()
    got_m, got_p = make_predict_step(torch.float32, fused_head=True)(
        model, torch.from_numpy(images), torch.from_numpy(labels)
    )
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    for k in ("loss", "correct", "count"):
        np.testing.assert_allclose(float(got_m[k]), float(ref_m[k]), rtol=1e-4, atol=1e-4)
    # Plain path: top-1 is the fused argmax, and the metrics agree.
    plain_m, plain_p = make_predict_step(torch.float32, topk=3)(
        model, torch.from_numpy(images), torch.from_numpy(labels)
    )
    np.testing.assert_array_equal(plain_p[:, 0].numpy(), got_p.numpy())
    for k in ("loss", "correct", "count"):
        np.testing.assert_allclose(float(plain_m[k]), float(got_m[k]), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="argmax only"):
        make_predict_step(torch.float32, fused_head=True, topk=3)


def test_ingest_and_metrics_match_jax():
    from mpi_pytorch_tpu.train.step import ingest_images as jax_ingest
    from mpi_pytorch_tpu.train.step import metrics_from_logits as jax_metrics
    from mpi_pytorch_tpu_torch.train.step import ingest_images, metrics_from_logits

    rng = np.random.default_rng(5)
    px = rng.integers(0, 256, size=(2, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        ingest_images(torch.from_numpy(px), torch.float32).numpy(),
        np.asarray(jax_ingest(jnp.asarray(px), jnp.float32)),
    )
    logits = rng.normal(size=(6, 50)).astype(np.float32)
    labels = np.array([1, -1, 49, 0, -1, 7], np.int32)
    ref = jax_metrics(jnp.asarray(logits), jnp.asarray(labels))
    got = metrics_from_logits(torch.from_numpy(logits), torch.from_numpy(labels))
    for k in ("loss", "correct", "count"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6)


def test_fused_stem_module_refuses_training_mode():
    model, _ = initialize_model("resnet18", 10, fused_stem=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        model(torch.zeros(1, 3, SIZE, SIZE))
