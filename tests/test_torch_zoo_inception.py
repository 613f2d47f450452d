"""The port's inception_v3 against the JAX package's module, on the CPU
(TF32 off).

Blocks A to E and ``InceptionAux`` at their widths and small spatial
sizes (A, C 5×5; B, D 7×7; E 3×3; the auxiliary head 17×17, the least
its 5×5/s3 pool and 5×5 valid conv take), batch 2, seeded weights carried
to the JAX tree by ``to_flax_variables``: the f32 eval and train-mode
outputs (rtol 1e-4, atol 1e-4 and 5e-4 of the largest magnitude, as in
``test_torch_zoo_models.py``), then in float64 on both sides the
train-mode output, the updated batch statistics and every parameter's
gradient of ``Σ out·r`` for a fixed random ``r`` (rtol 1e-6, atol 1e-6
of the tensor's largest magnitude or 1e-8 of the block's largest
gradient).

The whole model at 299 px, batch 1, 10 classes, dropout off: the eval
logits, and the train-mode ``(logits, aux)`` pair (f32, the same
tolerances), with the JAX forwards compiled once in a module fixture. The
train-mode loss is CE + 0.4·CE(aux) (``ops.losses.classification_loss``
against the JAX one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.models import inception as jax_inception
from mpi_pytorch_tpu.ops.losses import classification_loss as jax_loss
from mpi_pytorch_tpu_torch.models import inception
from mpi_pytorch_tpu_torch.models.convert import to_flax_variables
from mpi_pytorch_tpu_torch.models.registry import init_weights
from mpi_pytorch_tpu_torch.ops.losses import classification_loss
from test_torch_zoo_models import _close, _tree_close, no_tf32  # noqa: F401

NUM_CLASSES = 10


def _seeded(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    init_weights(module, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=gen))
    return module.float()


def _flax(module: torch.nn.Module, aux: bool = False) -> dict:
    """The module's flax tree; a standalone ``InceptionAux``'s dense is
    flax ``aux_head``."""
    tree = to_flax_variables(module.state_dict(), "inception_v3")
    if aux:
        tree["params"]["aux_head"] = tree["params"].pop("head")
    return tree


# name → (port block, JAX block factory (dtype kwargs), NHWC input shape)
BLOCKS = {
    "A": (lambda: inception.InceptionA(192, 32),
          lambda **kw: jax_inception.InceptionA(pool_features=32, **kw), (2, 5, 5, 192)),
    "B": (lambda: inception.InceptionB(288), lambda **kw: jax_inception.InceptionB(**kw),
          (2, 7, 7, 288)),
    "C": (lambda: inception.InceptionC(768, 128),
          lambda **kw: jax_inception.InceptionC(channels_7x7=128, **kw), (2, 5, 5, 768)),
    "D": (lambda: inception.InceptionD(768), lambda **kw: jax_inception.InceptionD(**kw),
          (2, 7, 7, 768)),
    "E": (lambda: inception.InceptionE(1280), lambda **kw: jax_inception.InceptionE(**kw),
          (2, 3, 3, 1280)),
    "Aux": (lambda: inception.InceptionAux(768, NUM_CLASSES),
            lambda **kw: jax_inception.InceptionAux(NUM_CLASSES, **kw), (2, 17, 17, 768)),
}


def _port_out(out: torch.Tensor) -> np.ndarray:
    """A block's NCHW output as NHWC numpy (the aux head's [B, V] as it is)."""
    out = out.detach()
    return (out.permute(0, 2, 3, 1) if out.dim() == 4 else out).numpy()


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name):
    make, jax_make, shape = BLOCKS[name]
    aux = name == "Aux"
    x_np = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    x = torch.from_numpy(x_np).permute(0, 3, 1, 2)
    block = _seeded(make())
    tree = _flax(block, aux)
    jblock = jax_make()

    def forwards(v, x):
        out, upd = jblock.apply(v, x, train=True, mutable=["batch_stats"])
        return jblock.apply(v, x, train=False), out, upd["batch_stats"]

    j_eval, j_train, _ = jax.jit(forwards)(jax.tree_util.tree_map(jnp.asarray, tree), x_np)
    with torch.no_grad():
        p_eval = _port_out(block.eval()(x))
        p_train = _port_out(block.train()(x))
    _close(p_eval, j_eval, 1e-4, 1e-4, f"{name} f32 eval")
    _close(p_train, j_train, 1e-4, 5e-4, f"{name} f32 train")

    r = np.random.default_rng(1).normal(size=j_train.shape)
    block = _seeded(make()).double().train()
    out = block(x.double())
    (torch.from_numpy(r if aux else r.transpose(0, 3, 1, 2)) * out).sum().backward()
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
        jblock64 = jax_make(dtype=jnp.float64, param_dtype=jnp.float64)

        def loss(params):
            o, upd = jblock64.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                    x_np.astype(np.float64), train=True, mutable=["batch_stats"])
            return jnp.sum(o * r), (o, upd["batch_stats"])

        (_, (j_out, j_bs)), j_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            v64["params"])
        j_out, j_bs, j_grads = jax.device_get((j_out, j_bs, j_grads))
    _close(_port_out(out), j_out, 1e-6, 1e-6, f"{name} f64 train")
    _tree_close(_flax(block, aux)["batch_stats"], j_bs, 1e-6, 1e-6, f"{name} f64 batch stats")
    sd = {k: v.detach().clone() for k, v in block.state_dict().items()}
    sd.update({n: p.grad.detach().clone() for n, p in block.named_parameters()})
    grads = to_flax_variables(sd, "inception_v3")["params"]
    if aux:
        grads["aux_head"] = grads.pop("head")
    _tree_close(grads, j_grads, 1e-6, 1e-6, f"{name} f64 grads", floor=1e-8)


@pytest.fixture(scope="module")
def whole_model():
    """The port's inception_v3 and the JAX forwards (eval; train with the
    aux pair) on one 299-px image, compiled once."""
    model = _seeded(inception.inception_v3(NUM_CLASSES, dropout_rate=0.0))
    jmodel = jax_inception.InceptionV3(num_classes=NUM_CLASSES, dropout_rate=0.0)
    x_np = np.random.default_rng(2).normal(size=(1, 299, 299, 3)).astype(np.float32)

    def forwards(v, x):
        out, _ = jmodel.apply(v, x, train=True, mutable=["batch_stats"])
        return jmodel.apply(v, x, train=False), out

    tree = jax.tree_util.tree_map(jnp.asarray, _flax(model))
    j_eval, (j_logits, j_aux) = jax.jit(forwards)(tree, x_np)
    return model, x_np, np.asarray(j_eval), np.asarray(j_logits), np.asarray(j_aux)


def test_whole_model_eval_logits_match_jax(whole_model):
    model, x_np, j_eval, _, _ = whole_model
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x_np).permute(0, 3, 1, 2))
    assert isinstance(out, torch.Tensor)  # no auxiliary branch in eval mode
    _close(out.numpy(), j_eval, 1e-4, 1e-4, "inception eval logits")


def test_whole_model_train_forward_returns_the_aux_pair_as_jax(whole_model):
    model, x_np, _, j_logits, j_aux = whole_model
    with torch.no_grad():
        logits, aux = model.train()(torch.from_numpy(x_np).permute(0, 3, 1, 2))
    _close(logits.numpy(), j_logits, 1e-4, 5e-4, "inception train logits")
    _close(aux.numpy(), j_aux, 1e-4, 5e-4, "inception aux logits")
    labels = np.array([3], np.int32)
    expect = float(jax_loss((jnp.asarray(j_logits), jnp.asarray(j_aux)), labels))
    got = float(classification_loss((logits, aux), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, expect, rtol=1e-4)
