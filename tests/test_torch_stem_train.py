"""The fused stem's training half and the training-mode batchnorm of the
port against the JAX package, on the CPU, in f32.

- The window-index forward's plain version (``stem_pool_argmax_reference``)
  against the Pallas ``_fwd_impl(want_idx=True)`` in interpret mode, in
  the kernel's T-space: k exactly equal, pooled atol 1e-6 (the two round
  ``y·a + b`` as two ops or as one fused multiply-add: a gap of a few f32
  ulps, see tests/test_torch_fused_stem.py).
- ``_StemPool``'s gradients (the port's own backward formula, plain
  versions on the CPU) against ``jax.grad`` through the Pallas pair in
  interpret mode: dy atol 1e-6; da/db rtol 1e-5 (sums over B·H·W in
  different orders), plus atol 1e-5 for channels whose sum cancels to
  near zero.
- ``BatchNorm`` and ``FusedStemBNReluPool`` in training mode against flax
  ``BatchNorm`` and the JAX fused module (Pallas interpreted): outputs
  atol 1e-5, the biased running statistics rtol 1e-5 (plus atol 1e-7: a
  batch mean of order-1 values summed in another order carries ~1e-7 of
  absolute error, which a mean near zero turns into a large relative one),
  and the gradients to γ, β and the input rtol 1e-4 / atol 1e-5 (the
  statistics' gradient sums over the whole batch).

Inputs are made from seeds with numpy and handed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.models.common import FusedStemBNReluPool as JaxFusedStem
from mpi_pytorch_tpu.models.common import batch_norm as jax_batch_norm
from mpi_pytorch_tpu.ops import fused_stem as jax_fs
from mpi_pytorch_tpu_torch.models.common import BatchNorm, FusedStemBNReluPool
from mpi_pytorch_tpu_torch.ops import fused_stem as port

SHAPE = (8, 16, 16, 64)


def _inputs(seed: int, tie_heavy: bool, shape=SHAPE):
    rng = np.random.default_rng(seed)
    if tie_heavy:
        # Values on a coarse grid: most 3×3 windows hold ties.
        y = rng.integers(-2, 3, size=shape).astype(np.float32)
    else:
        y = rng.normal(size=shape).astype(np.float32)
    c = shape[-1]
    a = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    b = rng.normal(scale=0.5, size=(c,)).astype(np.float32)
    g = rng.normal(size=(shape[0], shape[1] // 2, shape[2] // 2, c)).astype(np.float32)
    return y, a, b, g


@pytest.mark.parametrize("case", ["random", "tie_heavy"])
def test_window_index_forward_matches_pallas(case):
    y, a, b, _ = _inputs(10, case == "tie_heavy")
    yt = jnp.transpose(jnp.asarray(y), (1, 2, 3, 0))
    ref_p, ref_k = jax_fs._fwd_impl(yt, jnp.asarray(a), jnp.asarray(b), want_idx=True, interpret=True)
    ref_p = np.transpose(np.asarray(ref_p), (3, 0, 1, 2))
    ref_k = np.transpose(np.asarray(ref_k.astype(jnp.float32)), (3, 0, 1, 2)).astype(np.int8)
    pooled, k = port.stem_pool_argmax(*(torch.from_numpy(t) for t in (y, a, b)))
    assert k.dtype == torch.int8 and pooled.dtype == torch.float32
    np.testing.assert_array_equal(k.numpy(), ref_k)
    np.testing.assert_allclose(pooled.numpy(), ref_p, rtol=0, atol=1e-6)
    if case == "tie_heavy":  # the tie rule is really exercised
        assert (ref_k != 4).mean() > 0.3
    # The training forward's pooled values are the eval forward's.
    np.testing.assert_array_equal(
        pooled.numpy(),
        port.stem_affine_relu_pool_reference(*(torch.from_numpy(t) for t in (y, a, b))).numpy(),
    )


@pytest.mark.parametrize("case", ["random", "tie_heavy"])
def test_stem_gradients_match_pallas(case):
    y, a, b, g = _inputs(11, case == "tie_heavy")

    def loss(y_, a_, b_):
        return jnp.sum(jax_fs.stem_affine_relu_pool(y_, a_, b_, interpret=True) * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(y), jnp.asarray(a), jnp.asarray(b))
    ty, ta, tb = (torch.from_numpy(t).requires_grad_() for t in (y, a, b))
    out = port.stem_affine_relu_pool(ty, ta, tb)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(ref[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(ref[2]), rtol=1e-5, atol=1e-5)
    assert np.abs(ty.grad.numpy()).max() > 0


@pytest.mark.parametrize("case", ["random", "tie_heavy"])
def test_backward_reference_matches_max_pool_autograd(case):
    """The plain backward against torch's own autograd through the plain
    eval forward (relu → max_pool2d, whose backward also routes each window
    to its first max): atol 1e-6 (the two sum an input's ≤4 windows in
    different orders)."""
    y, a, b, g = _inputs(12, case == "tie_heavy", shape=(2, 8, 8, 16))
    ty, ta, tb = (torch.from_numpy(t).requires_grad_() for t in (y, a, b))
    (port.stem_affine_relu_pool_reference(ty, ta, tb) * torch.from_numpy(g)).sum().backward()
    with torch.no_grad():
        pooled, k = port.stem_pool_argmax_reference(ty, ta, tb)
        dy, da, db = port.stem_pool_backward_reference(torch.from_numpy(g), k, pooled, ty, ta)
    np.testing.assert_allclose(dy.numpy(), ty.grad.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(da.numpy(), ta.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(db.numpy(), tb.grad.numpy(), rtol=1e-5, atol=1e-5)


def _bn_variables(c, rng):
    return {
        "params": {
            "scale": rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32),
            "bias": rng.normal(scale=0.1, size=(c,)).astype(np.float32),
        },
        "batch_stats": {
            "mean": rng.normal(scale=0.1, size=(c,)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32),
        },
    }


def _port_bn(cls, variables):
    c = variables["params"]["scale"].shape[0]
    m = cls(c)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        m.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        m.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        m.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    return m.train()


@pytest.mark.parametrize("fused", [False, True], ids=["batch_norm", "fused_stem"])
def test_training_batchnorm_matches_jax(fused, monkeypatch):
    monkeypatch.setenv("MPT_STEM_INTERPRET", "1")
    rng = np.random.default_rng(14)
    x = (1.5 * rng.normal(size=(4, 16, 16, 64)) + 0.3).astype(np.float32)  # NHWC
    variables = _bn_variables(64, rng)
    out_shape = (4, 8, 8, 64) if fused else x.shape
    g = rng.normal(size=out_shape).astype(np.float32)
    jax_mod = JaxFusedStem() if fused else jax_batch_norm()

    def loss(params, x_):
        out, upd = jax_mod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x_,
            use_running_average=False, mutable=["batch_stats"],
        )
        return jnp.sum(out * g), (out, upd["batch_stats"])

    (_, (ref_out, ref_stats)), (ref_gp, ref_gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True
    )(jax.tree_util.tree_map(jnp.asarray, variables["params"]), jnp.asarray(x))

    m = _port_bn(FusedStemBNReluPool if fused else BatchNorm, variables)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()  # channels_last NCHW
    out = m(tx)
    (out.permute(0, 2, 3, 1) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref_out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(ref_stats["mean"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(ref_stats["var"]), rtol=1e-5, atol=1e-7)
    # The BIASED batch variance went into the running update.
    xf = x.reshape(-1, 64).astype(np.float64)
    np.testing.assert_allclose(
        m.running_var.numpy(), 0.9 * variables["batch_stats"]["var"] + 0.1 * xf.var(axis=0), rtol=1e-5
    )
    np.testing.assert_allclose(m.weight.grad.numpy(), np.asarray(ref_gp["scale"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(m.bias.grad.numpy(), np.asarray(ref_gp["bias"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(ref_gx), rtol=1e-4, atol=1e-5
    )


def test_batchnorm_eval_mode_uses_running_stats():
    rng = np.random.default_rng(15)
    variables = _bn_variables(8, rng)
    m = _port_bn(BatchNorm, variables).eval()
    x = rng.normal(size=(2, 8, 4, 4)).astype(np.float32)
    before = m.running_var.clone()
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    p, s = variables["params"], variables["batch_stats"]
    want = (x - s["mean"][:, None, None]) / np.sqrt(s["var"][:, None, None] + 1e-5)
    want = want * p["scale"][:, None, None] + p["bias"][:, None, None]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(m.running_var, before)
