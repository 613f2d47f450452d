"""The port's training cross-entropy head ``fused_head_ce`` (its plain
forward and backward, as it runs on the CPU) against the JAX op with its
Pallas kernels in interpret mode: the per-row loss and the gradients of
feats, W and b under a per-row upstream gradient, padding rows included.

Inputs come from numpy seeds; the port takes W as [V, D], the JAX op
[D, V]. Both round feats and W to bf16, so the comparison is of the same
bf16 operands: loss rtol 1e-5; gradients rtol 1e-3, atol 1e-5. dlog is
rounded to bf16 on both sides and then summed in f32 in another order; a
dlog within an f32 ulp of a bf16 rounding boundary may round either way
(the two exps differ in their last bit), and at these vocab sizes (p ≈
1/V) one such flip moves a gradient element by less than 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpi_pytorch_tpu.ops.fused_head_ce import fused_head_ce as jax_fused_head_ce
from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh

# (B, D, V): ragged vocabularies against the JAX blocks (2 048 forward,
# 1 024 backward): 5 000, and 2 100 with a nearly empty last block.
CASES = [(16, 64, 5000), (9, 32, 2100)]


def _inputs(b: int, d: int, v: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, d)).astype(np.float32)
    w = (rng.normal(size=(v, d)) * 0.05).astype(np.float32)  # the port's [V, D]
    bias = (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, size=(b,)).astype(np.int32)
    labels[3] = -1  # padding rows
    labels[-1] = -1
    g = rng.uniform(0.1, 2.0, size=(b,)).astype(np.float32)
    return feats, w, bias, labels, g


def _port(feats, w, bias, labels, g, fn=fh.fused_head_ce):
    leaves = [torch.from_numpy(x.copy()).requires_grad_() for x in (feats, w, bias)]
    loss = fn(*leaves, torch.from_numpy(labels))
    loss.backward(torch.from_numpy(g))
    return loss.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax(feats, w, bias, labels, g):
    lab = jnp.asarray(labels)

    def total(f, w_t, b):
        return jnp.sum(jax_fused_head_ce(f, w_t, b, lab, interpret=True) * jnp.asarray(g))

    args = (jnp.asarray(feats), jnp.asarray(w.T), jnp.asarray(bias))
    loss = jax_fused_head_ce(*args, lab, interpret=True)
    gf, gw, gb = jax.grad(total, argnums=(0, 1, 2))(*args)
    return np.asarray(loss), [np.asarray(gf), np.asarray(gw).T, np.asarray(gb)]


@pytest.mark.parametrize("b, d, v", CASES, ids=[f"B{b}_D{d}_V{v}" for b, d, v in CASES])
def test_loss_and_grads_match_jax(b, d, v):
    inputs = _inputs(b, d, v)
    loss, grads = _port(*inputs)
    want_loss, want_grads = _jax(*inputs)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=0)
    for name, got, want in zip(("dfeats", "dW", "db"), grads, want_grads):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5, err_msg=name)


def test_padding_rows_have_zero_loss_and_gradient():
    feats, w, bias, labels, g = _inputs(*CASES[1], seed=1)
    loss, (dfeats, _, _) = _port(feats, w, bias, labels, g)
    for row in (3, len(labels) - 1):
        assert loss[row] == 0.0
        np.testing.assert_array_equal(dfeats[row], np.zeros_like(dfeats[row]))


def test_gradient_dtypes_follow_the_inputs():
    """dfeats comes back in feats' dtype holding bf16 values (the kernel's
    rounding), dW and db in the dtypes of W and b."""
    feats, w, bias, labels, g = _inputs(*CASES[1], seed=2)
    f = torch.from_numpy(feats).requires_grad_()
    wb = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    fh.fused_head_ce(f, wb, b, torch.from_numpy(labels)).backward(torch.from_numpy(g))
    assert f.grad.dtype == torch.float32 and wb.grad.dtype == torch.bfloat16
    assert b.grad.dtype == torch.float32
    torch.testing.assert_close(f.grad, f.grad.to(torch.bfloat16).float(), rtol=0, atol=0)


def test_plain_forward_is_cross_entropy_over_bf16_operands():
    """The plain forward's (loss, m, l) are CE, the row max and the row's
    sum of exp over the bf16-rounded logits."""
    feats, w, bias, labels, _ = _inputs(*CASES[0], seed=3)
    fb = torch.from_numpy(feats).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    b, lab = torch.from_numpy(bias), torch.from_numpy(labels)
    loss, m, l = fh.fused_head_ce_forward_reference(fb, wb, b, lab)
    logits = fb.float() @ wb.float().t() + b
    want = F.cross_entropy(logits, lab.clamp(min=0).long(), reduction="none") * (lab >= 0)
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(m, logits.amax(dim=-1))
    torch.testing.assert_close(torch.log(l) + m, torch.logsumexp(logits, dim=-1), rtol=1e-6, atol=1e-5)


def test_plain_backward_matches_autograd():
    """The written-out backward against autograd through f32 CE on the same
    bf16 operands: equal up to the bf16 rounding of dlog."""
    feats, w, bias, labels, g = _inputs(*CASES[0], seed=4)
    _, grads = _port(feats, w, bias, labels, g)
    leaves = [torch.from_numpy(x).to(torch.bfloat16).float().requires_grad_() for x in (feats, w)]
    b = torch.from_numpy(bias).requires_grad_()
    lab = torch.from_numpy(labels)
    per = F.cross_entropy(leaves[0] @ leaves[1].t() + b, lab.clamp(min=0).long(), reduction="none")
    (per * (lab >= 0) * torch.from_numpy(g)).sum().backward()
    for got, want in zip(grads, (leaves[0].grad, leaves[1].grad, b.grad)):
        np.testing.assert_allclose(got, want.numpy(), rtol=2e-2, atol=2e-3)


def test_reference_is_the_cpu_path():
    """On CPU tensors the op is its plain version, bit for bit."""
    inputs = _inputs(*CASES[1], seed=5)
    loss, grads = _port(*inputs)
    loss_r, grads_r = _port(*inputs, fn=fh.fused_head_ce_reference)
    np.testing.assert_array_equal(loss, loss_r)
    for got, want in zip(grads, grads_r):
        np.testing.assert_array_equal(got, want)
    assert fh.ce_forward_counter.count == 0 and fh.ce_backward_counter.count == 0
