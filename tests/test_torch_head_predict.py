"""The port's streaming predict head (``mpi_pytorch_tpu_torch/ops/
fused_head_ce.py``) against the JAX package's Pallas kernel run in
interpret mode.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel it stands for is held against the same plain version on the card by
``chip_smoke.py``. The port takes W as [V, D] (K-major), the JAX function
as [D, V]; the same numpy weights go to both.

V = 4100 spans more than two of the Pallas kernel's 2048-wide vocab blocks
plus padding. Duplicated W columns make exact ties within one block (3 and
7) and across blocks (5 and 2053): both sides must pick the first index.
Tolerance: predictions exact, loss rtol 1e-5 (both sides sum in f32, in
different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.ops.fused_head_ce import head_predict as jax_head_predict
from mpi_pytorch_tpu_torch.ops import fused_head_ce as port

B, D, V = 12, 32, 4100


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    w = (0.1 * rng.normal(size=(D, V))).astype(np.float32)
    w[0, 3] += 4.0
    w[:, 7] = w[:, 3]  # tie inside the first block
    w[1, 5] += 4.0
    w[:, 2053] = w[:, 5]  # tie across blocks 0 and 1
    b = (0.1 * rng.normal(size=(V,))).astype(np.float32)
    b[7], b[2053] = b[3], b[5]
    feats = (0.1 * rng.normal(size=(B, D))).astype(np.float32)
    feats[0::3, 0] = 1.0  # these rows' argmax is the 3 / 7 tie
    feats[1::3, 1] = 1.0  # these rows' argmax is the 5 / 2053 tie
    labels = np.array([-1, 0, 2047, 2048, V - 1, 3, 7, 5, 2053, -1, 11, 4000], np.int32)
    return feats, w, b, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_head_matches_pallas(dtype):
    feats, w, b, labels = _inputs(0)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ref_loss, ref_pred = jax_head_predict(
        jnp.asarray(feats).astype(jdt), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(labels), interpret=True,
    )
    # The JAX wrapper casts W to the feature dtype; the port's caller does
    # that once (serve/executables.py), so the plain version gets it cast.
    got_loss, got_pred = port.head_predict(
        torch.from_numpy(feats).to(tdt), torch.from_numpy(w.T.copy()).to(tdt),
        torch.from_numpy(b), torch.from_numpy(labels),
    )
    assert got_pred.dtype == torch.int32 and got_loss.dtype == torch.float32
    ref_pred = np.asarray(ref_pred)
    np.testing.assert_array_equal(got_pred.numpy(), ref_pred)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(ref_loss), rtol=1e-5, atol=0)
    # The tie rows really exercise the tie rule.
    assert set(ref_pred[0::3]) == {3} and set(ref_pred[1::3]) == {5}
    assert np.all(got_loss.numpy()[labels < 0] == 0)


def test_head_ce_reference_matches_logsumexp():
    feats, w, b, labels = _inputs(1)
    f, wt, bt = torch.from_numpy(feats), torch.from_numpy(w.T.copy()), torch.from_numpy(b)
    lt = torch.from_numpy(labels)
    loss = port.head_ce_reference(f, wt, bt, lt).double().numpy()
    logits = feats.astype(np.float64) @ w.astype(np.float64) + b
    lse = np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1)) + logits.max(1)
    want = np.where(labels >= 0, lse - logits[np.arange(B), np.maximum(labels, 0)], 0.0)
    np.testing.assert_allclose(loss, want, rtol=1e-5, atol=1e-6)


def test_head_shape_guards_and_no_fallback_off_cpu():
    f, w = torch.zeros(4, 32), torch.zeros(10, 32)
    b, lab = torch.zeros(10), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="w \\[V, D\\]"):
        port.head_predict(f, torch.zeros(32, 10), b, lab)
    with pytest.raises(ValueError, match="b \\[V\\]"):
        port.head_predict(f, w, torch.zeros(9), lab)
    before = port.counter.count
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.head_predict(f.to("meta"), w.to("meta"), b.to("meta"), lab.to("meta"))
    port.head_predict(f, w, b, lab)
    assert port.counter.count == before
