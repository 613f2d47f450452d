"""The plain predict step's top-k breaks ties as the JAX package's does
(``jax.lax.top_k``, ``mpi_pytorch_tpu/evaluate.py``): equal values in
index order, so column 0 is the first-index argmax.

``torch.topk`` leaves the order of equal values unspecified, and bf16
logits (8 significant bits) tie often; ``ops.losses.topk_indices`` selects
over a key that orders ties by index. The logits here are bf16-rounded
with planted ties: across the k-th place, a row whose top k all tie, ±0,
NaN. The indices must equal ``lax.top_k``'s exactly (a selection has no
tolerance). ``lax.top_k`` orders floats totally: a +0.0 comes before an
earlier −0.0, which the last tests pin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu_torch.evaluate import make_predict_step
from mpi_pytorch_tpu_torch.models.registry import init_weights, initialize_model, prepare_for_inference
from mpi_pytorch_tpu_torch.ops.losses import topk_indices
from mpi_pytorch_tpu_torch.train.step import ingest_images

V = 300


def _tied_logits(seed: int, rows: int = 64) -> np.ndarray:
    """bf16-rounded f32 logits [rows, V] drawn from few levels (ties
    everywhere), then rows with planted ties: the top value held by many
    columns (more than k), ties straddling the k-th place, ±0 maxima, NaN."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 9, size=(rows, V)).astype(np.float32) * 0.375
    x += rng.normal(size=(rows, V)).astype(np.float32) * (rng.random((rows, 1)) < 0.5)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    top = float(x.max()) + 1
    x[0, [7, 3, 250, 11, 90, 4, 299]] = top  # all of the top k tie
    x[1, [20, 5]] = top  # two leaders, then a tie across the k-th place
    x[1, [30, 1, 200, 150, 77]] = top - 1
    x[2] = np.where(np.arange(V) % 2, 0.0, -0.0)  # ±0 everywhere
    x[3, :] = -1.0
    x[3, [9, 40]] = -0.0
    x[3, [60, 2]] = 0.0
    x[4, [13, 8]] = np.nan
    x[4, 100] = top
    x[5, :] = -np.inf
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [2, 5])
def test_topk_indices_match_lax_top_k(k, seed):
    x = _tied_logits(seed)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
    got = topk_indices(torch.from_numpy(x), k)
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(x), k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_column_zero_is_the_first_index_argmax(seed):
    """Wherever the row's max is not a signed zero, column 0 is the first
    column attaining the max: what the ``topk == 1`` branch returns."""
    x = _tied_logits(seed)
    got = topk_indices(torch.from_numpy(x), 5)[:, 0].numpy()
    want = torch.argmax(torch.from_numpy(x), dim=-1).numpy()
    zero_max = np.nanmax(x, axis=-1) == 0
    assert zero_max.sum() == 2  # rows 2 and 3
    np.testing.assert_array_equal(got[~zero_max], want[~zero_max])


def test_signed_zeros_order_as_lax_top_k():
    """``lax.top_k`` puts +0.0 before −0.0 whatever their columns (its total
    order), so on a row whose max is a zero of both signs column 0 is the
    first +0.0, not the first-index argmax; the port does the same."""
    x = np.array([[-0.0, 0.0, -0.0, 0.0, -1.0], [0.0, -0.0, -2.0, -0.0, 0.0]], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), 4)[1])
    np.testing.assert_array_equal(want, [[1, 3, 0, 2], [0, 4, 1, 3]])
    np.testing.assert_array_equal(topk_indices(torch.from_numpy(x), 4).numpy(), want)


def test_predict_step_topk_breaks_ties_by_index():
    """Through ``make_predict_step(torch.float32, topk=5)`` on a small
    resnet18 whose head has six identical rows (and biases) that dominate:
    every row's top 5 is the first five of them in index order, column 0 is
    the ``topk == 1`` argmax, and the indices equal ``lax.top_k`` over the
    model's own logits."""
    tied = [5, 17, 40, 41, 99, 100]
    model, _ = initialize_model("resnet18", V)
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        w = model.fc.weight
        w.copy_((0.001 * torch.randn(w.shape, generator=torch.Generator().manual_seed(1)))
                .to(torch.bfloat16).float())
        w[tied] = 0.5  # pooled features are ≥ 0: these lead every other row
        model.fc.bias.zero_()
    model = prepare_for_inference(model, torch.device("cpu"), torch.float32)
    images = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, size=(6, 32, 32, 3)).astype(np.uint8))
    labels = torch.tensor([5, 17, -1, 3, 0, 100], dtype=torch.int32)
    _, top5 = make_predict_step(torch.float32, topk=5)(model, images, labels)
    _, top1 = make_predict_step(torch.float32)(model, images, labels)
    np.testing.assert_array_equal(top5.numpy(), np.tile(tied[:5], (6, 1)))
    np.testing.assert_array_equal(top5[:, 0].numpy(), top1.numpy())
    with torch.no_grad():
        logits = model(ingest_images(images, torch.float32).permute(0, 3, 1, 2)).float()
    assert bool((logits[:, tied] == logits[:, tied[:1]]).all())  # the ties are exact
    np.testing.assert_array_equal(
        topk_indices(logits, 5).numpy(), np.asarray(jax.lax.top_k(jnp.asarray(logits.numpy()), 5)[1]))
