"""Gradient accumulation (``--accum-steps``) of the auto step against the
JAX package's accumulating step, on the CPU, in f32
(``train/step.make_train_step(accum_steps=...)``).

resnet18 at 64 px with the fused stem and a 10-class head (the
conventions of ``tests/test_torch_auto_levers.py``), global batch 16 in
``ACCUM = 4`` microbatches — 4 rows a microbatch in one process, 2 a rank
on two ranks, so each microbatch's last batchnorm still normalizes 16
values a channel — SGD, two steps: step 1 with padding rows placed
unevenly across the microbatches, step 2 with one.

- One process and two ranks against JAX's ``make_train_step(
  accum_steps=4, mesh=...)`` on one and on two devices: each rank splits
  its own rows into contiguous microbatches (JAX's device-local split), so
  microbatch j holds the same rows on both sides, and the batchnorm
  statistics update once a microbatch on both. The tolerances of
  ``tests/test_torch_dp_step.py``: loss, ``correct``, ``count`` and the
  step-1 grad norm rtol 1e-4; after step 1 every parameter rtol 1e-5
  plus atol 2e-6 and statistic rtol 1e-5 plus atol 1e-6.
- The two-rank run against the one-process run on the same microbatches
  (the global batch reordered so that one-process microbatch j holds each
  rank's microbatch j): losses rtol 1e-5, grad norms rtol 1e-4 (2.9e-5
  apart, measured: each microbatch's batchnorm sums two ranks' partial
  statistics of 2 rows each), the state after step 1 rtol 1e-5 plus atol
  2e-6 (statistics 1e-6) — after step 2 ``conv1``, the deepest gradient,
  sits 3.8e-6 apart, the amplification through the batchnorm backward
  for which ``tests/test_torch_dp_step.py`` holds JAX's state after step
  1 only.
- A model without batchnorm (JAX ``test_grad_accumulation_matches_full_
  batch``'s MLP: 8 × 8 inputs, 11 classes, batch 32, rows 5–10 padding,
  Adam 1e-3): accumulating 4 equals the unsplit step — the count equal,
  the loss rtol 1e-6, the parameters rtol 2e-6 plus atol 2e-7, as that
  test holds them — in one process, and on two ranks with SGD (momentum
  0.9, 1e-3): Adam's first update lr·g/(|g| + ε) turns a cancelling
  gradient's f32 rounding into a visible step (``tests/
  test_torch_grad_sync.py``), one weight of 6 144 3e-7 apart here.
- Composed, on two ranks: with ZeRO-1 against the plain accumulating step
  (rtol 1e-6 plus atol 1e-7; 0 expected, and measured: it slices the
  same synced gradient); with FSDP against it, and with the TP head
  (1 × 2) against the one-process accumulating step, at the tolerances of
  a sum in another order (below).

Every rank case runs in ONE two-rank world (``run_world``, a module
fixture).
"""

import functools
import os

import numpy as np
import pytest
import torch
from torch import nn

from mpi_pytorch_tpu_torch.config import MeshConfig
from mpi_pytorch_tpu_torch.models.common import Dense
from mpi_pytorch_tpu_torch.parallel import distributed
from mpi_pytorch_tpu_torch.parallel.launch import run_world
from mpi_pytorch_tpu_torch.parallel.mesh import MODEL_AXIS, Axis, Mesh, create_mesh
from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer
from mpi_pytorch_tpu_torch.train.step import make_train_step
from test_torch_auto_levers import (
    assert_metrics_match_jax,
    assert_state_matches_jax,
    assert_states_close,
    jax_auto_steps,
    numpy_state,
    placed_state,
)
from test_torch_dp_step import RANK_ENV, rank_threads

ACCUM = 4
BATCH = 16
WORLD = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(REPO, "tests")


def accum_batches():
    """Two seeded batches of 16 (64 px, 10 classes): step 1's padding
    rows uneven across every microbatch split (rows 1, 2, 3 and 9), step
    2's the last row."""
    rng = np.random.default_rng(21)
    out = []
    for pad in ([1, 2, 3, 9], [15]):
        images = rng.integers(0, 256, size=(BATCH, 64, 64, 3)).astype(np.uint8)
        labels = rng.integers(0, 10, size=(BATCH,)).astype(np.int32)
        labels[pad] = -1
        out.append((images, labels))
    return out


def microbatch_order(world: int) -> np.ndarray:
    """The global row order whose contiguous split into ``ACCUM``
    microbatches gives the microbatches of ``world`` ranks (each splitting
    its contiguous rows): JAX's ``local_microbatches``."""
    rows = BATCH // world
    per = rows // ACCUM
    return np.array([r * rows + j * per + i for j in range(ACCUM) for r in range(world)
                     for i in range(per)])


class MLP(nn.Module):
    """JAX ``tests/test_train.py``'s MLP: flatten, dense 32, relu, the
    ``fc`` head; no batchnorm."""

    def __init__(self, classes: int = 11):
        super().__init__()
        self.hidden = Dense(8 * 8 * 3, 32)
        self.fc = Dense(32, classes)

    def forward(self, x):
        return self.fc(torch.relu(self.hidden(x.permute(0, 2, 3, 1).flatten(1))))


def mlp_state(optimizer: str = "adam") -> TrainState:
    torch.manual_seed(0)
    model = MLP()
    opt, schedule = make_optimizer(model, 1e-3, optimizer=optimizer)
    return TrainState(model=model, optimizer=opt, schedule=schedule)


def mlp_batch():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((32, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 11, size=(32,)).astype(np.int32)
    labels[5:11] = -1
    return images, labels


def _run(state: TrainState, step, batches, rows: slice) -> dict:
    out = {"metrics": [], "states": []}
    for images, labels in batches:
        m = step(state, torch.from_numpy(images[rows]), torch.from_numpy(labels[rows]))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(numpy_state(state))
    return out


def accum_worker(payload: dict) -> dict:
    """One rank: the accumulating step alone, with ZeRO-1, with FSDP and
    with the TP head (1 × 2), and the MLP split and unsplit."""
    import torch.distributed as dist

    distributed.maybe_initialize_distributed(torch.device("cpu"))
    rank = distributed.rank()
    mesh = create_mesh(MeshConfig())
    pair = Mesh((Axis("data", 1, 0),), Axis(MODEL_AXIS, 2, rank, dist.group.WORLD))
    rows = slice(rank * BATCH // WORLD, (rank + 1) * BATCH // WORLD)
    batches = accum_batches()
    out = {"rank": rank}
    for name, kw in (("accum", {}), ("accum_zero", {"zero": True}),
                     ("accum_fsdp", {"fsdp": True})):
        state = placed_state("sgd", mesh, **kw)
        out[name] = _run(state, make_train_step(torch.float32, mesh=mesh, accum_steps=ACCUM),
                         batches, rows)
    out["accum_tp"] = _run(placed_state("sgd", pair),
                           make_train_step(torch.float32, mesh=pair, accum_steps=ACCUM),
                           batches, slice(0, BATCH))
    images, labels = mlp_batch()
    half = slice(rank * 16, (rank + 1) * 16)
    for k in (1, ACCUM):
        out[f"mlp_{k}"] = _run(mlp_state("sgd"), make_train_step(torch.float32, mesh=mesh,
                                                                 accum_steps=k),
                               [(images, labels)], half)
    return out


@pytest.fixture(scope="module")
def world():
    return run_world("test_torch_accum:accum_worker", WORLD, None, timeout_s=300,
                     env=RANK_ENV, pythonpath=[HERE])


def one_process(state: TrainState, batches, k: int = ACCUM) -> dict:
    with rank_threads():
        return _run(state, make_train_step(torch.float32, accum_steps=k), batches,
                    slice(0, None))


@functools.lru_cache(maxsize=None)
def jax_run(devices: int) -> dict:
    import jax

    from mpi_pytorch_tpu.config import MeshConfig as JaxMeshConfig
    from mpi_pytorch_tpu.parallel import create_mesh as jax_create_mesh

    mesh = jax_create_mesh(JaxMeshConfig(), devices=jax.devices()[:devices])
    return jax_auto_steps(mesh, "sgd", accum_batches(), accum_steps=ACCUM)


def test_one_process_matches_jax_accumulation():
    got = one_process(placed_state("sgd"), accum_batches())
    ref = jax_run(1)
    assert_metrics_match_jax(got["metrics"], ref["metrics"], "one process")
    assert [m["count"] for m in got["metrics"]] == [12, 15]
    assert_state_matches_jax(got["states"][0], ref["tree"], "one process step 1")


def test_two_ranks_match_jax_accumulation(world):
    got = world[0]["accum"]
    assert world[1]["accum"]["metrics"] == got["metrics"]
    ref = jax_run(WORLD)
    assert_metrics_match_jax(got["metrics"], ref["metrics"], "two ranks")
    assert_state_matches_jax(got["states"][0], ref["tree"], "two ranks step 1")


def _close_to(got: dict, ref: dict, what: str, steps: int | None = None) -> None:
    """Counts equal, losses rtol 1e-5, grad norms rtol 1e-4, the state
    after each step (the first ``steps``) rtol 1e-5 plus atol 2e-6
    (statistics 1e-6): the tolerances ``tests/test_torch_dp_step.py``
    holds sums taken in another order to."""
    for a, b in zip(got["metrics"], ref["metrics"]):
        assert (a["count"], a["correct"]) == (b["count"], b["correct"]), what
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5, atol=0, err_msg=what)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4, atol=0,
                                   err_msg=what)
    for i, (a, b) in enumerate(zip(got["states"][:steps], ref["states"])):
        for k, v in b.items():
            np.testing.assert_allclose(a[k], v, rtol=1e-5, atol=1e-6 if "running" in k else 2e-6,
                                       err_msg=f"{what} step {i + 1} {k}")


def test_two_ranks_match_one_process_on_the_same_microbatches(world):
    order = microbatch_order(WORLD)
    assert sorted(order) == list(range(BATCH))
    batches = [(images[order], labels[order]) for images, labels in accum_batches()]
    _close_to(world[0]["accum"], one_process(placed_state("sgd"), batches), "two ranks", 1)


def test_tp_head_accumulation_matches_one_process(world):
    ref = one_process(placed_state("sgd"), accum_batches())
    for r in world:
        _close_to(r["accum_tp"], ref, f"TP rank {r['rank']}")


def test_zero_composes_with_accumulation(world):
    """ZeRO-1 slices the accumulated, synced gradient: the plain
    accumulating step's numbers (0 apart, measured)."""
    for r in world:
        base, got = r["accum"], r["accum_zero"]
        for a, b in zip(got["metrics"], base["metrics"]):
            assert (a["loss"], a["count"], a["correct"]) == (b["loss"], b["count"], b["correct"])
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-6, atol=0)
        for i, (a, b) in enumerate(zip(got["states"], base["states"])):
            assert_states_close(a, b, f"ZeRO-1 rank {r['rank']} step {i + 1}")


def test_fsdp_composes_with_accumulation(world):
    """FSDP reduce-scatters each microbatch's gradient in its backward
    (Σ_j (a_j + b_j)) where the plain step sums each rank's microbatches
    first (Σ_j a_j + Σ_j b_j): the same sum in another order. Measured:
    step 1's gradients within 2.1e-7 of each other relative to each
    tensor's largest, the step-2 grad norm 1.8e-5 apart (the batchnorm
    backward over 16 values a channel amplifies step 1's rounding)."""
    for r in world:
        _close_to(r["accum_fsdp"], r["accum"], f"FSDP rank {r['rank']}")


def _mlp_equal(split: dict, whole: dict, what: str) -> None:
    (ms,), (mw,) = split["metrics"], whole["metrics"]
    assert ms["count"] == mw["count"] == 26 and ms["correct"] == mw["correct"], what
    np.testing.assert_allclose(ms["loss"], mw["loss"], rtol=1e-6, err_msg=what)
    for k, v in whole["states"][0].items():
        np.testing.assert_allclose(split["states"][0][k], v, rtol=2e-6, atol=2e-7,
                                   err_msg=f"{what} {k}")


def test_without_batchnorm_accumulation_is_the_unsplit_step(world):
    """The MLP: rows 5–10 are padding, uneven across the microbatches of
    one process (8 rows each: 3 and 3 in the first two) and of two ranks
    (4 rows each, rank 0's first three)."""
    batch = [mlp_batch()]
    _mlp_equal(one_process(mlp_state(), batch), one_process(mlp_state(), batch, 1), "one process")
    for r in world:
        _mlp_equal(r[f"mlp_{ACCUM}"], r["mlp_1"], f"rank {r['rank']}")


def test_accumulation_refuses_an_uneven_split():
    """A rank's rows that ``accum_steps`` does not divide: the JAX step's
    words."""
    state = mlp_state()
    images, labels = mlp_batch()
    step = make_train_step(torch.float32, accum_steps=3)
    with pytest.raises(ValueError, match="batch 32 not divisible by data size 1 x accum_steps 3"):
        step(state, torch.from_numpy(images), torch.from_numpy(labels))


# --- config: the JAX refusals, in its words ------------------------------

ACCUM_REFUSED = [
    {"accum_steps": 0},
    {"accum_steps": 2, "spmd_mode": True},
    {"accum_steps": 2, "device_cache": True},
    {"accum_steps": 3, "batch_size": 128},
]


@pytest.mark.parametrize("overrides", ACCUM_REFUSED, ids=str)
def test_accum_refusals_are_jax_words(overrides):
    from mpi_pytorch_tpu import config as jc

    from mpi_pytorch_tpu_torch.config import Config

    with pytest.raises(ValueError) as jax_error:
        jc.Config(**overrides).validate_config()
    with pytest.raises(ValueError) as port_error:
        Config(**overrides).validate_config()
    assert str(port_error.value) == str(jax_error.value)


def test_accum_steps_flag_and_default_match_jax(monkeypatch):
    from mpi_pytorch_tpu import config as jc

    from mpi_pytorch_tpu_torch.config import Config, parse_config

    for key in list(os.environ):
        if key.startswith("MPT_"):
            monkeypatch.delenv(key)
    assert Config().accum_steps == jc.Config().accum_steps == 1
    assert parse_config(["--accum-steps", "4"]).accum_steps == 4
    cfg = parse_config(["--accum-steps", "2", "--zero-optimizer", "true", "--fsdp", "true"])
    assert (cfg.accum_steps, cfg.zero_optimizer, cfg.fsdp) == (2, True, True)


def test_the_microbatch_must_divide_over_the_data_axis(monkeypatch):
    """The JAX ``build_training``'s refusal, in its words: a world of one
    has a data axis of one, so a microbatch of 8/8 = 1 row passes and the
    same check over two data ranks is refused."""
    from mpi_pytorch_tpu_torch.config import Config
    from mpi_pytorch_tpu_torch.train import trainer

    trainer.validate_world(Config(batch_size=8, accum_steps=8))
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    with pytest.raises(ValueError) as error:
        trainer.validate_world(Config(batch_size=8, accum_steps=8))
    assert str(error.value) == "microbatch 8/8 not divisible by data-parallel size 2"
