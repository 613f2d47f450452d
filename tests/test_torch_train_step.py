"""The port's train step against the JAX train step, on the CPU, in f32.

resnet18 at 64 px with a 200-class head, batches of 8 uint8 images (one
padding row, label −1), three steps from the same weights: the port's
seeded init carried into the JAX variable tree by ``to_flax_variables``.
The JAX step is ``make_train_step(jnp.float32)`` on the CPU device; with
the fused stem on, its Pallas pair runs in interpret mode
(``MPT_STEM_INTERPRET=1``) and the port's wrappers run their plain
versions. TF32 is off.

64 px, not 32: at 32 px the last stage is 1×1, so its batchnorm normalizes
8 values per channel, and the backward through those statistics turns f32
rounding into gradient differences that grow step after step.

Tolerances: per-step loss rtol 1e-4 and the step-1 grad norm rtol 1e-4
(f32 convolutions summed in other orders through 18 layers). The
batchnorm running statistics and, with SGD, every parameter are compared
after the first step, where both sides start from the same weights:
statistics rtol 1e-5 plus atol 1e-6 (means near zero carry the deep
layers' f32 sum-order error), parameters rtol 1e-5 plus atol 1e-7 (some
sit near zero). Later steps amplify the gradients' f32 noise through the
batchnorm backward, and Adam's near-sign first update turns a near-zero
gradient's rounding into a full ±lr step, so there only the loss is
held.

Also: the learning-rate schedules against optax's schedule functions,
feature-extract freezing, and the skip policy on a NaN-poisoned batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_pytorch_tpu.models.resnet import resnet18 as jax_resnet18
from mpi_pytorch_tpu.train.state import TrainState as JaxTrainState
from mpi_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
from mpi_pytorch_tpu.train.step import make_train_step as jax_make_train_step
from mpi_pytorch_tpu_torch.models.convert import to_flax_variables
from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training
from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer, make_schedule
from mpi_pytorch_tpu_torch.train.step import make_train_step

NUM_CLASSES = 200
SIZE = 64
BATCH = 8
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _batches(seed: int, n: int = 3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.integers(0, 256, size=(BATCH, SIZE, SIZE, 3)).astype(np.uint8)
        labels = rng.integers(0, NUM_CLASSES, size=(BATCH,)).astype(np.int32)
        labels[-1] = -1
        out.append((images, labels))
    return out


def _port_state(fused: bool, optimizer: str = "adam", feature_extract: bool = False, seed: int = 0):
    bundle = create_model_bundle(
        "resnet18", NUM_CLASSES, feature_extract, seed=seed, fused_stem=fused
    )
    model = prepare_for_training(bundle.model, CPU)
    opt, schedule = make_optimizer(
        model, 4e-4, bundle.trainable_mask, optimizer=optimizer
    )
    return TrainState(model=model, optimizer=opt, schedule=schedule)


def _run_port(state, batches, skip=False):
    step = make_train_step(torch.float32, bad_step_skip=skip)
    return [
        {k: float(v) for k, v in step(state, torch.from_numpy(i), torch.from_numpy(l)).items()}
        for i, l in batches
    ]


@pytest.mark.parametrize(
    "fused,optimizer",
    [(True, "adam"), (False, "adam"), (True, "sgd")],
    ids=["fused_adam", "plain_adam", "fused_sgd"],
)
def test_three_steps_match_jax(fused, optimizer, monkeypatch):
    monkeypatch.setenv("MPT_STEM_INTERPRET", "1")
    state = _port_state(fused, optimizer)
    variables = jax.tree_util.tree_map(
        jnp.asarray, to_flax_variables(state.model.state_dict(), "resnet18")
    )
    jax_state = JaxTrainState.create(
        apply_fn=jax_resnet18(NUM_CLASSES, dtype=jnp.float32, fused_stem=fused).apply,
        variables=variables,
        tx=jax_make_optimizer(4e-4, optimizer=optimizer),
        rng=jax.random.PRNGKey(1),
    )
    jax_step = jax_make_train_step(jnp.float32)
    port_step = make_train_step(torch.float32)
    got, ref = [], []
    for i, (images, labels) in enumerate(_batches(seed=7)):
        jax_state, m = jax_step(jax_state, (jnp.asarray(images), jnp.asarray(labels)))
        ref.append({k: float(v) for k, v in m.items()})
        m = port_step(state, torch.from_numpy(images), torch.from_numpy(labels))
        got.append({k: float(v) for k, v in m.items()})
        if i == 0:
            port_vars = to_flax_variables(state.model.state_dict(), "resnet18")
            pairs = [("batch_stats", jax_state.batch_stats, 1e-6)]
            if optimizer == "sgd":
                pairs.append(("params", jax_state.params, 1e-7))
            for key, tree, atol in pairs:
                for (path, a), b in zip(
                    jax.tree_util.tree_leaves_with_path(port_vars[key]),
                    jax.tree_util.tree_leaves(tree),
                ):
                    np.testing.assert_allclose(
                        a, np.asarray(b), rtol=1e-5, atol=atol,
                        err_msg=f"{key}{jax.tree_util.keystr(path)}",
                    )

    np.testing.assert_allclose([m["loss"] for m in got], [m["loss"] for m in ref], rtol=1e-4)
    np.testing.assert_allclose(got[0]["grad_norm"], ref[0]["grad_norm"], rtol=1e-4)
    assert [m["count"] for m in got] == [m["count"] for m in ref] == [BATCH - 1] * 3
    assert state.step == 3 == int(jax_state.step)


@pytest.mark.parametrize("lr_schedule,warmup", [("constant", 0), ("cosine", 0), ("warmup_cosine", 4)])
def test_schedules_match_optax(lr_schedule, warmup):
    """The per-step rate against optax's schedule functions built with the
    JAX ``make_optimizer``'s arguments, steps 0..N+2: rtol 1e-5 (optax
    evaluates in f32, the port in f64: cos and the products lose a few f32 ulps)."""
    total = 12
    sched = make_schedule(3e-3, lr_schedule, warmup, total)
    if lr_schedule == "constant":
        ref = optax.constant_schedule(3e-3)
    elif lr_schedule == "cosine":
        ref = optax.cosine_decay_schedule(3e-3, decay_steps=total)
    else:
        ref = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=3e-3, warmup_steps=warmup, decay_steps=total
        )
    got = [sched(t) for t in range(total + 3)]
    want = [float(ref(t)) for t in range(total + 3)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    if lr_schedule == "warmup_cosine":
        assert got[0] == 0.0 and max(got) == pytest.approx(3e-3)
    with pytest.raises(ValueError, match="total_steps"):
        make_schedule(3e-3, "cosine", 0, None)
    with pytest.raises(ValueError, match="warmup_steps"):
        make_schedule(3e-3, "warmup_cosine", total, total)


def test_step_uses_the_schedule_before_the_increment():
    """Step t updates with schedule(t), the count taken before the
    increment: under a warmup from 0 the first step changes no parameter,
    and the step counter still advances."""
    state = _port_state(False, "sgd")
    state.schedule = make_schedule(1e-2, "warmup_cosine", 2, 10)  # schedule(0) == 0
    before = [p.detach().clone() for p in state.model.parameters()]
    _run_port(state, _batches(seed=3, n=1))
    assert state.step == 1
    for p, b in zip(state.model.parameters(), before):
        assert torch.equal(p, b)  # the first update had rate 0


@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_feature_extract_freezes_the_body(optimizer):
    state = _port_state(False, optimizer, feature_extract=True)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    metrics = _run_port(state, _batches(seed=5, n=2))
    assert metrics[0]["grad_norm"] > 0
    moved = set()
    for n, p in state.model.named_parameters():
        if not torch.equal(p, before[n]):
            moved.add(n)
    assert moved == {"fc.weight", "fc.bias"}


def test_skip_policy_leaves_the_state_bit_identical():
    """A NaN-poisoned batch under ``bad_step_skip``: params, Adam moments,
    batchnorm running statistics and the step counter stay bit-identical;
    the next clean step then updates as usual."""
    state = _port_state(True, "adam")
    clean = _batches(seed=9, n=2)
    _run_port(state, clean[:1], skip=True)

    def snapshot():
        return (
            {k: v.clone() for k, v in state.model.state_dict().items()},
            [
                {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
                for s in state.optimizer.state.values()
            ],
            state.step,
        )

    before = snapshot()
    images, labels = clean[1]
    poisoned = images.astype(np.float32)  # float rows are taken as normalized
    poisoned[0, 0, 0, 0] = np.nan
    (m,) = _run_port(state, [(poisoned, labels)], skip=True)
    assert m["skipped"] == 1 and not np.isfinite(m["loss"])
    after = snapshot()
    assert after[2] == before[2] == 1
    for k, v in before[0].items():
        assert torch.equal(v, after[0][k]), k
    for s0, s1 in zip(before[1], after[1]):
        for k, v in s0.items():
            assert torch.equal(v, s1[k]) if torch.is_tensor(v) else v == s1[k], k
    (m,) = _run_port(state, clean[1:], skip=True)
    assert m["skipped"] == 0 and state.step == 2
