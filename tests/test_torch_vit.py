"""The port's vit against the JAX package's, on the CPU, in f32.

A tiny ViT (depth 2, hidden 64, 4 heads, MLP 128, patch 8, 32 px: 16
tokens of head dim 16) with the port's seeded init, carried to the JAX
variable tree by ``to_flax_variables``. The JAX attention kernels run in
Pallas interpret mode (``MPT_ATTN_INTERPRET=1``, ``MPT_FLASH_INTERPRET=1``);
the port's wrappers run their plain versions.

Tolerances: eval logits rtol 1e-5 plus atol 1e-6 (f32 sums of at most 128
terms through two blocks, in other orders); the 3-step Adam loss
trajectory rtol 1e-4 and the step-1 gradient norm rtol 1e-4, as the
resnet train-step test holds them; the layer norm against flax's rtol
1e-5 (f32) and one bf16 ulp (bf16); the tanh GELU against
``jax.nn.gelu`` rtol 1e-6 plus atol 1e-6 (near x = −5 JAX's f32
``1 + tanh`` cancels to 0 where torch keeps −5.8e-7).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpi_pytorch_tpu.models.vit import VisionTransformer as JaxViT
from mpi_pytorch_tpu.models.vit import vit_b16 as jax_vit_b16
from mpi_pytorch_tpu.models.vit import vit_s16 as jax_vit_s16
from mpi_pytorch_tpu.train.state import TrainState as JaxTrainState
from mpi_pytorch_tpu.train.state import make_optimizer as jax_make_optimizer
from mpi_pytorch_tpu.train.step import make_train_step as jax_make_train_step
from mpi_pytorch_tpu_torch.config import Config, parse_config
from mpi_pytorch_tpu_torch.evaluate import build_inference
from mpi_pytorch_tpu_torch.models.common import LayerNorm
from mpi_pytorch_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from mpi_pytorch_tpu_torch.models.registry import (
    create_model_bundle,
    initialize_model,
    prepare_for_inference,
    prepare_for_training,
)
from mpi_pytorch_tpu_torch.models.vit import VisionTransformer
from mpi_pytorch_tpu_torch.serve import InferenceServer
from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer
from mpi_pytorch_tpu_torch.train.step import make_train_step

TINY = dict(patch_size=8, hidden=64, depth=2, num_heads=4, mlp_dim=128)
SIZE = 32
NUM_CLASSES = 50
BATCH = 8
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("MPT_ATTN_INTERPRET", "1")
    monkeypatch.setenv("MPT_FLASH_INTERPRET", "1")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def _port_vit(attn_impl="full", qkv_fused=False, seed=0) -> VisionTransformer:
    model = VisionTransformer(
        NUM_CLASSES, SIZE, attn_impl=attn_impl, qkv_fused=qkv_fused, **TINY
    )
    model.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # nonzero biases, so every bias mapping is checked
        gen = torch.Generator().manual_seed(seed + 1)
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    return model


def _jax_vit(attn_impl="full", qkv_fused=False) -> JaxViT:
    return JaxViT(num_classes=NUM_CLASSES, attn_impl=attn_impl, qkv_fused=qkv_fused, **TINY)


def _jax_params(model) -> dict:
    variables = to_flax_variables(model.state_dict(), "vit_s16", num_heads=TINY["num_heads"])
    assert variables["batch_stats"] == {}
    return jax.tree_util.tree_map(jnp.asarray, {"params": variables["params"]})


@pytest.mark.parametrize("qkv_fused", [False, True], ids=["qkv3", "qkv_fused"])
@pytest.mark.parametrize("attn_impl", ["full", "flash", "fused-small"])
def test_eval_logits_match_jax(attn_impl, qkv_fused):
    model = prepare_for_inference(_port_vit(attn_impl, qkv_fused), CPU, torch.float32)
    images = np.random.default_rng(3).normal(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    want = _jax_vit(attn_impl, qkv_fused).apply(_jax_params(model), jnp.asarray(images), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(images).permute(0, 3, 1, 2))
        feats = model.features(torch.from_numpy(images).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert feats.shape == (3, TINY["hidden"])


def _batches(seed: int, n: int = 3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.integers(0, 256, size=(BATCH, SIZE, SIZE, 3)).astype(np.uint8)
        labels = rng.integers(0, NUM_CLASSES, size=(BATCH,)).astype(np.int32)
        labels[-1] = -1
        out.append((images, labels))
    return out


@pytest.mark.parametrize("attn_impl", ["full", "flash", "fused-small"])
def test_three_steps_match_jax(attn_impl):
    """Three f32 Adam steps from the same weights on the same uint8
    batches (one padding row each): the losses, and the step-1 gradient
    norm, against the JAX train step with its Pallas kernels interpreted."""
    model = prepare_for_training(_port_vit(attn_impl), CPU)
    opt, schedule = make_optimizer(model, 4e-4)
    state = TrainState(model=model, optimizer=opt, schedule=schedule)
    jax_state = JaxTrainState.create(
        apply_fn=_jax_vit(attn_impl).apply, variables=_jax_params(model),
        tx=jax_make_optimizer(4e-4), rng=jax.random.PRNGKey(1),
    )
    jax_step = jax_make_train_step(jnp.float32)
    port_step = make_train_step(torch.float32)
    got, ref = [], []
    for images, labels in _batches(seed=5):
        jax_state, m = jax_step(jax_state, (jnp.asarray(images), jnp.asarray(labels)))
        ref.append({k: float(v) for k, v in m.items()})
        m = port_step(state, torch.from_numpy(images), torch.from_numpy(labels))
        got.append({k: float(v) for k, v in m.items()})
    np.testing.assert_allclose([m["loss"] for m in got], [m["loss"] for m in ref], rtol=1e-4)
    np.testing.assert_allclose(got[0]["grad_norm"], ref[0]["grad_norm"], rtol=1e-4)
    assert [m["count"] for m in got] == [BATCH - 1] * 3
    assert state.step == 3 == int(jax_state.step)


def test_convert_round_trip():
    """to_flax(port) has exactly the JAX model's tree and shapes, and the
    two conversions invert each other, for the tiny vit and for vit_s16
    and vit_b16 at their published widths (shapes via ``eval_shape``)."""
    jax_vars = _jax_vit().init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False
    )
    jax_vars = jax.tree_util.tree_map(np.asarray, jax_vars)
    sd = from_flax_variables({**jax_vars, "batch_stats": {}}, "vit_s16")
    back = to_flax_variables(sd, "vit_s16", num_heads=TINY["num_heads"])
    assert jax.tree_util.tree_structure(back["params"]) == jax.tree_util.tree_structure(jax_vars["params"])
    for x, y in zip(jax.tree_util.tree_leaves(back["params"]), jax.tree_util.tree_leaves(jax_vars["params"])):
        np.testing.assert_array_equal(x, y)
    model = _port_vit(qkv_fused=True)
    sd2 = from_flax_variables(to_flax_variables(model.state_dict(), "vit_s16", num_heads=4), "vit_s16")
    assert sd2.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(sd2[k].numpy(), v.numpy(), err_msg=k)

    for name, jax_factory in (("vit_s16", jax_vit_s16), ("vit_b16", jax_vit_b16)):
        port, canonical = initialize_model(name, 10, image_size=64)
        assert canonical == 224
        shapes = jax.eval_shape(
            lambda f=jax_factory: f(10).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
        )["params"]
        mapped = to_flax_variables(port.state_dict(), name)["params"]
        assert jax.tree_util.tree_structure(mapped) == jax.tree_util.tree_structure(shapes)
        for x, y in zip(jax.tree_util.tree_leaves(mapped), jax.tree_util.tree_leaves(shapes)):
            assert x.shape == y.shape


def test_init_follows_flax_initializers():
    """lecun-normal kernels (truncated at ±2σ, σ = sqrt(1/fan_in)/0.8796),
    zero biases, ``pos_embed`` N(0, 0.02²), layer norms ones and zeros."""
    bundle = create_model_bundle("vit_s16", 1000, seed=3, image_size=64)
    model = bundle.model.requires_grad_(False)
    w = model.blocks[0].attn.q.weight
    sigma = 384**-0.5 / 0.87962566103423978
    assert abs(float(w.std()) / 384**-0.5 - 1) < 0.02  # the truncation restores the variance
    assert float(w.abs().max()) <= 2 * sigma
    assert float(model.patch_embed.weight.abs().max()) <= 2 * (3 * 16 * 16) ** -0.5 / 0.8796
    assert abs(float(model.pos_embed.std()) / 0.02 - 1) < 0.05 and model.pos_embed.shape == (1, 16, 384)
    assert all(float(p.abs().max()) == 0 for n, p in model.named_parameters() if n.endswith("bias"))
    assert torch.equal(model.ln.weight, torch.ones(384))
    again = create_model_bundle("vit_s16", 1000, seed=3, image_size=64).model
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_registry_sets_match_the_models():
    """The registered models with no batchnorm are the JAX registry's
    ``BN_FREE_MODELS``, and ``ATTENTION_MODELS`` those with attention, as
    its ``SP_MODELS`` (less vit_moe_s16) say."""
    from mpi_pytorch_tpu.models import registry as jax_registry
    from mpi_pytorch_tpu_torch.models import registry

    for name in registry._REGISTRY:
        model, _ = initialize_model(name, 10, image_size=32)
        has_bn = any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
        assert has_bn == (name not in jax_registry.BN_FREE_MODELS), name
        assert (name in registry.ATTENTION_MODELS) == (name in jax_registry.SP_MODELS), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_flax(dtype):
    """flax LayerNorm (ε = 1e-6, f32 fast variance, output in the compute
    dtype) on rows of unit and of 1e-3 scale — the latter pins ε."""
    rng = np.random.default_rng(4)
    x = np.concatenate([
        3.0 + rng.normal(size=(4, 5, 96)), 1e-3 * rng.normal(size=(4, 5, 96)),
    ]).astype(np.float32)
    scale, bias = (rng.normal(size=96).astype(np.float32) for _ in range(2))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = fnn.LayerNorm(dtype=jdt).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, jnp.asarray(x, jdt)
    )
    ln = LayerNorm(96)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and ln.eps == 1e-6
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7, atol=1e-6)
    torch_default = F.layer_norm(torch.from_numpy(x[4:]), (96,), torch.from_numpy(scale), torch.from_numpy(bias))
    assert np.abs(torch_default.numpy() - want[4:]).max() > 1e-2  # ε = 1e-5 is another function


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4  # erf differs


def test_config_and_registry_refusals():
    with pytest.raises(ValueError, match="attention family"):
        Config(model_name="resnet18", attn_impl="flash").validate_config()
    with pytest.raises(ValueError, match="attention family"):
        Config(model_name="resnet34", qkv_fused=True).validate_config()
    with pytest.raises(ValueError, match="attn_impl must be"):
        Config(model_name="vit_s16", attn_impl="sparse").validate_config()
    with pytest.raises(ValueError, match="not supported by the port"):
        Config(model_name="vit_moe_s16").validate_config()
    with pytest.raises(ValueError, match="multiple of 16"):
        Config(model_name="vit_s16", width=120, height=120).validate_config()
    with pytest.raises(SystemExit):
        parse_config(["--model-name", "vit_s16", "--sp-strategy", "ring"])
    with pytest.raises(ValueError, match="attention family"):
        initialize_model("resnet18", 10, attn_impl="fused-small")
    with pytest.raises(ValueError, match="attention family"):
        initialize_model("resnet18", 10, qkv_fused=True)
    with pytest.raises(ValueError, match="unsupported model"):
        initialize_model("vit_moe_s16", 10)
    with pytest.raises(ValueError, match="unknown attn_impl"):
        VisionTransformer(10, 32, attn_impl="sparse", **TINY)
    cfg = parse_config(["--model-name", "vit_s16", "--attn-impl", "fused-small",
                        "--qkv-fused", "true", "--image-size", "64"])
    assert (cfg.attn_impl, cfg.qkv_fused, cfg.image_size) == ("fused-small", True, (64, 64))


def test_serving_vit_fused_paths_match_plain():
    """vit_s16 at 32 px through ``InferenceServer`` with the tiny-S
    attention and the fused head: each request's top-1 equals the plain
    path's (full attention, logits argmax) on the same seeded weights."""
    cfg = Config(
        model_name="vit_s16", num_classes=300, width=SIZE, height=SIZE, compute_dtype="float32",
        input_dtype="uint8", attn_impl="fused-small", qkv_fused=True, fused_head_eval=True,
        serve_topk=1, serve_buckets="1,4,8", loader_workers=2, serve_max_wait_ms=2.0, seed=5,
    )
    images = np.random.default_rng(6).integers(0, 256, size=(11, SIZE, SIZE, 3), dtype=np.uint8)
    with InferenceServer(cfg, device="cpu") as srv:
        got = srv.predict_batch(list(images), timeout=120)
    plain = build_inference(Config(**{**cfg.__dict__, "attn_impl": "full", "qkv_fused": False,
                                      "fused_head_eval": False}), device="cpu")
    with torch.no_grad():
        x = (torch.from_numpy(images).float() / 255.0 - torch.tensor([0.485, 0.456, 0.406])) / torch.tensor(
            [0.229, 0.224, 0.225])
        want = plain(x.permute(0, 3, 1, 2)).argmax(-1).numpy()
    np.testing.assert_array_equal(got[:, 0], want)
