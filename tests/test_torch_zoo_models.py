"""The port's CNN zoo — alexnet, squeezenet1_0 and densenet121 here,
vgg11_bn in ``test_torch_zoo_vgg.py``, mobilenet_v2 and efficientnet_b0 in
``test_torch_zoo_mobile.py``, inception_v3 in
``test_torch_zoo_inception.py`` (files of their own, so that loadfile
places them on other workers) — against the JAX package's modules, on the
CPU (TF32 off).

Each model is built at a small input (alexnet 64 px, vgg11_bn 32 px,
squeezenet 64 px, mobilenet and efficientnet 32 px, densenet with
``block_config=(2, 2)`` and growth 8) and full width otherwise, with
seeded random weights (random positive batchnorm statistics, nonzero
biases) carried to the JAX tree by ``to_flax_variables``, and a
numpy-seeded batch of 8. Dropout and stochastic depth are off on both
sides (the JAX modules' constructor fields; efficientnet's
``_DROP_PATH_RATE`` by ``monkeypatch``).

In f32 (both sides' production arithmetic): the eval logits (rtol 1e-4,
atol 1e-4 of their largest magnitude), and the train-mode logits and
updated batch statistics (rtol 1e-4, atol 5e-4 of the largest magnitude:
the train-mode batchnorm's ``E[x²] − mean²`` over the B·1·1 rows of the
last stages loses digits).

In float64 on both sides (JAX under ``jax.enable_x64``, the port's
modules in float64, its batchnorm statistics then float64 as flax's
are): the train-mode logits, the updated batch statistics and every
parameter's gradient of the masked mean CE, rtol 1e-6 with an atol of
1e-6 of the tensor's largest magnitude or 1e-8 of the model's largest
gradient, whichever is larger (a batchnorm bias whose output feeds
another batchnorm through a linear layer has a true gradient of 0). The
gradients are compared in float64 because in f32 they cannot be: the
JAX package's own f32 gradients of mobilenet_v2 sit 10–30 % off its
float64 ones (batchnorms over few rows in nearly dead channels amplify
each rounding), and efficientnet_b0's up to 2.5 %.

Also pinned: the weight round trip through the JAX init trees (their
structure and shapes from ``jax.eval_shape``), the flatten order of
alexnet's and vgg's first dense layer, the squeezenet stem's ``'SAME'``
padding and ``'VALID'`` (floor) pools, the count-padding average pool,
the adaptive pool's windows, and the tensor-core heads' route for every
(dtype, D) of the zoo's heads.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mpi_pytorch_tpu.models.alexnet import AlexNet as JaxAlexNet
from mpi_pytorch_tpu.models.densenet import DenseNet as JaxDenseNet
from mpi_pytorch_tpu.models.efficientnet import EfficientNetB0 as JaxEfficientNetB0
from mpi_pytorch_tpu.models.mobilenet import MobileNetV2 as JaxMobileNetV2
from mpi_pytorch_tpu.models.squeezenet import SqueezeNet as JaxSqueezeNet
from mpi_pytorch_tpu.models.vgg import vgg11_bn as jax_vgg11_bn
from mpi_pytorch_tpu.models.common import adaptive_avg_pool as jax_adaptive_avg_pool
from mpi_pytorch_tpu.ops.losses import classification_loss as jax_loss
from mpi_pytorch_tpu_torch.models import alexnet, densenet, efficientnet, mobilenet, squeezenet, vgg
from mpi_pytorch_tpu_torch.models.common import adaptive_avg_pool, avg_pool
from mpi_pytorch_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from mpi_pytorch_tpu_torch.models.registry import init_weights
from mpi_pytorch_tpu_torch.ops.fused_head_ce import tc_route
from mpi_pytorch_tpu_torch.ops.losses import classification_loss

NUM_CLASSES = 10
BATCH = 8


@pytest.fixture(autouse=True)
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _small_densenet_jax(**kw):
    return JaxDenseNet(block_config=(2, 2), num_classes=NUM_CLASSES, growth_rate=8, **kw)


# name → (port factory, JAX module factory (dtype kwargs), input size)
CASES = {
    "alexnet": (lambda: alexnet.alexnet(NUM_CLASSES, dropout_rate=0.0),
                lambda **kw: JaxAlexNet(num_classes=NUM_CLASSES, dropout_rate=0.0, **kw), 64),
    "vgg11_bn": (lambda: vgg.vgg11_bn(NUM_CLASSES, dropout_rate=0.0),
                 lambda **kw: jax_vgg11_bn(NUM_CLASSES, dropout_rate=0.0, **kw), 32),
    "squeezenet1_0": (lambda: squeezenet.squeezenet1_0(NUM_CLASSES, dropout_rate=0.0),
                      lambda **kw: JaxSqueezeNet(num_classes=NUM_CLASSES, dropout_rate=0.0, **kw),
                      64),
    "densenet121": (lambda: densenet.densenet121(NUM_CLASSES, block_config=(2, 2), growth_rate=8),
                    _small_densenet_jax, 32),
    "mobilenet_v2": (lambda: mobilenet.mobilenet_v2(NUM_CLASSES, dropout=0.0),
                     lambda **kw: JaxMobileNetV2(num_classes=NUM_CLASSES, dropout=0.0, **kw), 32),
    "efficientnet_b0": (lambda: efficientnet.efficientnet_b0(NUM_CLASSES, dropout=0.0,
                                                             drop_path_rate=0.0),
                        lambda **kw: JaxEfficientNetB0(num_classes=NUM_CLASSES, dropout=0.0, **kw),
                        32),
}
HERE = ("alexnet", "squeezenet1_0", "densenet121")


def _seeded_port(arch: str, seed: int = 0) -> torch.nn.Module:
    """The port's model with seeded weights and small nonzero biases (so
    their mapping is checked), in f32 on the CPU."""
    model = CASES[arch][0]()
    init_weights(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) and m.bias is not None:
                m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=gen))
    return model.float()


def _images(size: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(BATCH, size, size, 3)).astype(np.float32)


def _labels(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + 7).integers(0, NUM_CLASSES, BATCH).astype(np.int32)


def _allclose(actual, expected, rtol: float, atol: float, what: str) -> None:
    """``np.testing.assert_allclose``'s rule, its message only on failure
    (its own pass over a 100 M-element tensor takes seconds)."""
    actual, expected = np.asarray(actual), np.asarray(expected)
    if actual.shape != expected.shape or not np.all(
            np.abs(actual - expected) <= atol + rtol * np.abs(expected)):
        np.testing.assert_allclose(actual, expected, rtol=rtol, atol=atol, err_msg=what)


def _close(actual, expected, rtol: float, scale: float, what: str) -> None:
    expected = np.asarray(expected)
    _allclose(actual, expected, rtol, scale * max(float(np.abs(expected).max()), 1e-12), what)


def _tree_close(actual, expected, rtol: float, scale: float, what: str,
                floor: float = 0.0) -> None:
    """Leaf by leaf: rtol, and an atol of ``scale`` of the leaf's largest
    magnitude or ``floor`` of the whole tree's, whichever is larger."""
    flat_a = jax.tree_util.tree_flatten_with_path(actual)[0]
    flat_e = dict(jax.tree_util.tree_flatten_with_path(expected)[0])
    assert len(flat_a) == len(flat_e), what
    top = max((float(np.abs(np.asarray(e)).max()) for e in flat_e.values()), default=0.0)
    for path, leaf in flat_a:
        expect = np.asarray(flat_e[path])
        atol = max(scale * float(np.abs(expect).max()), floor * top)
        _allclose(leaf, expect, rtol, atol, f"{what} {jax.tree_util.keystr(path)}")


def _grads_as_flax(model: torch.nn.Module, arch: str) -> dict:
    """The port's parameter gradients as a flax params tree (the batchnorm
    buffers ride along only to mark which modules are batchnorms)."""
    sd = dict(model.state_dict())
    for name, p in model.named_parameters():
        sd[name] = p.grad
    return to_flax_variables(sd, arch)["params"]


def _jax_train(jmodel, variables, x, y):
    """JAX's train-mode logits, new batch statistics and parameter
    gradients of the masked mean CE."""
    has_bs = bool(variables.get("batch_stats"))

    def loss_fn(params):
        v = {"params": params}
        if has_bs:
            v["batch_stats"] = variables["batch_stats"]
        out, upd = jmodel.apply(v, x, train=True, mutable=["batch_stats"])
        return jax_loss(out, y), (out, upd.get("batch_stats", {}))

    (_, (logits, new_bs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return logits, new_bs, grads


def _jax_forwards(jmodel, variables, x):
    """JAX's eval logits, train-mode logits and new batch statistics (one
    compiled function)."""

    def both(v, x):
        out, upd = jmodel.apply(v, x, train=True, mutable=["batch_stats"])
        return jmodel.apply(v, x, train=False), out, upd.get("batch_stats", {})

    return jax.jit(both)(variables, x)


def _port_stats(model: torch.nn.Module, arch: str) -> dict:
    """The model's running statistics as the flax ``batch_stats`` tree."""
    sd = model.state_dict()
    bns = {k.rpartition(".")[0] for k in sd if k.endswith(".running_mean")}
    return to_flax_variables({k: v for k, v in sd.items() if k.rpartition(".")[0] in bns},
                             arch)["batch_stats"]


def check_against_jax(arch: str) -> None:
    """The f32 forwards and the float64 train step of ``arch`` against
    JAX (see the module docstring for what and how close)."""
    _, jax_factory, size = CASES[arch]
    x_np, y_np = _images(size), _labels()
    x = torch.from_numpy(x_np).permute(0, 3, 1, 2)
    labels = torch.from_numpy(y_np)

    model = _seeded_port(arch)
    model64 = copy.deepcopy(model).double().train()
    flax_vars = to_flax_variables(model.state_dict(), arch)
    j_eval, j_train, j_bs = _jax_forwards(jax_factory(), jax.tree_util.tree_map(
        jnp.asarray, flax_vars), x_np)
    with torch.no_grad():
        p_eval = model.eval()(x).numpy()
        p_train = model.train()(x).numpy()
    _close(p_eval, j_eval, 1e-4, 1e-4, f"{arch} f32 eval logits")
    _close(p_train, j_train, 1e-4, 5e-4, f"{arch} f32 train logits")
    _tree_close(_port_stats(model, arch), j_bs, 1e-4, 5e-4, f"{arch} f32 batch stats")

    model = model64
    logits = model(x.double())
    classification_loss(logits, labels).backward()
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), flax_vars)
        jmodel = jax_factory(dtype=jnp.float64, param_dtype=jnp.float64)
        j_logits, j_bs, j_grads = _jax_train(jmodel, v64, x_np.astype(np.float64), y_np)
        j_logits, j_bs, j_grads = jax.device_get((j_logits, j_bs, j_grads))
    _close(logits.detach().numpy(), j_logits, 1e-6, 1e-6, f"{arch} f64 train logits")
    _tree_close(_port_stats(model, arch), j_bs, 1e-6, 1e-6, f"{arch} f64 batch stats")
    _tree_close(_grads_as_flax(model, arch), j_grads, 1e-6, 1e-6, f"{arch} f64 grads",
                floor=1e-8)


@pytest.mark.parametrize("arch", HERE)
def test_forwards_stats_and_gradients_match_jax(arch):
    check_against_jax(arch)


@pytest.mark.parametrize("arch", [a for a in CASES if a != "vgg11_bn"])
def test_weights_round_trip_through_the_jax_init_tree(arch):
    """The JAX module's init tree (its structure and shapes, filled with
    seeded values) → the port's state_dict (a strict load: every name and
    shape matches) → back, leaf for leaf."""
    check_round_trip(arch)


def check_round_trip(arch: str) -> None:
    _, jax_factory, size = CASES[arch]
    jmodel = jax_factory()
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, size, size, 3), jnp.float32), train=True))
    leaves = iter(range(1, 1 << 20))

    def fill(s):  # distinct values a leaf, every leaf its own offset
        return ((np.arange(np.prod(s.shape), dtype=np.float32) % 9973) * 1e-3
                + next(leaves)).reshape(s.shape)

    variables = {k: jax.tree_util.tree_map(fill, v)
                 for k, v in shapes.items() if k in ("params", "batch_stats")}
    model = CASES[arch][0]()
    model.load_state_dict(from_flax_variables(variables, arch))
    back = to_flax_variables(model.state_dict(), arch)
    if "batch_stats" not in variables:
        assert back["batch_stats"] == {}
        back = {"params": back["params"]}
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    expect = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(back)[0]:
        if not np.array_equal(leaf, expect[path]):
            np.testing.assert_array_equal(leaf, expect[path], err_msg=jax.tree_util.keystr(path))


def test_first_dense_reads_the_flatten_in_chw_order():
    check_flatten_order("alexnet", 6, 256)


def check_flatten_order(arch: str, side: int, channels: int) -> None:
    """Column c·side² + h·side + w of the port's ``fc1`` is row
    (h·side + w)·C + c of the flax kernel: the JAX model flattens HWC."""
    w = torch.randn(4096, channels * side * side, generator=torch.Generator().manual_seed(3))
    kernel = to_flax_variables({"fc1.weight": w, "fc1.bias": torch.zeros(4096)},
                               arch)["params"]["fc1"]["kernel"]
    w = w.numpy()
    rng = np.random.default_rng(0)
    for _ in range(64):
        c, h, ww = rng.integers(channels), rng.integers(side), rng.integers(side)
        np.testing.assert_array_equal(w[:, c * side * side + h * side + ww],
                                      kernel[(h * side + ww) * channels + c])


def test_squeezenet_same_stem_and_valid_pools():
    """At 64 px the 'SAME' 7×7/s2 stem pads 2 before and 3 after (32×32),
    and the 3×3/s2 pools floor: 15, 7, 3 — where torchvision's ceil mode
    gives 16, 8, 4. The fire9 map (the head's input) is 3×3."""
    model = _seeded_port("squeezenet1_0").eval()
    x = torch.from_numpy(_images(64)).permute(0, 3, 1, 2)
    with torch.no_grad():
        stem = model.conv1(x)
        feats = model.features(x)
    assert tuple(stem.shape[2:]) == (32, 32)
    assert tuple(feats.shape[1:]) == (512, 3, 3)
    params = to_flax_variables(model.state_dict(), "squeezenet1_0")["params"]
    conv = fnn.Conv(96, (7, 7), strides=(2, 2))
    expect = conv.apply({"params": params["conv1"]}, _images(64))
    _close(stem.permute(0, 2, 3, 1).numpy(), expect, 1e-5, 1e-6, "same-padded stem")


def test_average_pool_counts_the_padding():
    """avg_pool(3, 1, padding=1) is flax's avg_pool with [(1, 1), (1, 1)]
    padding: every window divides by 9, a corner's too."""
    x = np.random.default_rng(1).normal(size=(2, 5, 6, 3)).astype(np.float32)
    port = avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 1, padding=1).permute(0, 2, 3, 1)
    expect = np.asarray(fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1),
                                     padding=[(1, 1), (1, 1)]))
    np.testing.assert_allclose(port.numpy(), expect, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port[0, 0, 0].numpy(), x[0, :2, :2].sum(axis=(0, 1)) / 9,
                               rtol=1e-6)


@pytest.mark.parametrize("hw,out", [((3, 3), (6, 6)), ((1, 1), (6, 6)), ((4, 5), (7, 7)),
                                    ((8, 8), (4, 4)), ((7, 7), (7, 7)), ((5, 9), (3, 2))])
def test_adaptive_pool_windows_match_jax(hw, out):
    x = np.random.default_rng(2).normal(size=(2, *hw, 4)).astype(np.float32)
    port = adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_adaptive_avg_pool(jnp.asarray(x), out)),
                               rtol=1e-6, atol=1e-6)


# (bytes a feats element, D, batch) → (route, rows a CTA): the zoo's head
# widths — densenet 1024, mobilenet/efficientnet 1280, inception 2048,
# alexnet/vgg 4096 — and resnet18's 512.
ROUTES = [
    (2, 512, 512, ("resident", 128)), (2, 1024, 64, ("streamed", 64)),
    (2, 1024, 512, ("streamed", 128)), (2, 1280, 512, ("streamed", 128)),
    (2, 1280, 64, ("streamed", 64)), (2, 2048, 64, ("streamed", 64)),
    (2, 2048, 512, ("streamed", 128)), (2, 4096, 64, ("streamed", 64)),
    (2, 4096, 512, ("streamed", 128)), (1, 512, 512, ("resident", 128)),
    (1, 2048, 512, ("streamed", 128)), (1, 4096, 64, ("streamed", 64)),
    (1, 4096, 512, ("streamed", 128)), (4, 512, 512, ("f32", 64)),
    (4, 4096, 64, ("f32", 8)), (4, 4096, 512, ("f32", 8)),
]


@pytest.mark.parametrize("elem_bytes,d,rows,expected", ROUTES)
def test_head_route_takes_every_zoo_width(elem_bytes, d, rows, expected):
    """The tensor-core heads' route is a pure function of (batch, D,
    element bytes): the resident feats tile for a feats row of at most
    1 KB (resnet18's bf16 D = 512 and its int8 head), else the streamed
    one (its chunks through the ring beside W's) — no zoo width is
    refused."""
    assert tc_route(rows, d, elem_bytes) == expected


@pytest.mark.parametrize("elem_bytes,d", [(2, 512), (2, 1280), (1, 2048)])
def test_head_route_can_be_forced(elem_bytes, d):
    """Both routes fit up to bf16 D = 1280 and int8 D = 2048: forced, each
    keeps its row tile (the streamed one two warpgroups above 64 rows); a
    resident tile that does not fit, or an unknown route, is refused."""
    assert tc_route(512, d, elem_bytes, "streamed") == ("streamed", 128)
    assert tc_route(64, d, elem_bytes, "streamed") == ("streamed", 64)
    assert tc_route(64, d, elem_bytes, "resident") == ("resident", 64)
    with pytest.raises(ValueError):
        tc_route(64, 4096, elem_bytes, "resident")
    with pytest.raises(ValueError):
        tc_route(64, d, elem_bytes, "tiled")


def test_head_route_constants_are_the_kernel_sources():
    """``tc_route``'s shared-memory plan is the kernel's: its constants
    equal the ``constexpr`` ones of ``csrc/head_predict_tc.cuh``."""
    from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh
    from test_torch_head_tc import TC

    assert (fh._SMEM_LIMIT, fh._SMEM_FIXED, fh._STAGE_BYTES, fh._CHUNK, fh._MIN_STAGES,
            fh._MAX_STAGES) == (TC["kSmemLimit"], TC["kSmemFixed"], TC["kStageBytes"],
                                TC["kChunk"], TC["kMinStages"], TC["kMaxStages"])
