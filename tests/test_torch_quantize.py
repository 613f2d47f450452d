"""The port's int8 serving path against the JAX package on the CPU: the
per-channel quantizer, activation quantization, the calibration sample and
activation scale, the int8 head (the port's plain version against the JAX
Pallas kernel in interpret mode), the int8 predict step as a whole, and the
server holding both precisions.

Weights are a seeded random init of the port's resnet18, carried to the
JAX tree by ``to_flax_variables``; the JAX int8 tree comes back through
``from_flax_quantized``. f32 compute on both sides, TF32 off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.models.resnet import resnet18 as jax_resnet18
from mpi_pytorch_tpu.ops import quantize as jqz
from mpi_pytorch_tpu_torch import Config
from mpi_pytorch_tpu_torch.models.convert import from_flax_quantized, to_flax_variables
from mpi_pytorch_tpu_torch.models.registry import (
    init_weights,
    initialize_model,
    prepare_for_inference,
)
from mpi_pytorch_tpu_torch.ops import quantize as qz

NUM_CLASSES = 300
SIZE = 32


@pytest.fixture(autouse=True)
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _f32_model(seed: int = 0, fused_stem: bool = True):
    """A seeded resnet18 with f32 weights, a nonzero head bias and an
    all-zero output channel in conv1 and in the head."""
    model, _ = initialize_model("resnet18", NUM_CLASSES, fused_stem=fused_stem)
    init_weights(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.fc.bias.copy_(0.01 * torch.randn(NUM_CLASSES, generator=torch.Generator().manual_seed(seed + 1)))
        model.conv1.weight[5].zero_()
        model.fc.weight[7].zero_()
    return model


def _jax_state(model):
    import optax

    from mpi_pytorch_tpu.train.state import TrainState

    variables = jax.tree_util.tree_map(jnp.asarray, to_flax_variables(model.state_dict(), "resnet18"))
    return TrainState.create(
        apply_fn=jax_resnet18(NUM_CLASSES, dtype=jnp.float32, fused_stem=model.fused_stem).apply,
        variables=variables, tx=optax.identity(), rng=jax.random.PRNGKey(0),
    )


@pytest.fixture(scope="module")
def quantized_pair():
    """(the port's quantized model, the JAX (qtree, scales)) of one f32
    model."""
    model = _f32_model()
    params = jax.tree_util.tree_map(jnp.asarray, to_flax_variables(model.state_dict(), "resnet18"))["params"]
    qtree, scales = jqz.quantize_params(params)
    return qz.quantize_model(model), qtree, scales


# (port module, flax path): a stem conv with a zero channel, block convs, a
# strided downsample, the last conv and the dense head with a zero row.
LAYERS = [
    ("conv1", "conv1"), ("layer1.0.conv1", "layer1_0/conv1"),
    ("layer2.0.downsample.0", "layer2_0/downsample_conv"), ("layer3.1.conv2", "layer3_1/conv2"),
    ("layer4.1.conv2", "layer4_1/conv2"), ("fc", "head"),
]


@pytest.mark.parametrize("port_name, flax_path", LAYERS, ids=[n for n, _ in LAYERS])
def test_quantized_weights_bit_equal_to_jax(quantized_pair, port_name, flax_path):
    """int8 values and scales equal to JAX ``quantize_params`` after the
    layout transpose (OIHW ↔ HWIO, [out, in] ↔ [in, out])."""
    qmodel, qtree, scales = quantized_pair
    mod = qmodel.get_submodule(port_name)
    leaf = qtree
    for key in flax_path.split("/"):
        leaf = leaf[key]
    want_q = np.asarray(leaf["kernel"])
    want_q = want_q.T if want_q.ndim == 2 else np.transpose(want_q, (3, 2, 0, 1))
    assert mod.q.dtype == torch.int8
    np.testing.assert_array_equal(mod.q.numpy(), want_q)
    np.testing.assert_array_equal(mod.scale.numpy(), np.asarray(scales[f"{flax_path}/kernel"]))
    if port_name in ("conv1", "fc"):  # the all-zero channel: exact zeros, a finite scale
        row = 5 if port_name == "conv1" else 7
        assert not mod.q[row].any() and np.isfinite(mod.scale[row].item())


def test_quantized_model_keeps_batchnorm_and_biases_f32(quantized_pair):
    qmodel, _, _ = quantized_pair
    assert isinstance(qmodel.conv1, qz.QuantizedConv2d) and isinstance(qmodel.fc, qz.QuantizedDense)
    assert qmodel.bn1.weight.dtype == torch.float32 and qmodel.fc.bias.dtype == torch.float32
    assert qmodel.fc.act_scale is None  # not kept int8: dequantized like any dense layer
    assert not any(isinstance(m, torch.nn.Conv2d) for m in qmodel.modules())


def test_conv_shaped_head_is_not_a_fused_int8_head():
    """A conv-shaped head is quantized as a convolution and refused by the
    fused int8 path, as JAX ``head_kernel_key`` refuses it."""
    conv_head = {"head": {"kernel": jnp.ones((1, 1, 8, 16))}}
    qt, sc = jqz.quantize_params(conv_head)
    assert jqz.head_kernel_key(sc, qt) is None

    model = torch.nn.Module()
    model.fc = torch.nn.Conv2d(8, 16, 1)
    assert qz.head_module(model) is None
    qz.quantize_model(model, keep_head_int8=True, act_scale=0.5)
    assert isinstance(model.fc, qz.QuantizedConv2d)
    with pytest.raises(ValueError, match="kept int8"):
        qz.int8_head_operands(model)


def test_quantizer_refuses_cast_weights_and_vits():
    """It quantizes the f32 masters only, and names the vits it does not
    carry."""
    model = prepare_for_inference(_f32_model(), torch.device("cpu"), torch.bfloat16)
    with pytest.raises(ValueError, match="f32 master weights"):
        qz.quantize_model(model)
    vit, _ = initialize_model("vit_s16", 10, image_size=32)
    with pytest.raises(NotImplementedError, match="vit_s16"):
        qz.quantize_model(vit)


@pytest.mark.parametrize("act_scale", [0.5, 0.0123, 1e-3])
def test_quantize_activations_bit_equal_to_jax(act_scale):
    """Including exact .5 ties (round half to even) and saturation."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 40)).astype(np.float32)
    x[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5], np.float32) * np.float32(act_scale)
    got = qz.quantize_activations(torch.from_numpy(x), act_scale).numpy()
    want = np.asarray(jqz.quantize_activations(jnp.asarray(x), act_scale))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8 and np.abs(got).max() <= 127


def test_calibration_batch_byte_equal():
    from mpi_pytorch_tpu.config import Config as JaxConfig

    cfg = Config(width=48, height=40, seed=9, quantize_calib=5)
    want = jqz.calibration_batch(JaxConfig(width=48, height=40, seed=9, quantize_calib=5))
    got = qz.calibration_batch(cfg)
    assert got.dtype == np.uint8 and got.shape == (5, 40, 48, 3)
    np.testing.assert_array_equal(got, want)


def test_calibrate_head_act_scale_matches_jax():
    model = _f32_model(seed=2)
    state = _jax_state(model)
    images = np.random.default_rng(3).integers(0, 256, size=(8, SIZE, SIZE, 3)).astype(np.uint8)
    want = jqz.calibrate_head_act_scale(state, images, jnp.float32)
    got = qz.calibrate_head_act_scale(
        prepare_for_inference(model, torch.device("cpu"), torch.float32), images, torch.float32
    )
    np.testing.assert_allclose(np.float32(got), np.float32(want), rtol=1e-6)


def _head_inputs(rows=16, d=64, v=5000, seed=0):
    """The JAX test's inputs (numpy seeded), in the JAX layout."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(rows, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, size=(rows,)).astype(np.int32)
    labels[3] = -1
    return feats, w, b, labels


@pytest.mark.parametrize("saturate", [False, True], ids=["calibrated", "saturating"])
def test_head_predict_int8_matches_jax_interpret(saturate):
    """The port's plain int8 head against the JAX Pallas kernel in interpret
    mode at V = 5 000 (a ragged last vocab block): predictions equal on
    every row, loss within rtol 1e-5, padding rows 0."""
    feats, w, b, labels = _head_inputs(seed=5 if saturate else 0)
    w_q, w_scale = jqz.quantize_per_channel(jnp.asarray(w))
    act_scale = 1e-3 if saturate else float(np.abs(feats).max()) / 127.0
    loss_j, pred_j = jqz.head_predict_int8(
        jnp.asarray(feats), w_q, jnp.asarray(b), jnp.asarray(labels), w_scale, act_scale,
        interpret=True,
    )
    loss, pred = qz.head_predict_int8(
        torch.from_numpy(feats), torch.from_numpy(np.asarray(w_q).T.copy()), torch.from_numpy(b),
        torch.from_numpy(labels), torch.from_numpy(np.array(w_scale)), act_scale,
    )
    np.testing.assert_array_equal(pred.numpy(), np.asarray(pred_j))
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=1e-5, atol=1e-5)
    assert pred.dtype == torch.int32 and float(loss[3]) == 0.0


def test_port_quantizer_matches_jax_on_the_head():
    """``quantize_per_channel`` on the port's [V, D] layout gives JAX's
    [D, V] values transposed, and ``combined_scale`` JAX's scale_v."""
    _, w, _, _ = _head_inputs(v=700)
    q_j, s_j = jqz.quantize_per_channel(jnp.asarray(w))
    q, s = qz.quantize_per_channel(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    act = 0.0371
    want = (jnp.asarray(s_j, jnp.float32) * act).astype(jnp.float32)
    np.testing.assert_array_equal(qz.combined_scale(s, act).numpy(), np.asarray(want))


def _predict_step_pair(keep_head_int8: bool, monkeypatch, topk: int = 1):
    """(JAX predict results, port predict results) over one JAX-quantized
    state, its weights carried to the port by ``from_flax_quantized``."""
    from jax.sharding import Mesh

    from mpi_pytorch_tpu.evaluate import _make_predict_step, _make_predict_step_impl
    from mpi_pytorch_tpu_torch.evaluate import make_predict_step

    model = _f32_model(seed=4)
    state = _jax_state(model)
    images = np.random.default_rng(6).integers(0, 256, size=(8, SIZE, SIZE, 3)).astype(np.uint8)
    labels = np.array([3, 5, -1, 9, 0, 1, -1, 299], np.int32)
    act_scale = jqz.calibrate_head_act_scale(state, images, jnp.float32) if keep_head_int8 else 1.0
    qstate = jqz.quantize_state(state, keep_head_int8=keep_head_int8, act_scale=act_scale)
    mesh1 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    monkeypatch.setenv("MPT_STEM_INTERPRET", "1")
    monkeypatch.setenv("MPT_QHEAD_INTERPRET", "1")
    _make_predict_step_impl.cache_clear()
    try:
        step = _make_predict_step(mesh1, jnp.float32, fused_head=keep_head_int8, topk=topk,
                                  int8_head=keep_head_int8)
        ref_m, ref_p = step(qstate, (jnp.asarray(images), jnp.asarray(labels)))
    finally:
        _make_predict_step_impl.cache_clear()
    packed = jax.tree_util.tree_map(np.asarray, qstate.params)
    sd = from_flax_quantized(packed, jax.tree_util.tree_map(np.asarray, qstate.batch_stats),
                             "resnet18", keep_head_int8=keep_head_int8)
    qmodel = qz.quantize_model(initialize_model("resnet18", NUM_CLASSES, fused_stem=True)[0],
                               keep_head_int8=keep_head_int8)
    qmodel.load_state_dict(sd)
    qmodel = prepare_for_inference(qmodel, torch.device("cpu"), torch.float32)
    got_m, got_p = make_predict_step(torch.float32, fused_head=keep_head_int8, topk=topk,
                                     int8_head=keep_head_int8)(
        qmodel, torch.from_numpy(images), torch.from_numpy(labels)
    )
    return (ref_m, np.asarray(ref_p)), (got_m, got_p.numpy())


def test_int8_fused_predict_step_matches_jax(monkeypatch):
    """The slice as a whole: the port's int8 fused predict step (plain stem
    and plain int8 head on the CPU) against JAX ``_make_predict_step(mesh1,
    f32, fused_head=True, int8_head=True)`` over ``quantize_state(...,
    keep_head_int8=True)``, both Pallas kernels interpreted."""
    (ref_m, ref_p), (got_m, got_p) = _predict_step_pair(True, monkeypatch)
    np.testing.assert_array_equal(got_p, ref_p)
    for k in ("loss", "correct", "count"):
        np.testing.assert_allclose(float(got_m[k]), float(ref_m[k]), rtol=1e-4, atol=1e-4)


def test_int8_plain_predict_step_matches_jax(monkeypatch):
    """The plain int8 path, every weight dequantized, top-3."""
    (ref_m, ref_p), (got_m, got_p) = _predict_step_pair(False, monkeypatch, topk=3)
    np.testing.assert_array_equal(got_p, ref_p)
    for k in ("loss", "correct", "count"):
        np.testing.assert_allclose(float(got_m[k]), float(ref_m[k]), rtol=1e-4, atol=1e-4)


def test_int8_head_requires_fused():
    from mpi_pytorch_tpu_torch.evaluate import make_predict_step

    with pytest.raises(ValueError, match="int8_head"):
        make_predict_step(torch.float32, fused_head=False, int8_head=True)


def test_parity_probe_and_logit_drift_match_jax():
    from jax.sharding import Mesh

    model = _f32_model(seed=8, fused_stem=False)
    state = _jax_state(model)
    images = np.random.default_rng(9).integers(0, 256, size=(16, SIZE, SIZE, 3)).astype(np.uint8)
    mesh1 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    q_state = jqz.quantize_state(state, keep_head_int8=False)
    fmodel = prepare_for_inference(model, torch.device("cpu"), torch.float32)
    qmodel = qz.quantize_model(initialize_model("resnet18", NUM_CLASSES)[0])
    qmodel.load_state_dict(
        from_flax_quantized(jax.tree_util.tree_map(np.asarray, q_state.params),
                            jax.tree_util.tree_map(np.asarray, q_state.batch_stats), "resnet18")
    )
    qmodel = prepare_for_inference(qmodel, torch.device("cpu"), torch.float32)
    drift = qz.max_logit_drift(fmodel, qmodel, images, torch.float32)
    want = jqz.max_logit_drift(state, q_state, images, jnp.float32)
    assert 0 < drift < 1.0
    np.testing.assert_allclose(drift, want, rtol=1e-3)
    probe = qz.parity_probe(fmodel, qmodel, torch.float32, images, topk=5)
    want_p = jqz.parity_probe(state, q_state, mesh1, jnp.float32, images, topk=5)
    assert probe == want_p


# ------------------------------------------------------------------ serving


def _serve_cfg(**kw):
    base = dict(
        num_classes=NUM_CLASSES, width=SIZE, height=SIZE, compute_dtype="float32",
        input_dtype="uint8", fused_stem=True, fused_head_eval=True, serve_topk=1,
        serve_buckets="1,4,8", loader_workers=2, serve_max_wait_ms=2.0, quantize_calib=16,
    )
    base.update(kw)
    return Config(**base)


def test_server_both_precisions_switch():
    """A ``both`` server starts on bf16 with a parity stamp, switches to the
    int8 set (whose answers are the int8 predict step's) and back, and
    refuses a precision it did not build."""
    from mpi_pytorch_tpu_torch.evaluate import make_predict_step
    from mpi_pytorch_tpu_torch.serve import InferenceServer, ServeError

    images = np.random.default_rng(11).integers(0, 256, size=(12, SIZE, SIZE, 3)).astype(np.uint8)
    with InferenceServer(_serve_cfg(serve_precision="both"), device="cpu") as srv:
        assert list(srv._exe_sets) == ["bf16", "int8"]
        stats = srv.stats()
        assert stats["precision"] == "bf16" and 0.0 <= stats["parity_top1"] <= 1.0
        srv.set_precision("int8")
        assert srv.stats()["precision"] == "int8"
        got = srv.predict_batch(images, timeout=60)[:, 0]
        qmodel = srv._exe_sets["int8"].model
        _, want = make_predict_step(torch.float32, fused_head=True, int8_head=True)(
            qmodel, torch.from_numpy(images), torch.full((12,), -1, dtype=torch.int32)
        )
        np.testing.assert_array_equal(got, want.numpy())
        srv.set_precision("bf16")
        assert srv.stats()["precision"] == "bf16"
        with pytest.raises(ServeError, match="not built"):
            srv.set_precision("fp8")
    assert isinstance(qmodel.fc, qz.QuantizedDense) and qmodel.fc.act_scale is not None


def test_int8_server_quantizes_the_f32_masters():
    """A bf16 server's int8 set quantizes the f32 weights, not the bf16
    copies the float set serves, and holds fewer resident bytes."""
    from mpi_pytorch_tpu_torch.serve import InferenceServer, ServeError

    model = _f32_model(seed=12)
    sd = model.state_dict()
    cfg = _serve_cfg(compute_dtype="bfloat16", serve_precision="int8", serve_buckets="2")
    with InferenceServer(cfg, device="cpu", state_dict=sd) as srv:
        assert list(srv._exe_sets) == ["int8"] and srv.stats()["precision"] == "int8"
        assert "parity_top1" not in srv.stats()
        qmodel = srv._exe_sets["int8"].model
        q, scale = qz.quantize_per_channel(sd["layer2.0.conv1.weight"])
        np.testing.assert_array_equal(qmodel.layer2[0].conv1.q.contiguous().numpy(), q.numpy())
        np.testing.assert_array_equal(qmodel.layer2[0].conv1.scale.numpy(), scale.numpy())
        assert srv.predict_batch(np.zeros((3, SIZE, SIZE, 3), np.uint8), timeout=60).shape == (3, 1)
        with pytest.raises(ServeError, match="not built"):
            srv.set_precision("bf16")


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(serve_precision="fp16"), "serve_precision must be"),
        (dict(serve_precision="int8", fused_head_eval=True, serve_topk=3), "argmax only"),
        (dict(quantize_calib=0), "quantize_calib must be"),
    ],
    ids=["unknown", "fused_topk", "calib"],
)
def test_config_refuses_bad_precision_knobs(kw, match):
    """The port refuses what the JAX config refuses, with its words."""
    from mpi_pytorch_tpu.config import Config as JaxConfig

    with pytest.raises(ValueError, match=match) as port_err:
        Config(**kw).validate_config()
    with pytest.raises(ValueError, match=match) as jax_err:
        JaxConfig(**kw).validate_config()
    assert str(port_err.value) == str(jax_err.value)
    assert Config(serve_precision="both").parsed_serve_precisions() == ("bf16", "int8")
