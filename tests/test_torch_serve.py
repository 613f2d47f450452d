"""The port's ``InferenceServer`` on the CPU against the JAX package's
predict step, with the same weights (converted by ``to_flax_variables``)
and f32 compute on both sides; plus the batcher's semantics and the
server's lifecycle (drain on close, typed backpressure, closed errors).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu.models.resnet import resnet18 as jax_resnet18
from mpi_pytorch_tpu_torch import Config
from mpi_pytorch_tpu_torch.models.convert import to_flax_variables
from mpi_pytorch_tpu_torch.models.registry import init_weights, initialize_model
from mpi_pytorch_tpu_torch.serve import (
    DynamicBatcher,
    InferenceServer,
    PendingRequest,
    QueueFullError,
    ServeError,
    ServerClosedError,
    parse_buckets,
    pick_bucket,
)

NUM_CLASSES = 200
SIZE = 32


def _cfg(**kw):
    base = dict(
        num_classes=NUM_CLASSES, width=SIZE, height=SIZE, compute_dtype="float32",
        serve_buckets="1,4,8", loader_workers=2, serve_max_wait_ms=2.0,
    )
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def weights():
    """(port state_dict, JAX predict function over the same weights)."""
    import optax
    from jax.sharding import Mesh

    from mpi_pytorch_tpu.evaluate import _make_predict_step
    from mpi_pytorch_tpu.train.state import TrainState

    model, _ = initialize_model("resnet18", NUM_CLASSES)
    init_weights(model, torch.Generator().manual_seed(7))
    sd = model.state_dict()
    variables = jax.tree_util.tree_map(jnp.asarray, to_flax_variables(sd, "resnet18"))
    jax_model = jax_resnet18(NUM_CLASSES, dtype=jnp.float32)
    state = TrainState.create(
        apply_fn=jax_model.apply, variables=variables,
        tx=optax.identity(), rng=jax.random.PRNGKey(0),
    )
    mesh1 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))

    def jax_predict(images: np.ndarray, topk: int) -> np.ndarray:
        step = _make_predict_step(mesh1, jnp.float32, topk=topk)
        labels = jnp.full((images.shape[0],), -1, jnp.int32)
        _, preds = step(state, (jnp.asarray(images), labels))
        return np.asarray(preds).reshape(images.shape[0], -1)

    return sd, jax_predict


def _pixels(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, SIZE, SIZE, 3)).astype(np.uint8)


def test_server_fused_uint8_top1_matches_jax(weights):
    """Kernel configuration (fused stem, fused head, uint8 ingest): each
    request's top-1 is the JAX predict step's argmax on the same image."""
    sd, jax_predict = weights
    images = _pixels(0, 13)
    cfg = _cfg(input_dtype="uint8", fused_stem=True, fused_head_eval=True, serve_topk=1)
    with InferenceServer(cfg, device="cpu", state_dict=sd) as srv:
        futs = [srv.submit(im) for im in images]
        got = np.stack([f.result(timeout=60) for f in futs])
        stats = srv.stats()
    assert got.shape == (13, 1) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_predict(images, topk=1))
    assert stats["served"] == 13 and stats["failed"] == 0
    assert sum(stats["by_bucket"].values()) == stats["batches"]


def test_server_plain_float_topk_matches_jax(weights):
    """Plain path, normalized float requests and uint8 requests on the
    same server: top-3 equals JAX's top-k."""
    sd, jax_predict = weights
    from mpi_pytorch_tpu.data.pipeline import normalize_image

    px = _pixels(1, 6)
    floats = np.stack([normalize_image(p.astype(np.float32) / 255.0) for p in px])
    with InferenceServer(_cfg(serve_topk=3), device="cpu", state_dict=sd) as srv:
        got_f = srv.predict_batch(list(floats), timeout=60)
        got_u = srv.predict_batch(list(px), timeout=60)
    want = jax_predict(floats, topk=3)
    np.testing.assert_array_equal(got_f, want)
    np.testing.assert_array_equal(got_u, want)


def test_fused_head_forces_top1(weights):
    sd, _ = weights
    cfg = _cfg(fused_head_eval=True, serve_topk=3, serve_buckets="2")
    with InferenceServer(cfg, device="cpu", state_dict=sd) as srv:
        assert srv.topk == 1
        assert srv.submit(_pixels(2, 1)[0].astype(np.float32)).result(timeout=60).shape == (1,)


def test_close_drains_then_rejects(weights):
    sd, _ = weights
    srv = InferenceServer(_cfg(serve_max_wait_ms=50.0), device="cpu", state_dict=sd)
    futs = [srv.submit(im) for im in _pixels(3, 10)]
    srv.close()  # graceful drain: every queued request is served
    assert all(f.done() and f.exception() is None for f in futs)
    assert srv.stats()["served"] == 10
    with pytest.raises(ServerClosedError):
        srv.submit(_pixels(3, 1)[0])
    srv.close()  # idempotent


def test_close_without_drain_fails_queued(weights):
    sd, _ = weights
    srv = InferenceServer(_cfg(serve_max_wait_ms=5000.0, serve_buckets="8"), device="cpu", state_dict=sd)
    futs = [srv.submit(im) for im in _pixels(3, 3)]  # wait for a full bucket
    srv.close(drain=False)
    for f in futs:
        with pytest.raises(ServerClosedError):
            f.result(timeout=60)
    assert srv.stats()["failed"] == 3 and srv.stats()["served"] == 0


def test_flood_gets_typed_backpressure(weights):
    sd, _ = weights
    cfg = _cfg(serve_queue_depth=1, serve_buckets="1,8", serve_max_wait_ms=20.0, serve_topk=1)
    srv = InferenceServer(cfg, device="cpu", state_dict=sd)
    accepted, rejected = [], 0
    try:
        for im in _pixels(4, 200):
            try:
                accepted.append(srv.submit(im))
            except QueueFullError as e:
                rejected += 1
                assert e.retry_after_ms is not None and e.retry_after_ms > 0
    finally:
        srv.close()
    assert rejected > 0 and accepted
    assert all(f.result(timeout=60).shape == (1,) for f in accepted)
    stats = srv.stats()
    assert stats["rejected"] == rejected and stats["served"] == len(accepted)


def test_bad_request_fails_only_itself(weights):
    sd, _ = weights
    with InferenceServer(_cfg(input_dtype="uint8"), device="cpu", state_dict=sd) as srv:
        bad = srv.submit(np.zeros((SIZE, SIZE, 3), np.float32))  # uint8 server
        wrong = srv.submit(np.zeros((SIZE + 2, SIZE, 3), np.uint8))
        good = srv.submit(_pixels(5, 1)[0])
        assert good.result(timeout=60).shape == (5,)
        for f in (bad, wrong):
            with pytest.raises(ServeError):
                f.result(timeout=60)


def test_server_decodes_paths(weights, tmp_path):
    from PIL import Image

    sd, jax_predict = weights
    px = _pixels(6, 2)
    paths = []
    for i, p in enumerate(px):
        Image.fromarray(p).save(tmp_path / f"{i}.png")
        paths.append(str(tmp_path / f"{i}.png"))
    with InferenceServer(_cfg(input_dtype="uint8", serve_topk=1), device="cpu", state_dict=sd) as srv:
        got = srv.predict_batch(paths, timeout=60)
    np.testing.assert_array_equal(got, jax_predict(px, topk=1))  # PNG is lossless


# ----------------------------------------------------------------- batcher


def test_parse_and_pick_bucket():
    assert parse_buckets([32, 1, 8, 8]) == (1, 8, 32)
    for bad in ([], [0, 4]):
        with pytest.raises(ValueError):
            parse_buckets(bad)
    assert [pick_bucket(n, (1, 8, 32)) for n in (1, 2, 8, 9, 1000)] == [1, 8, 8, 32, 32]


def test_batcher_deadline_full_bucket_and_drain():
    b = DynamicBatcher(buckets=(8,), max_wait_s=0.05, max_queue=16)
    t0 = time.monotonic()
    for i in range(3):
        b.submit(PendingRequest(payload=i, future=None))
    assert [r.payload for r in b.next_flush()] == [0, 1, 2]
    assert 0.03 <= time.monotonic() - t0 < 2.0  # flushed by the deadline

    b2 = DynamicBatcher(buckets=(1, 4), max_wait_s=10.0, max_queue=16)
    for i in range(4):
        b2.submit(PendingRequest(payload=i, future=None))
    t0 = time.monotonic()
    assert len(b2.next_flush()) == 4  # a full bucket does not wait
    assert time.monotonic() - t0 < 1.0
    b2.submit(PendingRequest(payload=9, future=None))
    b2.close()
    assert [r.payload for r in b2.next_flush()] == [9]
    assert b2.next_flush() is None
    with pytest.raises(ServerClosedError):
        b2.submit(PendingRequest(payload=10, future=None))


def test_batcher_backlog_coalesces_full_buckets():
    b = DynamicBatcher(buckets=(1, 8), max_wait_s=0.0, max_queue=64)
    for i in range(20):
        b.submit(PendingRequest(payload=i, future=None))
    time.sleep(0.01)  # everything queued is past the 0 ms deadline
    assert [len(b.next_flush()) for _ in range(3)] == [8, 8, 4]
    for i in range(3):
        b.submit(PendingRequest(payload=i, future=None))
    assert [r.payload for r in b.drain_ready(2)] == [0, 1]


def test_config_validation():
    assert Config(serve_buckets="8,1;32").parsed_serve_buckets() == (1, 8, 32)
    bad = [
        dict(serve_buckets=""), dict(serve_buckets="1,frog"), dict(serve_topk=0),
        dict(serve_topk=6), dict(serve_max_wait_ms=-1), dict(serve_queue_depth=0),
        dict(model_name="vit_s16"), dict(width=30, fused_stem=True),
        dict(input_dtype="bfloat16"),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            Config(**kw).validate_config()
    Config(width=32, height=32, fused_stem=True).validate_config()


def test_warmup_failure_raises_from_constructor(weights, monkeypatch):
    """Warmup runs on the serving thread; its failure surfaces from the
    constructor and leaves no thread behind."""
    import threading

    from mpi_pytorch_tpu_torch.serve import BucketExecutables

    sd, _ = weights

    def boom(self):
        raise RuntimeError("warmup exploded")

    monkeypatch.setattr(BucketExecutables, "warmup", boom)
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(RuntimeError, match="warmup exploded"):
        InferenceServer(_cfg(), device="cpu", state_dict=sd)
    time.sleep(0.1)
    assert "serve-batch" not in {t.name for t in threading.enumerate()} - before
