"""The port's ``evaluate`` against the JAX package's, on the CPU, from
one shared checkpoint: the predictions CSV, loss and accuracy, the
``--quantize-eval`` report, ``--track-best`` / ``--use-best``, the records
and the ``python -m mpi_pytorch_tpu_torch.evaluate`` entry point.

The weights are one seeded set (random positive batchnorm statistics),
written both as a JAX msgpack checkpoint and, through
``models.convert.from_flax_variables``, as a port checkpoint. Half the
test split's classes get a prototype head row (the features of the class's
synthetic image, whose logit is largest on that image), so the accuracy is
far from zero; two more test classes are sent to a class of the train split
alone and to a label in neither split, so every branch of the label →
category map is read. resnet18 at 32 px,
300 classes (contiguous labels, not raw ids), batch 16 over 40 test rows so
the tail batch is padded; f32 on both sides, TF32 off. The JAX Pallas
kernels run in interpret mode (``MPT_STEM_INTERPRET``,
``MPT_HEAD_INTERPRET``); the port runs their plain versions.

The JAX and torch f32 convolutions round differently, so a row whose top-2
logits nearly tie may flip its argmax: such rows (top-2 gap at most
``NEAR_TIE``·|max| in the JAX logits) are counted and printed, and may
differ only between the JAX top-2 labels; every other row must be
byte-identical.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_pytorch_tpu import config as jax_config
from mpi_pytorch_tpu.models.resnet import resnet18 as jax_resnet18
from mpi_pytorch_tpu.obs.schema import validate_record
from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch import evaluate as port_eval
from mpi_pytorch_tpu_torch.config import Config
from mpi_pytorch_tpu_torch.data.manifest import load_manifests
from mpi_pytorch_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from mpi_pytorch_tpu_torch.models.registry import init_weights, initialize_model, prepare_for_inference
from mpi_pytorch_tpu_torch.train import trainer
from mpi_pytorch_tpu_torch.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 300
SIZE = 32
BATCH = 16
ROWS = 200  # DEBUG sample: 160 train rows, 40 test rows (16 + 16 + 8 padded)
NEAR_TIE = 1e-4
HEADER = "file_name,predicted_label,predicted_category_id"
COMMON = dict(
    debug=True, debug_sample_size=ROWS, num_classes=NUM_CLASSES, width=SIZE, height=SIZE,
    batch_size=BATCH, compute_dtype="float32", loader_workers=2, seed=0,
    train_csv=os.path.join(REPO, "data", "train_sample.csv"),
    test_csv=os.path.join(REPO, "data", "test_sample.csv"),
)


@pytest.fixture(autouse=True)
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.fixture
def interpret(monkeypatch):
    """The JAX Pallas kernels through the interpreter, with fresh predict
    step caches (the gates are read when a step is built)."""
    from mpi_pytorch_tpu.evaluate import _make_predict_step_impl

    monkeypatch.setenv("MPT_STEM_INTERPRET", "1")
    monkeypatch.setenv("MPT_HEAD_INTERPRET", "1")
    _make_predict_step_impl.cache_clear()
    yield
    _make_predict_step_impl.cache_clear()


def _test_images(cfg: Config) -> tuple[np.ndarray, np.ndarray]:
    """(images, labels) of the test manifest in order, as the eval loader
    gives them (byte-identical to the JAX loader's)."""
    _, test = load_manifests(cfg)
    batches = list(trainer.make_loader(cfg, test, train=False).epoch(0))
    return np.concatenate([b[0] for b in batches]), np.concatenate([b[1] for b in batches])


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """{"jax_dir", "port_dir", "variables", "logits"}: one set of seeded
    weights as a JAX and as a port checkpoint, and the JAX model's f32
    logits of the test rows."""
    import optax

    from mpi_pytorch_tpu import checkpoint as jax_ckpt
    from mpi_pytorch_tpu.train.state import TrainState as JaxTrainState

    root = tmp_path_factory.mktemp("shared")
    model, _ = initialize_model("resnet18", NUM_CLASSES)
    init_weights(model, torch.Generator().manual_seed(11))
    model = prepare_for_inference(model, torch.device("cpu"), torch.float32)
    images, labels = _test_images(Config(**COMMON))
    train_m, _ = load_manifests(Config(**COMMON))
    test_classes = sorted(set(labels.tolist()))
    train_only = sorted(set(train_m.labels.tolist()) - set(test_classes))
    # head row → the test class whose image's features it holds: every
    # other test class its own, plus a train-only class and a label in
    # neither split (NUM_CLASSES − 1) for two others.
    rows = {c: c for c in test_classes[::2]}
    rows.update({train_only[0]: test_classes[3], NUM_CLASSES - 1: test_classes[1]})
    assert NUM_CLASSES - 1 not in set(train_m.labels.tolist()) | set(test_classes)
    with torch.no_grad():
        feats = model.features(torch.from_numpy(images).permute(0, 3, 1, 2)).double()
        # Prototype rows: logit_c(f) = s·(|f|² − |f − f_c|²)/2, largest on
        # f = f_c.
        protos = torch.stack([feats[int(np.flatnonzero(labels == c)[0])] for c in rows.values()])
        s = 4.0 / float((protos**2).sum(1).mean())
        model.fc.weight[list(rows)] = (s * protos).float()
        model.fc.bias[list(rows)] = (-0.5 * s * (protos**2).sum(1)).float()
    variables = to_flax_variables(model.state_dict(), "resnet18")

    jax_dir = str(root / "jax_ckpt")
    state = JaxTrainState.create(
        apply_fn=jax_resnet18(NUM_CLASSES, dtype=jnp.float32).apply,
        variables=jax.tree_util.tree_map(jnp.asarray, variables),
        tx=optax.identity(), rng=jax.random.PRNGKey(0),
    )
    jax_ckpt.save_checkpoint(jax_dir, epoch=0, state=state, loss=0.0)

    port_dir = str(root / "port_ckpt")
    port_model, _ = initialize_model("resnet18", NUM_CLASSES)
    port_model.load_state_dict(from_flax_variables(variables, "resnet18"))
    port_state = TrainState(model=port_model, optimizer=torch.optim.Adam(port_model.parameters()),
                            schedule=lambda step: 1e-3)
    ckpt.save_checkpoint(port_dir, epoch=0, state=port_state, loss=0.0)

    logits = np.asarray(jax_resnet18(NUM_CLASSES, dtype=jnp.float32).apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(images), train=False))
    return {"jax_dir": jax_dir, "port_dir": port_dir, "logits": logits, "labels": labels}


def _cfgs(tmp_path, shared, tag: str, **kw):
    """(JAX Config, port Config) of one evaluation, each over its own
    checkpoint and writing its own files."""
    out = []
    for side, cls in (("jax", jax_config.Config), ("port", Config)):
        d = tmp_path / f"{tag}_{side}"
        d.mkdir()
        cfg = cls(**COMMON, checkpoint_dir=shared[f"{side}_dir"],
                  metrics_file=str(d / "metrics.jsonl"), eval_log_file=str(d / "evaluation.log"),
                  log_file=str(d / "training.log"), **kw)
        cfg.validate_config()
        out.append(cfg)
    return out


def _records(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _csv(path: str) -> tuple[str, list[str]]:
    with open(path) as f:
        header, *rows = f.read().splitlines()
    return header, rows


@pytest.mark.parametrize("fused_head", [True, False], ids=["fused_head", "plain_head"])
@pytest.mark.parametrize("fused_stem", [True, False], ids=["fused_stem", "plain_stem"])
def test_predictions_csv_matches_jax(fused_stem, fused_head, tmp_path, shared, interpret,
                                     monkeypatch):
    from mpi_pytorch_tpu.evaluate import evaluate as jax_evaluate

    jcfg, pcfg = _cfgs(tmp_path, shared, "pred", fused_stem=fused_stem,
                       fused_head_eval=fused_head)
    jcfg.predictions_file = str(tmp_path / "jax.csv")
    pcfg.predictions_file = str(tmp_path / "port.csv")
    want = jax_evaluate(jcfg)
    calls = []

    def head_predict(*args):
        calls.append(args[0].shape[0])
        return real_head(*args)

    real_head = port_eval.head_predict
    monkeypatch.setattr(port_eval, "head_predict", head_predict)
    got = port_eval.evaluate(pcfg, device="cpu")
    # The streaming head, with its operands cut once, on every padded batch.
    assert calls == ([BATCH] * 3 if fused_head else [])

    j_header, j_rows = _csv(jcfg.predictions_file)
    p_header, p_rows = _csv(pcfg.predictions_file)
    assert p_header == j_header == HEADER
    assert [r.split(",")[0] for r in p_rows] == [r.split(",")[0] for r in j_rows]
    assert len(p_rows) == got.num_images == want.num_images == 40

    logits = shared["logits"]
    top2 = np.argsort(-logits, axis=1, kind="stable")[:, :2]
    top = np.take_along_axis(logits, top2, axis=1)
    near = (top[:, 0] - top[:, 1]) <= NEAR_TIE * np.abs(top[:, 0])
    differ = [i for i, (p, j) in enumerate(zip(p_rows, j_rows)) if p != j]
    for i in differ:
        assert near[i], f"row {i} differs off a near tie: port {p_rows[i]!r}, jax {j_rows[i]!r}"
        assert int(p_rows[i].split(",")[1]) in top2[i], (i, p_rows[i], top2[i])
    print(f"evaluate parity, fused stem {fused_stem}, fused head {fused_head}: "
          f"{int(near.sum())} near-tie rows of {len(near)}, {len(differ)} differ")

    np.testing.assert_allclose(got.mean_loss, want.mean_loss, rtol=1e-5)
    if not differ:
        assert got.accuracy == want.accuracy
    assert got.accuracy > 0.2  # the prototype classes are found


def test_predictions_csv_reproduces_accuracy(tmp_path, shared):
    """The share of CSV rows whose category is the true one is the
    reported accuracy, and the CSV's labels map to raw category ids."""
    _, cfg = _cfgs(tmp_path, shared, "acc", predictions_file=str(tmp_path / "p.csv"))
    res = port_eval.evaluate(cfg, device="cpu")
    train_m, test_m = load_manifests(cfg)
    header, rows = _csv(cfg.predictions_file)
    body = [r.split(",") for r in rows]
    assert header == HEADER and [b[0] for b in body] == list(test_m.filenames)
    label_to_cat = dict(zip(np.concatenate([train_m.labels, test_m.labels]).tolist(),
                            np.concatenate([train_m.category_ids, test_m.category_ids]).tolist()))
    assert all(int(b[2]) == label_to_cat.get(int(b[1]), -1) for b in body)
    predicted = {int(b[1]) for b in body}
    assert predicted - set(test_m.labels.tolist()) - {NUM_CLASSES - 1}  # a train-only label
    assert "-1" in {b[2] for b in body}  # a label in neither split
    correct = sum(int(b[2]) == int(c) for b, c in zip(body, test_m.category_ids))
    assert 0 < res.accuracy == pytest.approx(correct / len(body), abs=1e-12)
    # The metrics-only pass gives the same numbers from the shared eval step.
    plain = port_eval.evaluate(dataclasses.replace(cfg, predictions_file=""), device="cpu")
    assert plain.accuracy == res.accuracy
    np.testing.assert_allclose(plain.mean_loss, res.mean_loss, rtol=1e-6)


def _train_cfg(tmp_path, **kw):
    base = dict(
        COMMON, debug_sample_size=60, num_epochs=3, input_dtype="uint8", fused_stem=True,
        validate=True, track_best=True, keep_checkpoints=1, log_every_steps=0,
        checkpoint_dir=str(tmp_path / "ckpt"), log_file=str(tmp_path / "training.log"),
        metrics_file=str(tmp_path / "metrics.jsonl"),
        eval_log_file=str(tmp_path / "evaluation.log"),
    )
    base.update(kw)
    return Config(**base)


def test_track_best_pins_checkpoint_and_eval_uses_it(tmp_path, monkeypatch):
    """--track-best with keep_checkpoints=1: best.json names the best
    epoch's file, which retention keeps while newer files churn past it; a
    resumed run does not demote it; evaluate --use-best loads exactly that
    file. Validation runs for real; its accuracies are then scripted, so
    the best epoch is an older one."""
    real = trainer.evaluate_manifest
    scripted = [0.5, 0.9, 0.3, 0.6]

    def validate(*args, **kw):
        _, loss = real(*args, **kw)
        return scripted.pop(0), loss

    monkeypatch.setattr(trainer, "evaluate_manifest", validate)
    cfg = _train_cfg(tmp_path)
    summary = trainer.train(cfg, device="cpu")
    marker = ckpt.best_marker(cfg.checkpoint_dir)
    assert marker == {"epoch": 1, "accuracy": 0.9, "checkpoint": "ckpt_00001.pt"}
    assert summary.best_accuracy == 0.9 and summary.val_accuracy == 0.3
    names = [os.path.basename(p) for p in ckpt.checkpoint_paths(cfg.checkpoint_dir)]
    assert names == ["ckpt_00001.pt", "ckpt_00002.pt"]  # the last one plus the pinned best

    resumed = trainer.train(dataclasses.replace(cfg, num_epochs=4, from_checkpoint=True),
                            device="cpu")
    assert resumed.epochs_run == 1 and resumed.best_accuracy is None
    assert ckpt.best_marker(cfg.checkpoint_dir) == marker
    names = [os.path.basename(p) for p in ckpt.checkpoint_paths(cfg.checkpoint_dir)]
    assert names == ["ckpt_00001.pt", "ckpt_00003.pt"]

    best = port_eval.evaluate(dataclasses.replace(cfg, use_best=True), device="cpu")
    with open(cfg.eval_log_file) as f:
        assert f"loaded checkpoint {os.path.join(cfg.checkpoint_dir, 'ckpt_00001.pt')}" in f.read()
    alone = tmp_path / "alone"
    alone.mkdir()
    os.link(os.path.join(cfg.checkpoint_dir, "ckpt_00001.pt"), alone / "ckpt_00001.pt")
    direct = port_eval.evaluate(dataclasses.replace(cfg, checkpoint_dir=str(alone)), device="cpu")
    assert (best.accuracy, best.mean_loss, best.num_images) == (
        direct.accuracy, direct.mean_loss, direct.num_images)
    latest = port_eval.evaluate(cfg, device="cpu")
    assert latest.mean_loss != best.mean_loss  # epoch 3's weights, not epoch 1's

    with pytest.raises(FileNotFoundError, match="best.json"):
        port_eval.evaluate(dataclasses.replace(cfg, use_best=True, checkpoint_dir=str(alone)),
                           device="cpu")


def test_track_best_requires_validation():
    with pytest.raises(ValueError, match="track_best"):
        Config(track_best=True, validate=False).validate_config()


@pytest.mark.parametrize("fused_head", [True, False], ids=["fused_int8", "plain_int8"])
def test_quantize_eval_report_matches_jax(fused_head, tmp_path, shared, interpret, monkeypatch):
    from mpi_pytorch_tpu.evaluate import quantize_eval_report as jax_report

    monkeypatch.setenv("MPT_QHEAD_INTERPRET", "1")
    jcfg, pcfg = _cfgs(tmp_path, shared, "quant", fused_stem=True, fused_head_eval=fused_head,
                       quantize_eval=True, quantize_calib=24, serve_topk=5 - 4 * fused_head)
    want = jax_report(jcfg)
    got = port_eval.quantize_eval_report(pcfg, device="cpu")
    assert got.keys() == want.keys()
    assert got["samples"] == want["samples"] == 24
    assert (got["kind"], got["precision"], got["model"]) == ("quant_parity", "int8", "resnet18")
    tol = 1.0 / got["samples"]
    assert abs(got["top1_agree"] - want["top1_agree"]) <= tol
    if fused_head:
        assert got["top5_agree"] is None and want["top5_agree"] is None
    else:
        assert abs(got["top5_agree"] - want["top5_agree"]) <= tol
    np.testing.assert_allclose(got["max_logit_drift"], want["max_logit_drift"], rtol=1e-3)
    (record,) = _records(pcfg.metrics_file)
    assert record == {"ts": record["ts"], **got}
    assert validate_record(record) == []


def test_eval_record_validates(tmp_path, shared):
    _, cfg = _cfgs(tmp_path, shared, "rec")
    res = port_eval.evaluate(cfg, device="cpu")
    (record,) = _records(cfg.metrics_file)
    assert validate_record(record) == []
    assert (record["kind"], record["accuracy"], record["loss"], record["images"]) == (
        "eval", res.accuracy, res.mean_loss, 40)


def test_evaluate_main_on_the_cpu(tmp_path, shared, monkeypatch):
    """``python -m mpi_pytorch_tpu_torch.evaluate``'s ``main`` under
    ``MPT_PLATFORM=cpu``: the predictions pass, then ``--quantize-eval``."""
    for key in list(os.environ):
        if key.startswith("MPT_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("MPT_PLATFORM", "cpu")
    argv = [
        "--debug-sample-size", str(ROWS), "--num-classes", str(NUM_CLASSES),
        "--image-size", str(SIZE), "--batch-size", str(BATCH), "--compute-dtype", "float32",
        "--loader-workers", "2", "--checkpoint-dir", shared["port_dir"],
        "--train-csv", COMMON["train_csv"], "--test-csv", COMMON["test_csv"],
        "--metrics-file", str(tmp_path / "metrics.jsonl"),
        "--eval-log-file", str(tmp_path / "evaluation.log"),
    ]
    res = port_eval.main(argv + ["--predictions-file", str(tmp_path / "p.csv")])
    assert isinstance(res, port_eval.EvalSummary) and res.num_images == 40
    _, rows = _csv(str(tmp_path / "p.csv"))
    assert len(rows) == 40
    report = port_eval.main(argv + ["--quantize-eval", "true", "--quantize-calib", "8"])
    assert report["kind"] == "quant_parity" and report["samples"] == 8
    assert [r["kind"] for r in _records(str(tmp_path / "metrics.jsonl"))] == ["eval", "quant_parity"]
    with open(tmp_path / "evaluation.log") as f:
        assert "loaded checkpoint" in f.read()
