"""The port's evaluate CLI on two gloo ranks against one process, on
the CPU.

``python -m mpi_pytorch_tpu_torch.evaluate``'s ``main`` runs in each rank
of a two-rank world (``parallel.launch.run_world``, torchrun's
environment, 120 s) over one checkpoint: resnet18 at 32 px, a 64-wide
head, f32, global batch 4 (2 rows a rank). The DEBUG sample of 32 rows
leaves 7 test rows, which divide by neither 2 nor the batch: the ranks'
shards hold 4 and 3 rows, rank 1's second batch one real row.

- The predictions CSV rank 0 writes from the gathered rows is
  byte-identical to the one-process CSV from the same checkpoint (which
  ``tests/test_torch_evaluate.py`` holds against the JAX ``evaluate``),
  with the plain stem and head and with the fused stem and fused head
  (their plain versions here); the accuracy is the same number and the mean loss rtol
  1e-6 (two shards' float64 sums against one); the metrics file holds one
  record.
- The metrics-only pass gives the same accuracy.
- ``--quantize-eval`` runs on every rank, as the JAX package runs it on
  every process: each rank's report is the one-process report, written
  once.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch import evaluate as port_eval
from mpi_pytorch_tpu_torch.config import parse_config
from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training
from mpi_pytorch_tpu_torch.parallel.launch import run_world
from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer
from test_torch_dp_step import RANK_ENV, rank_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(REPO, "tests")
WORLD = 2


def _argv(ckpt_dir: str, out: str, *extra: str) -> list[str]:
    return [
        "--debug", "true", "--debug-sample-size", "32", "--num-classes", "64",
        "--image-size", "32", "--batch-size", "4", "--compute-dtype", "float32",
        "--loader-workers", "2", "--serve-topk", "1",
        "--test-csv", os.path.join(REPO, "data", "test_sample.csv"),
        "--checkpoint-dir", ckpt_dir,
        "--eval-log-file", os.path.join(out, "evaluation.log"),
        "--metrics-file", os.path.join(out, "metrics.jsonl"), *extra,
    ]


def evaluate_worker(payload: dict) -> dict:
    """One rank: the evaluate CLI entry point."""
    out = port_eval.main(payload["argv"])
    return out if isinstance(out, dict) else dataclasses.asdict(out)


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    """A checkpoint of seeded weights (bias rows moved, so the head's
    argmax is not one class)."""
    root = str(tmp_path_factory.mktemp("dp_eval_ckpt"))
    bundle = create_model_bundle("resnet18", 64, seed=3)
    model = prepare_for_training(bundle.model, torch.device("cpu"))
    with torch.no_grad():
        model.fc.bias.copy_(torch.linspace(-0.5, 0.5, 64)[torch.randperm(
            64, generator=torch.Generator().manual_seed(0))])
    opt, schedule = make_optimizer(model, 4e-4)
    ckpt.save_checkpoint(root, epoch=0, state=TrainState(model, opt, schedule), loss=0.0)
    return root


def _records(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_stem_fused_head"])
def test_two_rank_predictions_csv_is_the_one_process_csv(fused, checkpoint_dir, tmp_path):
    flags = ["--fused-stem", "true", "--fused-head-eval", "true"] if fused else []
    dp_out, one_out = tmp_path / "dp", tmp_path / "one"
    dp_out.mkdir()
    one_out.mkdir()
    dp_argv = _argv(checkpoint_dir, str(dp_out), *flags,
                    "--predictions-file", str(dp_out / "p.csv"))
    ranks = run_world("test_torch_dp_evaluate:evaluate_worker", WORLD, {"argv": dp_argv},
                      timeout_s=120, env=RANK_ENV, pythonpath=[HERE])
    with rank_threads():
        one = port_eval.evaluate(
            parse_config(_argv(checkpoint_dir, str(one_out), *flags,
                               "--predictions-file", str(one_out / "p.csv"))), device="cpu")
    got, want = (dp_out / "p.csv").read_bytes(), (one_out / "p.csv").read_bytes()
    assert got == want and len(got.splitlines()) == 1 + 7
    assert len({line.split(b",")[1] for line in got.splitlines()[1:]}) > 1
    for r in ranks:
        assert (r["accuracy"], r["num_images"]) == (one.accuracy, one.num_images) == (
            r["accuracy"], 7)
        np.testing.assert_allclose(r["mean_loss"], one.mean_loss, rtol=1e-6)
    assert [rec["kind"] for rec in _records(str(dp_out / "metrics.jsonl"))] == ["eval"]


def test_two_rank_metrics_pass_and_quantize_eval(checkpoint_dir, tmp_path):
    dp_out, one_out = tmp_path / "dp", tmp_path / "one"
    dp_out.mkdir()
    one_out.mkdir()
    ranks = run_world("test_torch_dp_evaluate:evaluate_worker", WORLD,
                      {"argv": _argv(checkpoint_dir, str(dp_out))},
                      timeout_s=120, env=RANK_ENV, pythonpath=[HERE])
    with rank_threads():
        one = port_eval.evaluate(parse_config(_argv(checkpoint_dir, str(one_out))),
                                 device="cpu")
    assert [r["accuracy"] for r in ranks] == [one.accuracy] * WORLD

    quant = ["--quantize-eval", "true", "--quantize-calib", "8"]
    reports = run_world("test_torch_dp_evaluate:evaluate_worker", WORLD,
                        {"argv": _argv(checkpoint_dir, str(dp_out), *quant)},
                        timeout_s=120, env=RANK_ENV, pythonpath=[HERE])
    with rank_threads():
        want = port_eval.quantize_eval_report(
            parse_config(_argv(checkpoint_dir, str(one_out), *quant)), device="cpu")
    assert reports == [want] * WORLD
    kinds = [rec["kind"] for rec in _records(str(dp_out / "metrics.jsonl"))]
    assert kinds == ["eval", "quant_parity"]
