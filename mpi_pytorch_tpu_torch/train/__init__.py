from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer
from mpi_pytorch_tpu_torch.train.step import make_eval_step, make_spmd_train_step, make_train_step
from mpi_pytorch_tpu_torch.train.trainer import (
    TrainSummary,
    build_training,
    evaluate_manifest,
    main,
    train,
)

__all__ = [
    "TrainState",
    "TrainSummary",
    "build_training",
    "evaluate_manifest",
    "main",
    "make_eval_step",
    "make_optimizer",
    "make_spmd_train_step",
    "make_train_step",
    "train",
]
