"""Online inference: dynamic batcher, per-bucket predict set, server."""

from mpi_pytorch_tpu_torch.serve.batcher import (
    DynamicBatcher,
    PendingRequest,
    PreprocessError,
    QueueFullError,
    ServeError,
    ServerClosedError,
    parse_buckets,
    pick_bucket,
)
from mpi_pytorch_tpu_torch.serve.executables import BucketExecutables
from mpi_pytorch_tpu_torch.serve.server import InferenceServer

__all__ = [
    "BucketExecutables",
    "DynamicBatcher",
    "InferenceServer",
    "PendingRequest",
    "PreprocessError",
    "QueueFullError",
    "ServeError",
    "ServerClosedError",
    "parse_buckets",
    "pick_bucket",
]
