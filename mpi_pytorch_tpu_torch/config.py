"""Serving configuration — the subset of ``mpi_pytorch_tpu.config.Config``
this port reads, under the same field names and defaults.

Only the fields the serving path uses are carried; ``validate_config``
carries the matching checks (model family, fused-stem geometry, serve
buckets and top-k). Fields are added here as later slices port the code
that reads them.
"""

from __future__ import annotations

from dataclasses import dataclass

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

SUPPORTED_MODELS = ("resnet18", "resnet34")


@dataclass
class Config:
    """Serving knobs. Defaults mirror the JAX package's ``Config``."""

    # --- model ---
    model_name: str = "resnet18"
    num_classes: int = 64500
    width: int = 128
    height: int = 128

    # --- precision ---
    compute_dtype: str = "bfloat16"  # params stay float32
    # Host batch dtype: float32 rows arrive normalized; uint8 ships raw
    # pixels and the predict step normalizes on the device
    # (train/step.py ingest_images).
    input_dtype: str = "float32"

    # --- kernels ---
    # bn1 + relu + maxpool(3, 2, 1) as one kernel (ops/fused_stem.py).
    fused_stem: bool = False
    # Predict head as one streaming kernel: per-row loss + argmax without
    # the [B, num_classes] logits (ops/fused_head_ce.py head_predict).
    fused_head_eval: bool = False

    # --- input pipeline ---
    seed: int = 0
    loader_workers: int = 8

    # --- online serving ---
    serve_buckets: str = "1,8,32,128,512"
    serve_max_wait_ms: float = 5.0
    serve_queue_depth: int = 1024
    serve_topk: int = 5

    def validate_config(self) -> None:
        if self.model_name not in SUPPORTED_MODELS:
            raise ValueError(
                f"unsupported model {self.model_name!r}; expected one of "
                f"{SUPPORTED_MODELS}"
            )
        if self.num_classes < 2:
            raise ValueError(f"num_classes must be >= 2, got {self.num_classes}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32|bfloat16, got {self.compute_dtype}"
            )
        if self.input_dtype not in ("float32", "uint8"):
            raise ValueError(
                f"input_dtype must be float32|uint8, got {self.input_dtype} "
                "(bfloat16 host batches are not ported yet)"
            )
        self.parsed_serve_buckets()  # raises on a malformed bucket list
        if not 1 <= self.serve_topk <= 5:
            raise ValueError(
                f"serve_topk must be in 1..5, got {self.serve_topk} (the "
                "serving contract is a handful of candidates, not a ranking "
                "of all classes)"
            )
        if self.serve_topk > self.num_classes:
            raise ValueError(
                f"serve_topk={self.serve_topk} exceeds num_classes="
                f"{self.num_classes}"
            )
        if self.serve_max_wait_ms < 0:
            raise ValueError(
                f"serve_max_wait_ms must be >= 0, got {self.serve_max_wait_ms}"
            )
        if self.serve_queue_depth < 1:
            raise ValueError(
                f"serve_queue_depth must be >= 1, got {self.serve_queue_depth}"
            )
        if self.fused_stem:
            from mpi_pytorch_tpu_torch.models.registry import FUSED_STEM_MODELS

            if self.model_name not in FUSED_STEM_MODELS:
                raise ValueError(
                    f"fused_stem is only implemented for the 7×7-stem family "
                    f"({', '.join(FUSED_STEM_MODELS)}); {self.model_name!r} "
                    "has no such stem"
                )

            # conv1 output dim: 7×7/s2/p3 → (N-1)//2 + 1.
            def post_conv(n: int) -> int:
                return (n - 1) // 2 + 1

            if post_conv(self.width) % 2 or post_conv(self.height) % 2:
                raise ValueError(
                    "fused_stem needs even post-conv spatial dims; "
                    f"{self.width}x{self.height} gives "
                    f"{post_conv(self.width)}x{post_conv(self.height)}"
                )

    @property
    def image_size(self) -> tuple[int, int]:
        """Resize target (H, W)."""
        return (self.height, self.width)

    def parsed_serve_buckets(self) -> tuple[int, ...]:
        """``serve_buckets`` as a sorted deduped tuple of positive ints.
        Raises on an empty or non-positive list."""
        try:
            buckets = sorted(
                {
                    int(b)
                    for b in self.serve_buckets.replace(";", ",").split(",")
                    if b.strip()
                }
            )
        except ValueError:
            raise ValueError(
                f"serve_buckets must be comma-separated ints, got "
                f"{self.serve_buckets!r}"
            ) from None
        if not buckets or buckets[0] < 1:
            raise ValueError(
                f"serve_buckets needs at least one positive size, got "
                f"{self.serve_buckets!r}"
            )
        return tuple(buckets)
