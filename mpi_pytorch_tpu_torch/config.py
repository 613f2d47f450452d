"""Configuration — the subset of ``mpi_pytorch_tpu.config.Config`` this
port reads, under the same field names and defaults, and ``parse_config``
with the same strict ``--kebab-case`` flags.

Only the fields the ported paths use are carried (serving, the
data-parallel trainer and evaluation); ``validate_config`` carries the
matching checks. Fields are added here as later slices port the code that
reads them. The parallel knobs the JAX package has and the port does not
run yet (axis names, pipeline stages) are carried with their JAX names and
defaults and refused when set to anything else.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Sequence

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

SUPPORTED_MODELS = ("resnet18", "resnet34", "vit_s16", "vit_b16")

# Models of the JAX package that this port refuses, and why.
NOT_PORTED_MODELS = {
    "vit_moe_s16": "its MoE MLPs (ops/moe.py) and expert parallelism are not ported yet",
}

ATTN_IMPLS = ("full", "flash", "fused-small")

# Where the JAX package's parallel knobs the port refuses are queued.
_NOT_PORTED_DP = "not ported yet (ROADMAP A7)"


@dataclass
class MeshConfig:
    """The parallel layout, with the JAX ``MeshConfig``'s fields and
    defaults, over the world ``torchrun`` starts (one rank per GPU): a
    data axis of ``data_parallel`` ranks (-1: every rank the model axis
    leaves) and a model axis of ``model_parallel`` ranks
    (``--mesh.model-parallel``, the vocab-sharded head of the auto step;
    ``parallel/mesh.py``). ``pods > 1`` (``--mesh-pods``, spmd mode)
    factors the data axis into the nested (pod, ici) pair. Any other axis
    name or size is refused (:meth:`validate`)."""

    data_axis: str = "data"
    model_axis: str = "model"
    pipe_axis: str = "pipe"
    pod_axis: str = "pod"
    ici_axis: str = "ici"
    # -1 means "all remaining devices" on that axis.
    data_parallel: int = -1
    model_parallel: int = 1
    pipe_parallel: int = 1
    pods: int = 1

    def validate(self) -> None:
        if self.model_parallel < 1:
            raise ValueError(f"model_parallel must be >= 1, got {self.model_parallel}")
        if self.data_parallel == 0 or self.data_parallel < -1:
            raise ValueError(
                f"mesh data_parallel must be -1 (every rank) or >= 1, got {self.data_parallel}"
            )
        if self.pods < 1:
            raise ValueError(f"mesh pods must be >= 1, got {self.pods}")
        if self.pods > 1 and self.pipe_parallel > 1:
            raise ValueError(
                "mesh pods (hierarchical data axis) does not compose with "
                "pipe_parallel — the pipe axis claims the trailing reshape "
                "position the nested layout needs"
            )
        for f in dataclasses.fields(self):
            if (f.name not in ("data_parallel", "model_parallel", "pods")
                    and getattr(self, f.name) != f.default):
                raise ValueError(f"mesh {f.name}={getattr(self, f.name)!r}: {_NOT_PORTED_DP}; "
                                 f"the port runs the data and model axes, as {f.default!r}")

    def data_size(self, world: int) -> int:
        """The data axis's rank count in a world of ``world`` ranks."""
        return self.data_parallel if self.data_parallel > 0 else world // self.model_parallel

    def check_world(self, world: int) -> None:
        """Raise unless the layout fits a world of ``world`` ranks (the JAX
        ``create_mesh``'s checks, in its words: the model axis divides the
        world, data × model is the world, the data axis factors as
        ``pods`` × ici)."""
        mp, pp = self.model_parallel, self.pipe_parallel
        if world % (mp * pp):
            raise ValueError(
                f"{world} devices not divisible by model_parallel={mp} x pipe_parallel={pp}"
            )
        dp = self.data_size(world)
        if dp * mp * pp != world:
            raise ValueError(
                f"data_parallel×model_parallel×pipe_parallel = {dp}×{mp}×{pp} != {world} "
                f"devices: mesh data_parallel={self.data_parallel} but the world has {world} "
                "rank(s): launch that many (torchrun --nproc-per-node), or leave it -1"
            )
        if dp % self.pods:
            raise ValueError(
                f"data-parallel size {dp} not divisible by pods={self.pods}; "
                "the data axis factors as pods × ici"
            )


@dataclass
class Config:
    """Serving and training knobs. Defaults mirror the JAX package's
    ``Config``."""

    # --- model ---
    model_name: str = "resnet18"
    num_classes: int = 64500
    feature_extract: bool = False
    width: int = 128
    height: int = 128

    # --- run mode ---
    from_checkpoint: bool = False
    validate: bool = True
    debug: bool = True
    debug_sample_size: int = 1000  # DEBUG samples this many rows, seed cfg.seed

    # --- data ---
    train_csv: str = "data/train_sample.csv"
    test_csv: str = "data/test_sample.csv"
    train_img_dir: str = "data/img/train"
    test_img_dir: str = "data/img/test"
    checkpoint_dir: str = "checkpoints"
    synthetic_data: bool = True  # the Herbarium images are not shipped

    # --- optimization ---
    batch_size: int = 128
    learning_rate: float = 4e-4
    num_epochs: int = 10
    optimizer: str = "adam"  # adam | sgd | adamw
    lr_schedule: str = "constant"  # constant | cosine | warmup_cosine
    warmup_steps: int = 0
    weight_decay: float = 0.0

    # --- precision ---
    compute_dtype: str = "bfloat16"  # params stay float32
    # Host batch dtype: float32 rows arrive normalized; uint8 ships raw
    # pixels and the step normalizes on the device
    # (train/step.py ingest_images).
    input_dtype: str = "float32"

    # --- kernels ---
    # bn1 + relu + maxpool(3, 2, 1) as one kernel (ops/fused_stem.py); in
    # training its forward with the window index and its index backward.
    fused_stem: bool = False
    # Predict head as one streaming kernel: per-row loss + argmax without
    # the [B, num_classes] logits (ops/fused_head_ce.py head_predict).
    fused_head_eval: bool = False
    # The vit family's attention: "full" (plain, materializes [B,H,S,S]
    # scores, ops/ring_attention.py), "flash" (the block-tiled online
    # softmax kernel and its blocked backward, ops/flash_attention.py) or
    # "fused-small" (the tiny-S kernel pair, S ≤ 128,
    # ops/fused_attention_small.py). One function, three executions.
    attn_impl: str = "full"
    # The vit family's q/k/v projections as one matmul over the
    # concatenated weights (same state names, the same math).
    qkv_fused: bool = False

    # --- input pipeline ---
    shuffle: bool = True
    seed: int = 0
    loader_workers: int = 8
    prefetch_batches: int = 2
    drop_remainder: bool = True  # fixed batch shapes; see the trainer
    # Decode the training set once into device memory (this rank's rows)
    # and have each step gather its batch by index on the device: no
    # per-step decode or host→device copy of pixels (train/trainer.py
    # build_device_cache, train/step.py make_cached_train_step).
    device_cache: bool = False
    # With device_cache: every step of an epoch from device-resident index
    # batches, with no host read of a step's metrics until the epoch ends
    # (train/step.py make_scanned_epoch).
    scan_epoch: bool = False

    # --- data parallelism (one rank per GPU, torchrun's world) ---
    # Reference per-rank BN stays local unless this is set (spmd mode).
    sync_batchnorm: bool = False
    # spmd_mode: the reference's DP semantics — each rank's local batchnorm
    # statistics (unless sync_batchnorm), gradients averaged over the ranks
    # however many valid rows each held, running statistics averaged after
    # the forward. Default (auto): batchnorm over the global batch and the
    # loss as the count-weighted global mean (train/step.py).
    spmd_mode: bool = False
    # spmd mode's levers (train/step.py make_spmd_train_step): the
    # optimizer's moments sharded over the data axis (each rank updates
    # its 1/P slice of every parameter, then one all-gather), and the
    # gradient sync as one collective per ~N-MiB bucket issued while the
    # backward runs (0 disables).
    zero_opt_state: bool = False
    grad_sync_buckets: float = 0.0
    # The auto step's levers (train/step.py make_train_step, train/state.py
    # place_model): the optimizer's moments of every replicated parameter
    # sharded over the data axis (ZeRO-1), and the parameters themselves
    # held sharded over it at rest, gathered at use (FSDP, ZeRO-3).
    zero_optimizer: bool = False
    fsdp: bool = False
    # Gradient accumulation: each rank splits its rows into this many
    # microbatches, accumulates count-weighted gradients and applies ONE
    # optimizer update (batchnorm statistics update per microbatch).
    # Streaming auto mode only.
    accum_steps: int = 1

    # --- validation: the reference validates on the TRAIN split ---
    val_on_train: bool = True

    # --- checkpoint ---
    keep_checkpoints: int = 3
    # Train: after each validation that beats the best so far, best.json
    # names that epoch's checkpoint, and retention never deletes it.
    track_best: bool = False
    # Evaluate: load the checkpoint best.json names instead of the latest.
    use_best: bool = False

    # --- recovery: abort (raise on a non-finite step) | skip (discard it) ---
    bad_step_policy: str = "abort"
    # skip: consecutive discarded steps before aborting anyway.
    max_skipped_steps: int = 10

    # --- evaluation ---
    # evaluate: one CSV row (file_name, predicted_label,
    # predicted_category_id) per test image, in manifest order; "" disables.
    predictions_file: str = ""
    # evaluate --quantize-eval: the int8-against-float parity report (top-1
    # and top-5 agreement, max logit drift) on the seeded calibration batch.
    quantize_eval: bool = False

    # --- observability ---
    log_file: str = "training.log"
    eval_log_file: str = "evaluation.log"
    metrics_file: str = "metrics.jsonl"  # structured JSONL metrics; "" disables
    log_every_steps: int = 10

    # --- online serving ---
    serve_buckets: str = "1,8,32,128,512"
    serve_max_wait_ms: float = 5.0
    serve_queue_depth: int = 1024
    serve_topk: int = 5
    # Serving numeric precision: which predict set(s) are built and warmed
    # at start-up. bf16 — the compute-dtype path; int8 — post-training int8
    # (ops/quantize.py): per-channel int8 conv/dense weights dequantized per
    # call, and under fused_head_eval the fused int8 head kernel; both —
    # build both sets and start serving bf16 (InferenceServer.set_precision
    # switches between them without building anything).
    serve_precision: str = "bf16"
    # Sample-batch size for int8 calibration (the head activation scale)
    # and the serve start-up parity stamp.
    quantize_calib: int = 64

    mesh: MeshConfig = field(default_factory=MeshConfig)

    def validate_config(self) -> None:
        if self.model_name in NOT_PORTED_MODELS:
            raise ValueError(
                f"model {self.model_name!r} is not supported by the port: "
                f"{NOT_PORTED_MODELS[self.model_name]}"
            )
        if self.model_name not in SUPPORTED_MODELS:
            raise ValueError(
                f"unsupported model {self.model_name!r}; expected one of "
                f"{SUPPORTED_MODELS}"
            )
        if self.num_classes < 2:
            raise ValueError(f"num_classes must be >= 2, got {self.num_classes}")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.learning_rate <= 0:
            raise ValueError(f"learning_rate must be > 0, got {self.learning_rate}")
        if self.optimizer not in ("adam", "sgd", "adamw"):
            raise ValueError(f"optimizer must be adam|sgd|adamw, got {self.optimizer!r}")
        if self.lr_schedule not in ("constant", "cosine", "warmup_cosine"):
            raise ValueError(
                "lr_schedule must be constant|cosine|warmup_cosine, "
                f"got {self.lr_schedule!r}"
            )
        # A knob that would be silently ignored is worse than an error.
        if self.weight_decay != 0.0 and self.optimizer != "adamw":
            raise ValueError(
                f"weight_decay={self.weight_decay} only applies to "
                f"optimizer='adamw' (got {self.optimizer!r})"
            )
        if self.warmup_steps != 0 and self.lr_schedule != "warmup_cosine":
            raise ValueError(
                f"warmup_steps={self.warmup_steps} only applies to "
                f"lr_schedule='warmup_cosine' (got {self.lr_schedule!r})"
            )
        if self.warmup_steps < 0:
            raise ValueError(f"warmup_steps must be >= 0, got {self.warmup_steps}")
        if self.track_best and not self.validate:
            raise ValueError(
                "track_best needs validation accuracy to rank checkpoints "
                "(set validate=True, or drop track_best)"
            )
        if self.bad_step_policy not in ("abort", "skip"):
            raise ValueError(
                f"bad_step_policy must be abort|skip, got {self.bad_step_policy!r} "
                "(rollback is not ported yet)"
            )
        if self.max_skipped_steps < 1:
            raise ValueError(
                f"max_skipped_steps must be >= 1, got {self.max_skipped_steps}"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32|bfloat16, got {self.compute_dtype}"
            )
        self._validate_parallel()
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
        if self.serve_precision not in ("bf16", "int8", "both"):
            raise ValueError(
                f"serve_precision must be bf16|int8|both, got "
                f"{self.serve_precision!r}"
            )
        if self.serve_precision != "bf16" and self.fused_head_eval and self.serve_topk > 1:
            raise ValueError(
                f"serve_precision={self.serve_precision!r} with "
                "--fused-head-eval serves through the fused int8 head "
                "kernel, which streams argmax only — and a precision-"
                "switchable server must keep ONE response shape across its "
                f"executable sets. Set serve_topk=1 (got {self.serve_topk}) "
                "or drop --fused-head-eval for top-k int8 serving"
            )
        if self.quantize_calib < 1:
            raise ValueError(
                f"quantize_calib must be >= 1 (the int8 calibration/parity "
                f"sample batch), got {self.quantize_calib}"
            )
        if self.serve_max_wait_ms < 0:
            raise ValueError(
                f"serve_max_wait_ms must be >= 0, got {self.serve_max_wait_ms}"
            )
        if self.serve_queue_depth < 1:
            raise ValueError(
                f"serve_queue_depth must be >= 1, got {self.serve_queue_depth}"
            )
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be full|flash|fused-small, got {self.attn_impl!r}"
            )
        from mpi_pytorch_tpu_torch.models.registry import ATTENTION_MODELS

        if (self.attn_impl != "full" or self.qkv_fused) and self.model_name not in ATTENTION_MODELS:
            what = f"attn_impl={self.attn_impl!r}" if self.attn_impl != "full" else "qkv_fused"
            raise ValueError(
                f"{what} applies only to the attention family "
                f"({', '.join(ATTENTION_MODELS)}); {self.model_name!r} has "
                "no attention"
            )
        if self.model_name in ATTENTION_MODELS and (self.width % 16 or self.height % 16):
            raise ValueError(
                f"{self.model_name} cuts 16×16 patches: image {self.width}x"
                f"{self.height} is not a multiple of 16"
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

    def _validate_parallel(self) -> None:
        """The mesh, and the JAX package's checks on the levers of both
        steps (in its words: they name the JAX steps' jit and shard_map,
        whose counterparts here are ``make_train_step`` and
        ``make_spmd_train_step``), the device cache and the scan epoch.
        (``host_cache``, which JAX also keeps exclusive of the device
        cache, is not ported yet.)"""
        self.mesh.validate()
        if self.zero_optimizer and self.spmd_mode:
            raise ValueError(
                "zero_optimizer shards Adam moments via the auto-partitioned "
                "jit step; the spmd_mode shard_map step replicates its state "
                "specs, so the two do not compose"
            )
        if self.zero_opt_state and not self.spmd_mode:
            raise ValueError(
                "zero_opt_state shards the optimizer state inside the "
                "spmd_mode shard_map step (explicit slice-update + params "
                "allgather); for the auto-partitioned jit step use "
                "zero_optimizer instead"
            )
        if self.grad_sync_buckets < 0:
            raise ValueError(
                f"grad_sync_buckets is a bucket size in MiB (0 disables), "
                f"got {self.grad_sync_buckets}"
            )
        if self.grad_sync_buckets > 0 and not self.spmd_mode:
            raise ValueError(
                "grad_sync_buckets stages explicit per-bucket collectives "
                "inside the spmd_mode shard_map step; the auto-partitioned "
                "jit step has no explicit gradient collective to bucket "
                "(XLA inserts and schedules its own)"
            )
        if self.fsdp and self.spmd_mode:
            raise ValueError(
                "fsdp shards params via the auto-partitioned jit step; the "
                "spmd_mode shard_map step replicates its state specs, so the "
                "two do not compose"
            )
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {self.accum_steps}")
        if self.accum_steps > 1 and (self.spmd_mode or self.device_cache):
            raise ValueError(
                "accum_steps > 1 is implemented for the streaming auto-"
                "partitioned step only (not spmd_mode / device_cache)"
            )
        if self.accum_steps > 1 and self.batch_size % self.accum_steps != 0:
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by "
                f"accum_steps {self.accum_steps}"
            )
        if self.spmd_mode and self.mesh.model_parallel > 1:
            raise ValueError(
                "spmd_mode is pure data-parallel (reference-parity shard_map step); "
                "its replicated in/out specs would silently gather the TP-sharded "
                "head. Use the default auto mode for mesh.model_parallel > 1."
            )
        if self.mesh.pods > 1 and not self.spmd_mode:
            raise ValueError(
                "mesh pods > 1 (hierarchical ICI/DCN gradient sync) "
                "requires spmd_mode: the two-phase collectives are "
                "explicit shard_map collectives (train/step.py)"
            )
        if self.fused_stem and self.spmd_mode and self.sync_batchnorm:
            raise ValueError("fused_stem does not support sync-BN in spmd_mode "
                             "(sync_batchnorm), as the JAX resnet refuses it")
        if self.device_cache and self.spmd_mode:
            raise ValueError(
                "device_cache uses the auto-partitioned gather step; it does "
                "not compose with the reference-parity spmd_mode shard_map step"
            )
        if self.scan_epoch and not self.device_cache:
            raise ValueError(
                "scan_epoch runs the epoch as one compiled scan over the "
                "device-resident dataset; it requires device_cache=True"
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

    def parsed_serve_precisions(self) -> tuple[str, ...]:
        """``serve_precision`` as the tuple of predict sets to build at
        start-up (``validate_config`` rejects anything else first)."""
        return {
            "bf16": ("bf16",), "int8": ("int8",),
            "both": ("bf16", "int8"),
        }[self.serve_precision]


def _add_dataclass_args(parser: argparse.ArgumentParser, cls: type, prefix: str = "") -> None:
    for f in dataclasses.fields(cls):
        name = f"--{prefix}{f.name.replace('_', '-')}"
        if dataclasses.is_dataclass(f.default_factory):
            # A nested dataclass: --mesh.data-parallel and the like.
            _add_dataclass_args(parser, f.default_factory, prefix=f"{f.name}.")
            continue
        if f.type in (bool, "bool"):
            parser.add_argument(name, type=_str2bool, default=None, metavar="BOOL")
        elif f.type in (int, "int"):
            parser.add_argument(name, type=int, default=None)
        elif f.type in (float, "float"):
            parser.add_argument(name, type=float, default=None)
        elif f.type in (str, "str"):
            parser.add_argument(name, type=str, default=None)


def _str2bool(v: str) -> bool:
    if v.lower() in ("1", "true", "yes", "on"):
        return True
    if v.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected boolean, got {v!r}")


def parse_config(argv: Sequence[str] | None = None, **overrides: Any) -> Config:
    """A Config from defaults < env (``MPT_<FIELD>``) < CLI flags < explicit
    overrides, as the JAX package's ``parse_config``. Flags parse STRICTLY:
    an unknown flag is an error, not silently dropped. ``--image-size N``
    (and ``MPT_IMAGE_SIZE``) sets width and height; the per-dimension form
    wins for its dimension. The mesh fields parse as the JAX package's
    (``--mesh.data-parallel``, ...; ``--mesh-pods N`` is ``--mesh.pods``)."""
    cfg = Config()
    casters = {bool: _str2bool, "bool": _str2bool, int: int, "int": int,
               float: float, "float": float, str: str, "str": str}
    for f in dataclasses.fields(Config):
        env_key = f"MPT_{f.name.upper()}"
        if env_key in os.environ and f.type in casters:
            setattr(cfg, f.name, casters[f.type](os.environ[env_key]))
    if "MPT_IMAGE_SIZE" in os.environ:
        size = int(os.environ["MPT_IMAGE_SIZE"])
        if "MPT_WIDTH" not in os.environ:
            cfg.width = size
        if "MPT_HEIGHT" not in os.environ:
            cfg.height = size

    parser = argparse.ArgumentParser(description="mpi_pytorch_tpu_torch")
    _add_dataclass_args(parser, Config)
    parser.add_argument("--image-size", type=int, default=None, dest="image_size_alias")
    # The nested-mesh pod count's spelling (equivalent to --mesh.pods).
    parser.add_argument("--mesh-pods", type=int, default=None, dest="mesh_pods_alias")
    ns = vars(parser.parse_args(argv))
    alias = ns.pop("image_size_alias", None)
    if alias is not None:
        cfg.width = cfg.height = alias
    pods_alias = ns.pop("mesh_pods_alias", None)
    if pods_alias is not None:
        cfg.mesh.pods = pods_alias
    for key, val in [*((k, v) for k, v in ns.items() if v is not None), *overrides.items()]:
        if "." in key:
            scope, leaf = key.split(".", 1)
            setattr(getattr(cfg, scope), leaf, val)
        else:
            setattr(cfg, key, val)
    cfg.validate_config()
    return cfg
