"""PyTorch + CUDA port of ``mpi_pytorch_tpu``, for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here keeps
its counterpart's name, and the tests in ``tests/test_torch_*.py`` hold
each one against it on the CPU. This package imports torch and numpy only,
never jax or the JAX package.

What is ported so far is the serving path of resnet18/34:
``serve.InferenceServer.submit`` → preprocess → ``DynamicBatcher`` →
per-bucket predict step (``evaluate.make_predict_step``) → top-1 class,
through two hand-written CUDA kernels in ``csrc/``:

- ``ops.fused_stem.stem_affine_relu_pool`` — BN affine + ReLU + 3×3/s2/p1
  max-pool in one pass over the stem conv's output;
- ``ops.fused_head_ce.head_predict`` — the classifier head's per-row
  cross-entropy and argmax without storing the [B, V] logits.

Every entry point takes ``device`` (default ``"cuda"``; ``MPT_PLATFORM=cpu``
selects the CPU). On the CPU each kernel wrapper runs its plain PyTorch
version; on a CUDA tensor it launches the kernel or raises.
"""

from mpi_pytorch_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD, Config

__all__ = ["Config", "IMAGENET_MEAN", "IMAGENET_STD"]
