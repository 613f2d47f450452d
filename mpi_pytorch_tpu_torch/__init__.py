"""PyTorch + CUDA port of ``mpi_pytorch_tpu``, for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here keeps
its counterpart's name, and the tests in ``tests/test_torch_*.py`` hold
each one against it on the CPU. This package imports torch and numpy only,
never jax or the JAX package.

What is ported so far, for resnet18/34 on one device:

- serving: ``serve.InferenceServer.submit`` → preprocess →
  ``DynamicBatcher`` → per-bucket predict step
  (``evaluate.make_predict_step``) → top-1 class, in bf16, f32 or
  post-training int8 (``ops/quantize.py``);
- training: ``python -m mpi_pytorch_tpu_torch.train`` → ``train.train``:
  manifests → ``DataLoader`` → train step (forward, masked CE, backward,
  Adam/SGD/AdamW) → per-epoch checkpoint → validation.

Hand-written CUDA kernels in ``csrc/`` carry both:

- ``ops.fused_stem.stem_affine_relu_pool`` — BN affine + ReLU + 3×3/s2/p1
  max-pool in one pass over the stem conv's output; in training its
  forward also writes the window index and its backward routes the
  gradient through it (a ``torch.autograd.Function``);
- ``ops.fused_head_ce.head_predict`` — the classifier head's per-row
  cross-entropy and argmax without storing the [B, V] logits (bf16 or
  f32), and its int8 twin ``ops.quantize.head_predict_int8`` for int8
  serving (``serve_precision="int8"``);
- ``ops.fused_head_ce.fused_head_ce`` — the training cross-entropy head,
  a ``torch.autograd.Function`` whose forward and backward are kernels.

Every entry point takes ``device`` (default ``"cuda"``; ``MPT_PLATFORM=cpu``
selects the CPU). On the CPU each kernel wrapper runs its plain PyTorch
version; on a CUDA tensor it launches the kernel or raises.
"""

from mpi_pytorch_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD, Config

__all__ = ["Config", "IMAGENET_MEAN", "IMAGENET_STD"]
