"""Host-side image math of the serving path: decode → RGB → resize →
[0, 1] floats → ImageNet normalize — the same arithmetic, in the same op
order, as ``mpi_pytorch_tpu/data/pipeline.py`` (so a request normalized
here is bit-identical to one normalized by the JAX package)."""

from __future__ import annotations

import numpy as np

from mpi_pytorch_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD

_MEAN = np.asarray(IMAGENET_MEAN, dtype=np.float32)
_STD = np.asarray(IMAGENET_STD, dtype=np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """[0,1] float32 HWC → ImageNet-normalized."""
    return (img - _MEAN) / _STD


def decode_image_uint8(path: str, image_size: tuple[int, int]) -> np.ndarray:
    """PIL decode → RGB → bilinear resize to ``image_size`` (H, W), as raw
    uint8 HWC — the pre-float prefix of :func:`decode_image`."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((image_size[1], image_size[0]), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def decode_image(path: str, image_size: tuple[int, int]) -> np.ndarray:
    """PIL decode → RGB → resize → [0,1] float32 HWC."""
    return decode_image_uint8(path, image_size).astype(np.float32) / 255.0


def synthetic_image(seed: int, image_size: tuple[int, int]) -> np.ndarray:
    """Deterministic class-conditioned synthetic image in [0, 1] (a
    low-frequency pattern keyed by ``seed`` plus noise)."""
    rng = np.random.default_rng(seed)
    h, w = image_size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    freq = rng.uniform(0.02, 0.3, size=(3,))
    phase = rng.uniform(0, 2 * np.pi, size=(3,))
    img = 0.5 + 0.5 * np.sin(freq[None, None, :] * (yy + xx)[:, :, None] + phase[None, None, :])
    noise = rng.normal(0, 0.05, size=(h, w, 3)).astype(np.float32)
    return np.clip(img + noise, 0.0, 1.0).astype(np.float32)
