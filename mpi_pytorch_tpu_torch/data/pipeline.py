"""Host-side input pipeline (``mpi_pytorch_tpu/data/pipeline.py``):
decode → RGB → resize → [0, 1] floats → ImageNet normalize, with the same
arithmetic in the same op order as the JAX package (a row made here is
bit-identical to one made there), and the training ``DataLoader``.

The loader covers what the trainer uses: synthetic or PIL-decoded images,
normalized f32 rows or raw uint8 rows (normalized on the device), a
worker thread pool, a bounded prefetch queue, ``drop_remainder`` and the
deterministic ``(seed, epoch)`` order. The host cache, packed shards, the
native decoder and decode quarantine are not ported yet.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from mpi_pytorch_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from mpi_pytorch_tpu_torch.data.manifest import Manifest

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


def synthetic_uint8(label: int, image_size: tuple[int, int]) -> np.ndarray:
    """The synthetic image of ``label`` quantized to raw uint8 pixels (the
    JAX package's ``data/packed.py:_synthetic_uint8``)."""
    return np.clip(np.rint(synthetic_image(label, image_size) * 255.0), 0, 255).astype(np.uint8)


def epoch_order(seed: int, epoch: int, n: int, shuffle: bool) -> np.ndarray:
    """The per-epoch visit order, deterministic per ``(seed, epoch)``."""
    if shuffle:
        return np.random.default_rng((seed, epoch)).permutation(n)
    return np.arange(n)


# Synthetic rows by (label, size, raw uint8), capped by bytes: a synthetic
# row is a pure function of its key, and generating one per image would
# bound the host. Shared by the loader's worker threads.
_SYNTH_CACHE: dict = {}
_SYNTH_CACHE_BUDGET = 256 * 1024 * 1024
_synth_cache_bytes = 0
_SYNTH_CACHE_LOCK = threading.Lock()


class DataLoader:
    """Shuffled, prefetching batch loader over one manifest.

    Batches are ``(images [B, H, W, 3], labels [B] int32)``: images
    ImageNet-normalized f32, or raw uint8 pixels with
    ``image_dtype="uint8"``. Each epoch visits ``epoch_order(seed, epoch)``;
    with ``drop_remainder`` the tail rows short of a batch are dropped,
    otherwise the last batch is short (the trainer pads it)."""

    def __init__(
        self,
        manifest: Manifest,
        batch_size: int,
        image_size: tuple[int, int],
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        synthetic: bool = False,
        num_workers: int = 8,
        prefetch: int = 2,
        image_dtype: str = "float32",
    ):
        if image_dtype not in ("float32", "uint8"):
            raise ValueError(f"image_dtype must be float32|uint8, got {image_dtype!r}")
        self.manifest = manifest
        self.batch_size = batch_size
        self.image_size = tuple(image_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.synthetic = synthetic
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.raw_uint8 = image_dtype == "uint8"
        self.image_dtype = np.dtype(image_dtype)

    def __len__(self) -> int:
        n = len(self.manifest)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def _load_one(self, i: int) -> np.ndarray:
        if self.synthetic:
            key = (int(self.manifest.labels[i]), self.image_size, self.raw_uint8)
            img = _SYNTH_CACHE.get(key)
            if img is None:
                global _synth_cache_bytes
                if self.raw_uint8:
                    img = synthetic_uint8(key[0], self.image_size)
                else:
                    img = normalize_image(synthetic_image(key[0], self.image_size))
                with _SYNTH_CACHE_LOCK:
                    if key not in _SYNTH_CACHE and (
                        _synth_cache_bytes + img.nbytes <= _SYNTH_CACHE_BUDGET
                    ):
                        _SYNTH_CACHE[key] = img
                        _synth_cache_bytes += img.nbytes
            return img
        path = os.path.join(self.manifest.img_dir, self.manifest.filenames[i])
        if self.raw_uint8:
            return decode_image_uint8(path, self.image_size)
        return normalize_image(decode_image(path, self.image_size))

    def epoch(
        self, epoch: int = 0, start_batch: int = 0
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """One epoch of batches, decoded on the worker pool by a producer
        thread ``prefetch`` batches ahead. ``start_batch`` skips the first
        batches of the ``(seed, epoch)`` order without decoding them.
        Closing the iterator early stops the producer."""
        order = epoch_order(self.seed, epoch, len(self.manifest), self.shuffle)
        nb = len(self)
        start_batch = max(0, min(start_batch, nb))
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            error = None
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for b in range(start_batch, nb):
                        if stop.is_set():
                            break
                        idx = order[b * self.batch_size : (b + 1) * self.batch_size]
                        images = np.stack(list(pool.map(self._load_one, idx)))
                        labels = np.asarray(self.manifest.labels[idx])
                        put((images.astype(self.image_dtype, copy=False), labels))
            except BaseException as e:  # surfaced to the consumer
                error = e
            finally:
                put(error)

        threading.Thread(target=producer, daemon=True).start()

        def gen() -> Iterator[tuple[np.ndarray, np.ndarray]]:
            try:
                while True:
                    item = q.get()
                    if item is None:
                        return
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                stop.set()

        return gen()
