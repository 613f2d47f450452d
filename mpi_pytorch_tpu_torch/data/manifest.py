"""Manifest (CSV) loading and deterministic sharding
(``mpi_pytorch_tpu/data/manifest.py``).

The same semantics as the JAX package's, read with the ``csv`` module and
numpy instead of pandas:

- DEBUG sampling (``main.py:77-79`` of the reference): ``debug_sample_size``
  rows of the *test* CSV drawn as ``DataFrame.sample(n, random_state=seed)``
  draws them (``RandomState(seed).choice(len, n, replace=False)``), then an
  80/20 positional train/test split;
- labels: the raw ``category_id`` when the head is wide enough
  (``num_classes >= max id + 1``, as the reference feeds raw ids into its
  loss), otherwise a contiguous remap of the ids that occur.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Sequence

import numpy as np

from mpi_pytorch_tpu_torch.config import Config


@dataclasses.dataclass(frozen=True)
class Manifest:
    """An image-classification manifest: filenames + integer labels."""

    filenames: tuple[str, ...]
    labels: np.ndarray  # int32 [N] — the class ids the loss sees
    category_ids: np.ndarray  # int64 [N] — the raw category_id column
    img_dir: str

    def __len__(self) -> int:
        return len(self.filenames)

    def shard(self, num_shards: int, shard_index: int) -> "Manifest":
        """Contiguous shard ``shard_index`` of ``num_shards``, with
        ``np.array_split`` sizes (the first shards get the remainder)."""
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} out of range for {num_shards} shards")
        return self.select(np.array_split(np.arange(len(self.filenames)), num_shards)[shard_index])

    def select(self, idx: Sequence[int] | np.ndarray) -> "Manifest":
        idx = np.asarray(idx, dtype=np.int64)
        return Manifest(
            filenames=tuple(self.filenames[i] for i in idx),
            labels=self.labels[idx],
            category_ids=self.category_ids[idx],
            img_dir=self.img_dir,
        )


def _read_csv(path: str) -> tuple[list[str], np.ndarray]:
    """(file_name column, category_id column as int64) of a manifest CSV."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return [r["file_name"] for r in rows], np.asarray(
        [int(r["category_id"]) for r in rows], dtype=np.int64
    )


def build_label_map(*category_ids: np.ndarray) -> dict[int, int]:
    """Raw category_id → contiguous [0, n) label, in sorted id order."""
    cats = np.unique(np.concatenate(category_ids))
    return {int(c): i for i, c in enumerate(cats)}


def _to_manifest(names: list[str], cats: np.ndarray, img_dir: str, label_map) -> Manifest:
    return Manifest(
        filenames=tuple(names),
        labels=np.asarray([label_map[int(c)] for c in cats], dtype=np.int32),
        category_ids=cats,
        img_dir=img_dir,
    )


def load_manifests(cfg: Config) -> tuple[Manifest, Manifest]:
    """(train, test) manifests with the reference's DEBUG semantics: with
    ``debug``, a seeded sample of the test CSV split 80/20; without, the
    full train and test CSVs."""
    if cfg.debug:
        names, cats = _read_csv(cfg.test_csv)
        n = min(cfg.debug_sample_size, len(names))
        pick = np.random.RandomState(cfg.seed).choice(len(names), size=n, replace=False)
        names, cats = [names[i] for i in pick], cats[pick]
        n_train = int(n * 0.8)
        train = (names[:n_train], cats[:n_train], cfg.test_img_dir)
        test = (names[n_train:], cats[n_train:], cfg.test_img_dir)
    else:
        train = (*_read_csv(cfg.train_csv), cfg.train_img_dir)
        test = (*_read_csv(cfg.test_csv), cfg.test_img_dir)

    all_cats = (train[1], test[1])
    if cfg.num_classes >= int(max(c.max(initial=0) for c in all_cats)) + 1:
        label_map = {c: c for c in build_label_map(*all_cats)}
    else:
        label_map = build_label_map(*all_cats)
        if len(label_map) > cfg.num_classes:
            raise ValueError(
                f"{len(label_map)} distinct classes in manifests exceed "
                f"num_classes={cfg.num_classes}"
            )
    return _to_manifest(*train, label_map), _to_manifest(*test, label_map)
