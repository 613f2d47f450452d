"""Weights across the two packages: the JAX package's flax variable tree
(``{"params": ..., "batch_stats": ...}`` as numpy arrays) ↔ this port's
``state_dict`` for resnet18/34.

- conv kernels: flax HWIO ↔ torch OIHW;
- batchnorm: ``scale/bias`` + ``mean/var`` ↔ ``weight/bias`` +
  ``running_mean/running_var`` (+ torch's ``num_batches_tracked``);
- the dense head: flax ``head/kernel`` [in, out] ↔ ``fc.weight`` [out, in].

Flax names: ``conv1``, ``bn1``, ``layer{s}_{b}/{conv1,bn1,conv2,bn2,
downsample_conv,downsample_bn}``, ``head``; torch names: ``conv1``,
``bn1``, ``layer{s}.{b}.{conv1,...}``, ``layer{s}.{b}.downsample.{0,1}``,
``fc``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


def _module_pairs(arch: str) -> list[tuple[str, str, str]]:
    """(flax path, torch prefix, kind) for every weight-carrying module."""
    if arch not in _STAGES:
        raise ValueError(f"no weight mapping for {arch!r}; expected one of {tuple(_STAGES)}")
    pairs = [("conv1", "conv1", "conv"), ("bn1", "bn1", "bn")]
    for s, n_blocks in enumerate(_STAGES[arch], start=1):
        for b in range(n_blocks):
            f, t = f"layer{s}_{b}", f"layer{s}.{b}"
            pairs += [
                (f"{f}/conv1", f"{t}.conv1", "conv"),
                (f"{f}/bn1", f"{t}.bn1", "bn"),
                (f"{f}/conv2", f"{t}.conv2", "conv"),
                (f"{f}/bn2", f"{t}.bn2", "bn"),
            ]
            if s > 1 and b == 0:
                pairs += [
                    (f"{f}/downsample_conv", f"{t}.downsample.0", "conv"),
                    (f"{f}/downsample_bn", f"{t}.downsample.1", "bn"),
                ]
    pairs.append(("head", "fc", "dense"))
    return pairs


def _get(tree: Mapping[str, Any], path: str) -> Mapping[str, Any]:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _put(tree: dict, path: str, leaves: dict) -> None:
    *parents, last = path.split("/")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[last] = leaves


def from_flax_variables(variables: Mapping[str, Any], arch: str) -> dict[str, torch.Tensor]:
    """The JAX ``{"params", "batch_stats"}`` tree → this port's state_dict
    (f32 CPU tensors)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    for fpath, tprefix, kind in _module_pairs(arch):
        p = _get(params, fpath)
        if kind == "conv":
            sd[f"{tprefix}.weight"] = t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
        elif kind == "bn":
            s = _get(stats, fpath)
            sd[f"{tprefix}.weight"] = t(p["scale"])
            sd[f"{tprefix}.bias"] = t(p["bias"])
            sd[f"{tprefix}.running_mean"] = t(s["mean"])
            sd[f"{tprefix}.running_var"] = t(s["var"])
            sd[f"{tprefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        else:
            sd[f"{tprefix}.weight"] = t(np.asarray(p["kernel"]).T)
            sd[f"{tprefix}.bias"] = t(p["bias"])
    return sd


def to_flax_variables(state_dict: Mapping[str, torch.Tensor], arch: str) -> dict[str, Any]:
    """This port's state_dict → the JAX ``{"params", "batch_stats"}`` tree
    of numpy f32 arrays (the inverse of :func:`from_flax_variables`)."""
    params: dict = {}
    stats: dict = {}

    def n(key: str) -> np.ndarray:
        return state_dict[key].detach().float().cpu().numpy()

    for fpath, tprefix, kind in _module_pairs(arch):
        if kind == "conv":
            _put(params, fpath, {"kernel": np.transpose(n(f"{tprefix}.weight"), (2, 3, 1, 0))})
        elif kind == "bn":
            _put(params, fpath, {"scale": n(f"{tprefix}.weight"), "bias": n(f"{tprefix}.bias")})
            _put(stats, fpath, {
                "mean": n(f"{tprefix}.running_mean"), "var": n(f"{tprefix}.running_var"),
            })
        else:
            _put(params, fpath, {
                "kernel": np.ascontiguousarray(n(f"{tprefix}.weight").T),
                "bias": n(f"{tprefix}.bias"),
            })
    return {"params": params, "batch_stats": stats}
