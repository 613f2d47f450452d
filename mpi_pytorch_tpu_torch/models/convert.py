"""Weights across the two packages: the JAX package's flax variable tree
(``{"params": ..., "batch_stats": ...}`` as numpy arrays) ↔ this port's
``state_dict``, for resnet18/34 and the vits.

resnet18/34:

- conv kernels: flax HWIO ↔ torch OIHW;
- batchnorm: ``scale/bias`` + ``mean/var`` ↔ ``weight/bias`` +
  ``running_mean/running_var`` (+ torch's ``num_batches_tracked``);
- the dense head: flax ``head/kernel`` [in, out] ↔ ``fc.weight`` [out, in].

Flax names: ``conv1``, ``bn1``, ``layer{s}_{b}/{conv1,bn1,conv2,bn2,
downsample_conv,downsample_bn}``, ``head``; torch names: ``conv1``,
``bn1``, ``layer{s}.{b}.{conv1,...}``, ``layer{s}.{b}.downsample.{0,1}``,
``fc``.

vit_s16/vit_b16 (any depth and width: the depth is read off the tree, the
head count is the architecture's or ``num_heads``), with an empty
``batch_stats``:

- ``patch_embed``: HWIO ↔ OIHW, with its bias; ``pos_embed`` as it is;
- ``block{i}/attn/{q,k,v}``: DenseGeneral kernel [hidden, H, Dh] and bias
  [H, Dh] ↔ ``blocks.{i}.attn.{q,k,v}`` weight [H·Dh, hidden], bias [H·Dh];
- ``block{i}/attn/out``: kernel [H, Dh, hidden] ↔ weight [hidden, H·Dh];
- ``block{i}/{ln1,ln2}`` and ``ln``: ``scale/bias`` ↔ ``weight/bias``;
- ``block{i}/{mlp1,mlp2}`` and ``head`` (↔ ``fc``): Dense [in, out] ↔
  [out, in].

A resnet quantized by the JAX package (``ops/quantize.py``
``quantize_state``: params ``{"q", "scale", "act_scale"}``) carries over to
the port's quantized model (``ops.quantize.quantize_model``) through
:func:`from_flax_quantized`: int8 kernels transposed as above into ``q``,
per-output-channel scales as they are.

Across layouts of the auto step's levers (``train/state.place_model``): a
full state_dict → one rank's blocks on a (data, model) mesh and a lever
set (:func:`shard_state_dict`, by ``parallel.mesh.param_specs``), and
every rank's back → the full one (:func:`unshard_state_dict`).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
_VIT_HEADS = {"vit_s16": 6, "vit_b16": 12}


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


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _vit_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    sd = {
        "patch_embed.weight": _t(np.transpose(np.asarray(params["patch_embed"]["kernel"]), (3, 2, 0, 1))),
        "patch_embed.bias": _t(params["patch_embed"]["bias"]),
        "pos_embed": _t(params["pos_embed"]),
    }

    def dense(prefix: str, p, flat_in: int) -> None:
        kernel = np.asarray(p["kernel"])
        sd[f"{prefix}.weight"] = _t(kernel.reshape(flat_in, -1).T)
        sd[f"{prefix}.bias"] = _t(np.asarray(p["bias"]).reshape(-1))

    def norm(prefix: str, p) -> None:
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = _t(p["scale"]), _t(p["bias"])

    depth = sum(1 for key in params if key.startswith("block"))
    for i in range(depth):
        f, t = params[f"block{i}"], f"blocks.{i}"
        norm(f"{t}.ln1", f["ln1"])
        norm(f"{t}.ln2", f["ln2"])
        hidden = np.asarray(f["attn"]["q"]["kernel"]).shape[0]
        for name in ("q", "k", "v"):
            dense(f"{t}.attn.{name}", f["attn"][name], hidden)
        out = np.asarray(f["attn"]["out"]["kernel"])
        dense(f"{t}.attn.out", f["attn"]["out"], out.shape[0] * out.shape[1])
        dense(f"{t}.mlp1", f["mlp1"], hidden)
        dense(f"{t}.mlp2", f["mlp2"], np.asarray(f["mlp2"]["kernel"]).shape[0])
    norm("ln", params["ln"])
    dense("fc", params["head"], np.asarray(params["head"]["kernel"]).shape[0])
    return sd


def _vit_to_flax(state_dict: Mapping[str, torch.Tensor], num_heads: int) -> dict[str, Any]:
    def n(key: str) -> np.ndarray:
        return state_dict[key].detach().float().cpu().numpy()

    def dense(prefix: str) -> dict[str, np.ndarray]:
        return {"kernel": np.ascontiguousarray(n(f"{prefix}.weight").T), "bias": n(f"{prefix}.bias")}

    def norm(prefix: str) -> dict[str, np.ndarray]:
        return {"scale": n(f"{prefix}.weight"), "bias": n(f"{prefix}.bias")}

    params: dict[str, Any] = {
        "patch_embed": {
            "kernel": np.transpose(n("patch_embed.weight"), (2, 3, 1, 0)),
            "bias": n("patch_embed.bias"),
        },
        "pos_embed": n("pos_embed"),
    }
    depth = len({key.split(".")[1] for key in state_dict if key.startswith("blocks.")})
    for i in range(depth):
        t = f"blocks.{i}"
        attn = {}
        for name in ("q", "k", "v"):
            p = dense(f"{t}.attn.{name}")
            hidden = p["kernel"].shape[0]
            attn[name] = {
                "kernel": p["kernel"].reshape(hidden, num_heads, -1),
                "bias": p["bias"].reshape(num_heads, -1),
            }
        p = dense(f"{t}.attn.out")
        attn["out"] = {"kernel": p["kernel"].reshape(num_heads, -1, p["kernel"].shape[1]),
                       "bias": p["bias"]}
        params[f"block{i}"] = {
            "ln1": norm(f"{t}.ln1"), "attn": attn, "ln2": norm(f"{t}.ln2"),
            "mlp1": dense(f"{t}.mlp1"), "mlp2": dense(f"{t}.mlp2"),
        }
    params["ln"] = norm("ln")
    params["head"] = dense("fc")
    return {"params": params, "batch_stats": {}}


def from_flax_variables(variables: Mapping[str, Any], arch: str) -> dict[str, torch.Tensor]:
    """The JAX ``{"params", "batch_stats"}`` tree → this port's state_dict
    (f32 CPU tensors)."""
    if arch in _VIT_HEADS:
        return _vit_from_flax(variables["params"])
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    for fpath, tprefix, kind in _module_pairs(arch):
        p = _get(params, fpath)
        if kind == "conv":
            sd[f"{tprefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
        elif kind == "bn":
            s = _get(stats, fpath)
            sd[f"{tprefix}.weight"] = _t(p["scale"])
            sd[f"{tprefix}.bias"] = _t(p["bias"])
            sd[f"{tprefix}.running_mean"] = _t(s["mean"])
            sd[f"{tprefix}.running_var"] = _t(s["var"])
            sd[f"{tprefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        else:
            sd[f"{tprefix}.weight"] = _t(np.asarray(p["kernel"]).T)
            sd[f"{tprefix}.bias"] = _t(p["bias"])
    return sd


def to_flax_variables(
    state_dict: Mapping[str, torch.Tensor], arch: str, num_heads: int | None = None
) -> dict[str, Any]:
    """This port's state_dict → the JAX ``{"params", "batch_stats"}`` tree
    of numpy f32 arrays (the inverse of :func:`from_flax_variables`). A vit
    splits its projections over ``num_heads`` heads (default: the
    architecture's)."""
    if arch in _VIT_HEADS:
        return _vit_to_flax(state_dict, num_heads or _VIT_HEADS[arch])
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


def from_flax_quantized(
    packed: Mapping[str, Any], batch_stats: Mapping[str, Any], arch: str, *,
    keep_head_int8: bool = False,
) -> dict[str, torch.Tensor]:
    """A JAX int8 packed params tree ``{"q", "scale", "act_scale"}`` and its
    ``batch_stats`` → the state_dict of this port's quantized model
    (``quantize_model(..., keep_head_int8=keep_head_int8)``): int8 ``q``
    (HWIO → OIHW, [in, out] → [out, in]), f32 ``scale`` per output channel,
    batchnorm as for the float model, and the head's ``act_scale`` when it
    is kept int8."""
    if arch in _VIT_HEADS:
        raise NotImplementedError(f"int8 weights of {arch} do not carry over: the port does not quantize vits")
    qtree, scales = packed["q"], packed["scale"]

    def int8(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x).astype(np.int8))

    sd: dict[str, torch.Tensor] = {}
    for fpath, tprefix, kind in _module_pairs(arch):
        p = _get(qtree, fpath)
        if kind == "conv":
            sd[f"{tprefix}.q"] = int8(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
            sd[f"{tprefix}.scale"] = _t(scales[f"{fpath}/kernel"])
        elif kind == "bn":
            s = _get(batch_stats, fpath)
            sd[f"{tprefix}.weight"] = _t(p["scale"])
            sd[f"{tprefix}.bias"] = _t(p["bias"])
            sd[f"{tprefix}.running_mean"] = _t(s["mean"])
            sd[f"{tprefix}.running_var"] = _t(s["var"])
            sd[f"{tprefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        else:
            sd[f"{tprefix}.q"] = int8(np.asarray(p["kernel"]).T)
            sd[f"{tprefix}.scale"] = _t(scales[f"{fpath}/kernel"])
            sd[f"{tprefix}.bias"] = _t(p["bias"])
            if keep_head_int8:
                sd[f"{tprefix}.act_scale"] = _t(packed["act_scale"])
    return sd


def block_of(t: torch.Tensor, n: int, index: int, dim: int) -> torch.Tensor:
    """Block ``index`` of ``n`` equal blocks of ``t`` along ``dim`` (a
    view)."""
    k = t.shape[dim] // n
    return t.narrow(dim, index * k, k)


def shard_state_dict(state_dict: Mapping[str, torch.Tensor], specs: Mapping[str, Any],
                     coords: Mapping[str, tuple[int, int]]) -> dict[str, torch.Tensor]:
    """One rank's tensors of a full ``state_dict`` under ``specs``
    (``parallel.mesh.param_specs``: a ``ShardSpec`` per parameter):
    ``coords`` maps each axis name (``"data"``, ``"model"``) to ``(size,
    this rank's index)``. A split parameter becomes its block (a copy),
    everything else stays whole; the keys are the full ones."""
    out = {}
    for key, t in state_dict.items():
        spec = specs.get(key)
        if spec is not None and spec.sharded:
            size, index = coords[spec.axis]
            t = block_of(t, size, index, spec.dim).clone()
        out[key] = t
    return out


def unshard_state_dict(ranks: Mapping[tuple[int, int], Mapping[str, torch.Tensor]],
                       specs: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The inverse of :func:`shard_state_dict`: ``ranks`` maps each rank's
    ``(data index, model index)`` to its tensors; a split parameter is its
    blocks joined in axis order (from the ranks at index 0 of the other
    axis), the rest rank (0, 0)'s."""
    first = ranks[(0, 0)]
    out = {}
    for key, t in first.items():
        spec = specs.get(key)
        if spec is not None and spec.sharded:
            along = sorted(c for c in ranks if (c[1] if spec.axis == "data" else c[0]) == 0)
            t = torch.cat([ranks[c][key] for c in along], dim=spec.dim)
        out[key] = t
    return out
