"""The port's process world and collectives, on the CPU.

- The collectives of ``parallel/collectives.py`` in a real two-rank gloo
  world (``parallel.launch.run_world``, 120 s) against numpy: sum, mean,
  max and min all-reduces, the autograd all-reduce ``sum_over_ranks``
  (its backward sums every rank's gradient), the coalesced in-place
  all-reduce over mixed dtypes, ``sum_grads``/``avg_grads``,
  ``all_gather``, ``broadcast_from``, ``sync_params`` and
  ``host_allgather``, exactly (the inputs are small
  integers, so every order of summation gives the same f32); and each the
  identity for one process, as the JAX ones are on one device.
- The world itself: a plain process stays one process; a rendezvous that
  no peer joins raises (no quiet fallback to one process); a world that
  hangs is killed at its timeout and fails.
- The spmd levers' collectives, in the same two-rank world and in one
  four-rank world laid out as two pods of two (``parallel/mesh.py``),
  against numpy sums: ``reduce_scatter_mean``, the slice all-gather and
  the flatten-pad layout, the hierarchical ``hier_reduce_scatter_mean``,
  ``hier_all_gather``, ``hier_psum`` and ``hier_pmean`` over leaves whose
  sizes the axes do not divide, and the bytes each books in the ledger,
  ici or dcn, by the ring cost model.
- In the same four-rank world laid out as (data 2, model 2)
  (``MeshConfig(model_parallel=2)``): every reduction over its axis — the
  data axis sums the ranks of one model index, the model axis those of
  one data index — and the auto levers' autograd pieces against numpy
  sums: ``copy_to_model``'s backward, and the FSDP gather
  ``gather_shards`` (rows, a channels-last convolution and columns) with
  its reduce-scatter backward and its ledger bytes.
- The data-parallel config fields: the names, defaults and flags of the
  JAX ``Config``'s (``--mesh.data-parallel`` …), and its refusals — every
  combination the JAX ``validate_config`` refuses, the port refuses too
  (the levers in the JAX words, ``tests/test_torch_grad_sync.py`` and
  ``tests/test_torch_accum.py``), and every knob the port does not run
  yet (axis names, pipeline stages) is refused by name.
"""

import dataclasses
import os
import socket
import time

import numpy as np
import pytest
import torch
from torch import nn

from mpi_pytorch_tpu_torch.config import Config, MeshConfig, parse_config
from mpi_pytorch_tpu_torch.parallel import collectives, distributed
from mpi_pytorch_tpu_torch.parallel.launch import run_world
from mpi_pytorch_tpu_torch.parallel.mesh import create_mesh, is_hierarchical

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
RANK_ENV = {"MPT_PLATFORM": "cpu", "OMP_NUM_THREADS": "1"}


def _x(rank: int) -> torch.Tensor:
    return torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1) - 2 * rank


def collectives_worker(_) -> dict:
    distributed.maybe_initialize_distributed(torch.device("cpu"))
    r = distributed.rank()
    x = _x(r)
    out = {op: collectives.all_reduce(x, op).numpy() for op in ("sum", "mean", "max", "min")}
    out["unchanged"] = torch.equal(x, _x(r))
    mixed = [x.clone(), torch.tensor([r + 1, 10 * r], dtype=torch.int64), x[0].clone() * 3]
    collectives.all_reduce_(mixed, "sum")
    out["coalesced"] = [t.numpy() for t in mixed]
    lin = nn.Linear(3, 2)
    lin.weight.grad = x.clone()
    lin.bias.grad = torch.full((2,), float(r + 1))
    collectives.sum_grads(lin)
    out["sum_grads"] = (lin.weight.grad.numpy().copy(), lin.bias.grad.numpy().copy())
    lin.weight.grad, lin.bias.grad = x.clone(), torch.full((2,), float(r + 1))
    collectives.avg_grads(lin)
    out["avg_grads"] = (lin.weight.grad.numpy().copy(), lin.bias.grad.numpy().copy())
    out["all_gather"] = collectives.all_gather(x).numpy()
    b = [x.clone(), torch.full((4,), r, dtype=torch.int32)]
    collectives.broadcast_from(b, root=1)
    out["broadcast"] = [t.numpy() for t in b]
    net = nn.BatchNorm1d(3)
    with torch.no_grad():
        net.weight.fill_(r + 2)
        net.running_mean.fill_(10 * r + 1)
    collectives.sync_params(net)
    out["sync_params"] = (net.weight.detach().numpy().copy(), net.running_mean.numpy().copy())
    out["host_allgather"] = collectives.host_allgather([r, 2.5 * r, -1])
    out["num_processes"] = collectives.num_processes()
    leaf = torch.tensor([1.0, 2.0]) * (r + 1)
    leaf.requires_grad_(True)
    collectives.sum_over_ranks(leaf.square()).sum().backward()
    out["sum_over_ranks_grad"] = (leaf.detach().numpy(), leaf.grad.numpy())
    out["levers"] = _lever_collectives(create_mesh(MeshConfig()))
    return out


def _leaves(rank: int) -> list[torch.Tensor]:
    """Three small-integer leaves whose sizes (3, 10, 7) no axis of 2 or 4
    divides, distinct on each rank."""
    return [torch.arange(n, dtype=torch.float32).reshape(shape) * (rank + 1) + rank
            for n, shape in ((3, (3,)), (10, (2, 5)), (7, (7,)))]


def _ledger_of(fn):
    collectives.LEDGER.reset()
    result = fn()
    return result, collectives.LEDGER.snapshot()


def _lever_collectives(mesh) -> dict:
    """The levers' collectives on this rank, each with what it booked."""
    rank = distributed.rank()
    out = {}
    if is_hierarchical(mesh):
        ici, pod = mesh.axis("ici"), mesh.axis("pod")
        for name, fn in {
            "hier_reduce_scatter_mean": lambda: collectives.hier_reduce_scatter_mean(
                _leaves(rank), ici, pod),
            "hier_psum": lambda: collectives.hier_psum(_leaves(rank), ici, pod),
            "hier_pmean": lambda: collectives.hier_pmean(_leaves(rank), ici, pod),
            "hier_all_gather": lambda: collectives.hier_all_gather(
                [t.reshape(-1)[:2] for t in _leaves(rank)], ici),
        }.items():
            result, ledger = _ledger_of(fn)
            out[name] = ([t.numpy() for t in result], ledger)
        return out
    axis = mesh.axes[0]
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3) * (rank + 1) - rank
    out["reduce_scatter_mean"] = _ledger_of(
        lambda: collectives.reduce_scatter_mean(x, axis).numpy())
    out["all_gather_slices"] = _ledger_of(lambda: [t.numpy() for t in collectives.all_gather_slices(
        [t.reshape(-1)[:2] for t in _leaves(rank)], axis)])
    out["stack_slices"] = [t.numpy() for t in
                           collectives.stack_slices(_leaves(rank), axis.size)[0].unbind(0)]
    out["reduce_scatter_chain"] = _ledger_of(lambda: [t.numpy() for t in collectives.run_chain(
        collectives.reduce_scatter_chain(_leaves(rank), axis))])
    out["mean_chain"] = _ledger_of(lambda: [t.numpy() for t in collectives.run_chain(
        collectives.mean_chain(_leaves(rank), axis))])
    lin = nn.Linear(3, 2)
    lin.weight.grad, lin.bias.grad = torch.ones(2, 3), torch.ones(2)
    out["avg_grads"] = _ledger_of(lambda: collectives.avg_grads(lin))[1]
    return out


@pytest.fixture(scope="module")
def two_ranks():
    return run_world("test_torch_collectives:collectives_worker", WORLD, None,
                     timeout_s=120, env=RANK_ENV, pythonpath=[HERE])


def test_collectives_against_numpy(two_ranks):
    ranks = two_ranks
    xs = np.stack([_x(r).numpy() for r in range(WORLD)])
    for r, out in enumerate(ranks):
        assert out["num_processes"] == WORLD and out["unchanged"]
        np.testing.assert_array_equal(out["sum"], xs.sum(0))
        np.testing.assert_array_equal(out["mean"], xs.sum(0) / WORLD)
        np.testing.assert_array_equal(out["max"], xs.max(0))
        np.testing.assert_array_equal(out["min"], xs.min(0))
        np.testing.assert_array_equal(out["coalesced"][0], xs.sum(0))
        np.testing.assert_array_equal(out["coalesced"][1], [3, 10])
        assert out["coalesced"][1].dtype == np.int64
        np.testing.assert_array_equal(out["coalesced"][2], 3 * xs[:, 0].sum(0))
        np.testing.assert_array_equal(out["sum_grads"][0], xs.sum(0))
        np.testing.assert_array_equal(out["sum_grads"][1], [3.0, 3.0])
        np.testing.assert_array_equal(out["avg_grads"][0], xs.sum(0) / WORLD)
        np.testing.assert_array_equal(out["avg_grads"][1], [1.5, 1.5])
        np.testing.assert_array_equal(out["all_gather"], xs.reshape(-1, 3))
        np.testing.assert_array_equal(out["broadcast"][0], xs[1])
        np.testing.assert_array_equal(out["broadcast"][1], [1, 1, 1, 1])
        np.testing.assert_array_equal(out["sync_params"][0], [2.0, 2.0, 2.0])
        np.testing.assert_array_equal(out["sync_params"][1], [1.0, 1.0, 1.0])
        np.testing.assert_array_equal(out["host_allgather"],
                                      [[0, 0, -1], [1, 2.5, -1]])
        # Each rank's backward adds every rank's upstream gradient: 2·x·P.
        leaf, grad = out["sum_over_ranks_grad"]
        np.testing.assert_array_equal(grad, 2 * leaf * WORLD)


def _ring(op: str, p: int, nbytes: float) -> float:
    return nbytes * (2.0 * (p - 1) / p if op == "all_reduce" else (p - 1) / p)


def _padded(n: int, p: int) -> int:
    return -(-n // p) * p


def test_reduce_scatter_and_slice_gather_on_two_ranks(two_ranks):
    """Each rank's block of the mean, the leaves' flatten-pad slices (row k
    is shard k's, zero-padded), their all-gather, and the bytes booked:
    the ring factor of each payload on the data axis (ici)."""
    xs = [torch.arange(12, dtype=torch.float32).reshape(4, 3) * (r + 1) - r for r in range(WORLD)]
    mean = (xs[0] + xs[1]).numpy() / WORLD
    leaves = [_leaves(r) for r in range(WORLD)]
    for r, out in enumerate(two_ranks):
        got = out["levers"]
        block, ledger = got["reduce_scatter_mean"]
        np.testing.assert_array_equal(block, mean[2 * r:2 * r + 2])
        assert ledger["ici"] == {"bytes": _ring("reduce_scatter", 2, 48), "ops": 1,
                                 "by_op": {"reduce_scatter": 24}} and ledger["dcn"]["bytes"] == 0
        gathered, ledger = got["all_gather_slices"]
        for i, g in enumerate(gathered):
            np.testing.assert_array_equal(
                g, np.concatenate([leaves[q][i].reshape(-1)[:2].numpy() for q in range(WORLD)]))
        assert ledger["ici"]["by_op"] == {"all_gather": _ring("all_gather", 2, 3 * 2 * 2 * 4)}
        for k, row in enumerate(got["stack_slices"]):
            want = np.concatenate([np.pad(t.reshape(-1).numpy(), (0, _padded(t.numel(), 2)
                                                                   - t.numel()))
                                   .reshape(2, -1)[k] for t in leaves[r]])
            np.testing.assert_array_equal(row, want)
        total = [sum(leaves[q][i] for q in range(WORLD)).numpy() / WORLD for i in range(3)]
        slices, ledger = got["reduce_scatter_chain"]
        for t, s in zip(total, slices):
            flat = np.pad(t.reshape(-1), (0, _padded(t.size, 2) - t.size))
            np.testing.assert_array_equal(s, flat.reshape(2, -1)[r])
        padded = sum(_padded(t.size, 2) for t in total) * 4
        assert ledger["ici"]["by_op"] == {"reduce_scatter": _ring("reduce_scatter", 2, padded)}
        means, ledger = got["mean_chain"]
        for t, m in zip(total, means):
            np.testing.assert_array_equal(m, t)
        assert ledger["ici"]["by_op"] == {"all_reduce": _ring("all_reduce", 2, 20 * 4)}
        assert got["avg_grads"]["ici"]["by_op"] == {"all_reduce": _ring("all_reduce", 2, 8 * 4)}


def hier_collectives_worker(_) -> dict:
    distributed.maybe_initialize_distributed(torch.device("cpu"))
    return {"rank": distributed.rank(),
            "levers": _lever_collectives(create_mesh(MeshConfig(pods=2))),
            "axes": _axis_collectives(create_mesh(MeshConfig(model_parallel=2)))}


def _weights() -> dict[str, torch.Tensor]:
    """Whole small-integer tensors the FSDP gather splits: along dim 0, a
    channels-last 4-D one along dim 0, and along dim 1."""
    return {
        "rows": torch.arange(12, dtype=torch.float32).reshape(4, 3),
        "conv": (torch.arange(72, dtype=torch.float32).reshape(4, 2, 3, 3) - 30).contiguous(
            memory_format=torch.channels_last),
        "cols": torch.arange(12, dtype=torch.float32).reshape(3, 4) * 2 - 5,
    }


WEIGHT_DIMS = {"rows": 0, "conv": 0, "cols": 1}


def _coeff(name: str, rank: int) -> torch.Tensor:
    """Rank ``rank``'s upstream gradient for the gathered ``name``."""
    w = _weights()[name]
    return torch.arange(w.numel(), dtype=torch.float32).reshape(w.shape) % 5 + rank


def _axis_collectives(mesh) -> dict:
    """The axis-aware reductions and the auto levers' autograd pair on the
    (data, model) layout: rank ``d·2 + m``."""
    rank = distributed.rank()
    data, model = mesh.axes[0], mesh.model
    x = _x(rank)
    out = {"coords": (data.index, model.index),
           "data_sum": collectives.all_reduce(x, "sum", data).numpy(),
           "model_sum": collectives.all_reduce(x, "sum", model).numpy(),
           "model_max": collectives.all_reduce(x, "max", model).numpy(),
           "data_gather": collectives.all_gather(x, data).numpy(),
           "model_gather": collectives.all_gather(x, model).numpy()}
    leaf = (torch.tensor([1.0, 2.0]) * (rank + 1)).requires_grad_(True)
    collectives.sum_over_ranks(leaf.square(), data).sum().backward()
    out["sum_over_data_grad"] = (leaf.detach().numpy(), leaf.grad.numpy())
    mixed = [x.clone(), torch.tensor([rank + 1], dtype=torch.int64)]
    collectives.all_reduce_(mixed, "sum", axis=model)
    out["coalesced_model"] = [t.numpy() for t in mixed]
    lin = nn.Linear(3, 2)
    lin.weight.grad, lin.bias.grad = x.clone(), torch.full((2,), float(rank + 1))
    collectives.sum_grads(lin, data)
    out["sum_grads_data"] = lin.weight.grad.numpy().copy()
    lin.weight.grad, lin.bias.grad = x.clone(), torch.full((2,), float(rank + 1))
    collectives.avg_grads(lin, model)
    out["avg_grads_model"] = lin.bias.grad.numpy().copy()
    b = [x.clone()]
    collectives.broadcast_from(b, root=1, axis=data)
    out["broadcast_data"] = b[0].numpy()
    feats = torch.ones(2, 3, requires_grad=True)
    (collectives.copy_to_model(feats, model) * (model.index + 1)).sum().backward()
    out["copy_to_model_grad"] = feats.grad.numpy()
    out["gather"] = {}
    for name, whole in _weights().items():
        dim = WEIGHT_DIMS[name]
        k = whole.shape[dim] // data.size
        shard = whole.narrow(dim, data.index * k, k).clone().requires_grad_(True)
        collectives.LEDGER.reset()
        gathered = collectives.gather_shards(shard, data, dim)
        (gathered * _coeff(name, rank)).sum().backward()
        out["gather"][name] = {
            "whole": gathered.detach().numpy(), "grad": shard.grad.numpy(),
            "channels_last": gathered.is_contiguous(memory_format=torch.channels_last),
            "ledger": collectives.LEDGER.snapshot()["ici"]["by_op"]}
    return out


@pytest.fixture(scope="module")
def four_ranks():
    return run_world("test_torch_collectives:hier_collectives_worker", 4, None,
                     timeout_s=120, env=RANK_ENV, pythonpath=[HERE])


def test_hierarchical_collectives_on_two_pods_of_two(four_ranks):
    """Rank p·2 + i: ``hier_psum``/``hier_pmean`` give every rank each
    leaf's sum/mean over all four in its shape; ``hier_reduce_scatter_mean``
    gives slice i of the mean (flatten-pad over the 2 ici ranks), the same
    on both pods; ``hier_all_gather`` gathers within the pod only."""
    leaves = [_leaves(r) for r in range(4)]
    total = [sum(leaves[q][i] for q in range(4)).numpy() for i in range(3)]
    for out in four_ranks:
        p, i = divmod(out["rank"], 2)
        got = out["levers"]
        for t, s in zip(total, got["hier_psum"][0]):
            np.testing.assert_array_equal(s, t)
        for t, s in zip(total, got["hier_pmean"][0]):
            np.testing.assert_array_equal(s, t / 4)
        for t, s in zip(total, got["hier_reduce_scatter_mean"][0]):
            flat = np.pad(t.reshape(-1), (0, _padded(t.size, 2) - t.size)) / 4
            np.testing.assert_array_equal(s, flat.reshape(2, -1)[i])
        for k, g in enumerate(got["hier_all_gather"][0]):
            np.testing.assert_array_equal(g, np.concatenate(
                [leaves[2 * p + q][k].reshape(-1)[:2].numpy() for q in range(2)]))


def test_hierarchical_collectives_book_ici_and_dcn(four_ranks):
    """Phase 1 (ici reduce-scatter of the padded leaves) and phase 3 (ici
    all-gather) book ici bytes, phase 2 (the pod all-reduce of the 1/ici
    slice) dcn bytes, each by the ring factor of its axis of 2."""
    padded = sum(_padded(n, 2) for n in (3, 10, 7)) * 4
    rs = {"reduce_scatter": _ring("reduce_scatter", 2, padded)}
    dcn = {"all_reduce": _ring("all_reduce", 2, padded / 2)}
    for out in four_ranks:
        got = out["levers"]
        for name in ("hier_psum", "hier_pmean"):
            ledger = got[name][1]
            assert ledger["ici"]["by_op"] == {**rs, "all_gather": _ring("all_gather", 2, padded)}
            assert ledger["dcn"]["by_op"] == dcn
        ledger = got["hier_reduce_scatter_mean"][1]
        assert ledger["ici"]["by_op"] == rs and ledger["dcn"]["by_op"] == dcn
        ledger = got["hier_all_gather"][1]
        assert ledger["ici"]["by_op"] == {"all_gather": _ring("all_gather", 2, 3 * 2 * 2 * 4)}
        assert ledger["dcn"]["bytes"] == 0


def test_axis_aware_reductions_on_a_two_by_two_layout(four_ranks):
    """Rank d·2 + m of ``MeshConfig(model_parallel=2)``: a reduction over
    the data axis sums the ranks of one model index, one over the model
    axis those of one data index — never the world; the autograd sum's
    backward sums over its axis only; the broadcast takes the data axis's
    rank 1."""
    xs = {r: _x(r).numpy() for r in range(4)}
    for out in four_ranks:
        r = out["rank"]
        d, m = divmod(r, 2)
        got = out["axes"]
        assert got["coords"] == (d, m)
        np.testing.assert_array_equal(got["data_sum"], xs[m] + xs[2 + m])
        np.testing.assert_array_equal(got["model_sum"], xs[2 * d] + xs[2 * d + 1])
        np.testing.assert_array_equal(got["model_max"], np.maximum(xs[2 * d], xs[2 * d + 1]))
        np.testing.assert_array_equal(got["data_gather"], np.concatenate([xs[m], xs[2 + m]]))
        np.testing.assert_array_equal(got["model_gather"],
                                      np.concatenate([xs[2 * d], xs[2 * d + 1]]))
        leaf, grad = got["sum_over_data_grad"]
        np.testing.assert_array_equal(grad, 2 * leaf * 2)
        np.testing.assert_array_equal(got["coalesced_model"][0], xs[2 * d] + xs[2 * d + 1])
        np.testing.assert_array_equal(got["coalesced_model"][1], [4 * d + 3])
        np.testing.assert_array_equal(got["sum_grads_data"], xs[m] + xs[2 + m])
        np.testing.assert_array_equal(got["avg_grads_model"], [2 * d + 1.5] * 2)
        np.testing.assert_array_equal(got["broadcast_data"], xs[2 + m])
        np.testing.assert_array_equal(got["copy_to_model_grad"], np.full((2, 3), 3.0))


@pytest.mark.parametrize("name", list(WEIGHT_DIMS))
def test_fsdp_gather_and_its_reduce_scatter(four_ranks, name):
    """``gather_shards`` over the data axis: every rank holds the whole
    tensor (a channels-last block gathers channels-last); the backward
    gives each rank its block of the sum of the data axis's upstream
    gradients (the model axis's other rank is not in it); the ledger books
    one all-gather and one reduce-scatter of the whole tensor over 2."""
    whole = _weights()[name]
    dim = WEIGHT_DIMS[name]
    for out in four_ranks:
        d, m = divmod(out["rank"], 2)
        got = out["axes"]["gather"][name]
        np.testing.assert_array_equal(got["whole"], whole.numpy())
        assert got["channels_last"] == (name == "conv")
        total = (_coeff(name, m) + _coeff(name, 2 + m)).numpy()
        k = whole.shape[dim] // 2
        np.testing.assert_array_equal(got["grad"], np.take(total, range(d * k, (d + 1) * k),
                                                           axis=dim))
        nbytes = whole.numel() * 4
        assert got["ledger"] == {"all_gather": _ring("all_gather", 2, nbytes),
                                 "reduce_scatter": _ring("reduce_scatter", 2, nbytes)}


def test_one_process_is_the_identity(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert not distributed.maybe_initialize_distributed(torch.device("cpu"))
    assert (distributed.world_size(), distributed.rank(), distributed.backend()) == (1, 0, None)
    x = _x(1)
    assert collectives.all_reduce(x, "mean") is x and collectives.all_gather(x) is x
    lin = nn.Linear(3, 2)
    lin.weight.grad = x.clone()
    collectives.avg_grads(lin)
    collectives.sum_grads(lin)
    collectives.sync_params(lin)
    assert torch.equal(lin.weight.grad, x)
    np.testing.assert_array_equal(collectives.host_allgather([1, 2]), [[1, 2]])
    distributed.barrier()
    monkeypatch.setenv("WORLD_SIZE", "1")  # WORLD_SIZE alone asks for no rendezvous
    assert not distributed.requested()
    monkeypatch.setenv("MPT_PLATFORM", "cpu")
    assert distributed.rank_device().type == "cpu"


def test_a_rendezvous_nobody_joins_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with socket.socket() as sock:  # a port nothing listens on
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setattr(distributed, "TIMEOUT_S", 2.0)
    with pytest.raises(Exception):
        distributed.maybe_initialize_distributed(torch.device("cpu"))
    assert not distributed.is_initialized()
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="MASTER_ADDR/MASTER_PORT"):
        distributed.maybe_initialize_distributed(torch.device("cpu"))
    # A rank asks for its card (cuda:LOCAL_RANK) and there is none here.
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.delenv("MPT_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        distributed.rank_device()


def hang_worker(pid_dir):
    import time

    with open(os.path.join(pid_dir, os.environ["RANK"]), "w") as f:
        f.write(str(os.getpid()))
    time.sleep(120)


def _running(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_a_hung_world_is_killed_at_its_timeout(tmp_path):
    """Both ranks start and hang; at its timeout the world fails and no
    rank is left running."""
    with pytest.raises(RuntimeError, match="outlived 15"):
        run_world("test_torch_collectives:hang_worker", WORLD, str(tmp_path), timeout_s=15,
                  env=RANK_ENV, pythonpath=[HERE])
    pids = [int((tmp_path / str(r)).read_text()) for r in range(WORLD)]
    deadline = time.monotonic() + 10
    while any(map(_running, pids)) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(map(_running, pids))


def _jax_config():
    from mpi_pytorch_tpu import config as jax_config

    return jax_config


@pytest.mark.parametrize("field", [
    "spmd_mode", "sync_batchnorm", "zero_optimizer", "zero_opt_state", "grad_sync_buckets",
    "fsdp",
])
def test_dp_fields_match_jax(field):
    jc = _jax_config()
    assert getattr(Config(), field) == getattr(jc.Config(), field)
    assert type(getattr(Config(), field)) is type(getattr(jc.Config(), field))


def test_mesh_fields_and_flags_match_jax(monkeypatch):
    jc = _jax_config()
    for key in list(os.environ):
        if key.startswith("MPT_"):
            monkeypatch.delenv(key)
    assert [f.name for f in dataclasses.fields(MeshConfig)] == [
        f.name for f in dataclasses.fields(jc.MeshConfig)]
    assert dataclasses.asdict(Config().mesh) == dataclasses.asdict(jc.Config().mesh)
    argv = ["--mesh.data-parallel", "2", "--spmd-mode", "true", "--sync-batchnorm", "true"]
    cfg = parse_config(argv)
    assert (cfg.mesh.data_parallel, cfg.spmd_mode, cfg.sync_batchnorm) == (2, True, True)
    assert parse_config([]).mesh == MeshConfig()  # one parse never leaks into the next
    with pytest.raises(ValueError, match="data_parallel=2 but the world has 1"):
        cfg.mesh.check_world(1)
    MeshConfig().check_world(3)


NOT_PORTED = "not ported yet (ROADMAP A7)"


def _ported(overrides: dict, port_error: str | None):
    """A case whose knob was refused as not ported when this table was
    written and is ported now: its id is kept, its expectation is JAX's
    (accepted, or refused in JAX's words)."""
    return pytest.param(overrides, port_error, id=f"{overrides}-{NOT_PORTED}")


CASES = [
    ({}, None),
    ({"spmd_mode": True}, None),
    ({"sync_batchnorm": True}, None),
    ({"spmd_mode": True, "sync_batchnorm": True}, None),
    ({"mesh.data_parallel": 2}, None),
    ({"mesh.data_parallel": 0}, "must be -1"),
    _ported({"spmd_mode": True, "zero_optimizer": True}, "zero_optimizer shards Adam moments"),
    _ported({"zero_optimizer": True}, None),
    ({"zero_opt_state": True}, "zero_opt_state shards"),
    ({"spmd_mode": True, "zero_opt_state": True}, None),
    ({"grad_sync_buckets": -1.0}, "grad_sync_buckets is a bucket size"),
    ({"grad_sync_buckets": 25.0}, "grad_sync_buckets stages"),
    ({"spmd_mode": True, "grad_sync_buckets": 25.0}, None),
    _ported({"fsdp": True}, None),
    _ported({"spmd_mode": True, "fsdp": True}, "fsdp shards params via"),
    _ported({"mesh.model_parallel": 2}, None),
    _ported({"spmd_mode": True, "mesh.model_parallel": 2}, "spmd_mode is pure data-parallel"),
    ({"mesh.pods": 2}, "requires spmd_mode"),
    ({"spmd_mode": True, "mesh.pods": 2}, None),
    ({"mesh.pipe_parallel": 2}, NOT_PORTED),
    _ported({"mesh.model_parallel": 0}, "model_parallel must be >= 1"),
    ({"mesh.model_axis": "tp"}, NOT_PORTED),
    ({"mesh.data_axis": "batch"}, NOT_PORTED),
]


def _apply(cfg, overrides: dict):
    for key, val in overrides.items():
        if key.startswith("mesh."):
            setattr(cfg.mesh, key[5:], val)
        else:
            setattr(cfg, key, val)
    return cfg


@pytest.mark.parametrize("overrides,port_error", CASES, ids=lambda v: str(v))
def test_dp_refusals_match_jax(overrides, port_error):
    """What the JAX ``validate_config`` accepts among these the port runs,
    unless it is not ported yet; what the JAX one refuses the port refuses
    too."""
    jc = _jax_config()
    try:
        _apply(jc.Config(), overrides).validate_config()
        jax_refuses = False
    except ValueError:
        jax_refuses = True
    cfg = _apply(Config(), overrides)
    if port_error is None:
        assert not jax_refuses
        cfg.validate_config()
        return
    with pytest.raises(ValueError, match=port_error.replace("(", r"\(").replace(")", r"\)")):
        cfg.validate_config()


def test_fused_stem_refuses_sync_bn_in_spmd_mode():
    """The JAX resnet raises when the fused stem meets sync-BN (a bound
    batchnorm axis, ``models/resnet.py``), which it has in spmd mode with
    ``sync_batchnorm``; the port refuses that configuration, and takes
    the fused stem in auto mode, whose batchnorm is global too."""
    import jax
    import jax.numpy as jnp

    from mpi_pytorch_tpu.models.resnet import resnet18

    with pytest.raises(ValueError, match="sync-BN"):
        resnet18(10, fused_stem=True, bn_axis_name="data").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    with pytest.raises(ValueError, match="sync-BN"):
        Config(fused_stem=True, spmd_mode=True, sync_batchnorm=True).validate_config()
    Config(fused_stem=True, spmd_mode=True).validate_config()
    Config(fused_stem=True, sync_batchnorm=True).validate_config()
