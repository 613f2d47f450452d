"""The train and eval steps of ``mpi_pytorch_tpu/train/step.py``:
device-side image ingest, the train step (forward in train mode, masked
CE, backward, gradient sync, global grad norm, optimizer update, optional
skip of a non-finite step) and the eval step (f32 logits → masked
metrics).

PyTorch runs eagerly, so there is no jit; a step is a plain function over
the mutable :class:`~mpi_pytorch_tpu_torch.train.state.TrainState`. Images
arrive NHWC (the loader's layout); the permute to NCHW is a view in
channels_last memory.

Data parallelism (one rank per GPU, ``parallel/distributed.py``), in the
JAX package's two modes; each rank passes its own rows of the global
batch:

- **auto** (default, JAX ``make_train_step`` on a (data, model) mesh):
  batchnorm over the global batch (``models.common.set_batchnorm_sync``,
  over the data axis), the global valid count all-reduced over the data
  axis before the backward, each rank's loss its masked CE sum over that
  count — its share of the global mean — and the gradients summed over
  the data axis after the backward: the gradient of the count-weighted
  global mean. Its levers (see :func:`make_train_step`) change where the
  state lives, not what the step computes: the vocab-sharded head
  (``--mesh.model-parallel``), ZeRO-1 moments (``--zero-optimizer``),
  FSDP parameters (``--fsdp``), laid out by ``train/state.place_model``,
  and gradient accumulation (``--accum-steps``).
- **spmd** (``--spmd-mode``, JAX ``make_spmd_train_step``): each rank's
  loss is its local masked mean with its local batchnorm statistics
  (global with ``sync_batchnorm``), the gradients averaged over the ranks
  however many valid rows each held (``collectives.avg_grads``, the
  reference's ``mpi_avg_grads``), and the running statistics averaged
  after the forward. Its three levers, alone or composed, change how the
  gradients are synced and applied, not what the step computes (see
  :func:`make_spmd_train_step`): ``--zero-opt-state`` (the optimizer's
  moments sharded, ``train/state.ZeroOptimizer``), ``--grad-sync-buckets``
  (one collective per bucket, issued from the backward as the bucket's
  last gradient lands) and ``--mesh-pods`` (the two-phase hierarchical
  sync over the nested layout of ``parallel/mesh.py``).

In both the reported loss is the count-weighted global mean, ``correct``
and ``count`` are summed over the ranks, ``grad_norm`` is the synced
gradients', and the skip verdict reads only synced values, so every rank
takes the same branch. For one rank every collective is the identity and
the step computes what the one-process step always computed, bit for bit
(``tests/test_torch_dp_step.py``).

The device cache (``--device-cache``, JAX ``make_cached_train_step``,
``make_scanned_epoch``, ``make_cached_eval_step``): the training set lives
in device memory (``trainer.build_device_cache``) and each step gathers
its batch by index (:func:`_gather_batch`), then runs the auto step's
body.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpi_pytorch_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from mpi_pytorch_tpu_torch.models.common import BatchNorm, VocabParallelDense, set_rng
from mpi_pytorch_tpu_torch.ops.losses import (
    accuracy_count,
    classification_ce_sum,
    valid_count,
    vocab_parallel_accuracy_count,
    vocab_parallel_ce_sum,
)
from mpi_pytorch_tpu_torch.parallel import collectives, distributed
from mpi_pytorch_tpu_torch.parallel.collectives import Chain
from mpi_pytorch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    ICI_AXIS,
    MODEL_AXIS,
    POD_AXIS,
    Axis,
    Mesh,
    create_mesh,
    data_axis,
    is_hierarchical,
    zero_shard_axis,
)
from mpi_pytorch_tpu_torch.train.state import Placement, TrainState, ZeroOptimizer, owned_slice

# ``Config.compute_dtype`` → torch dtype.
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def ingest_images(images: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Device-side image ingest, keyed on the batch dtype:

    - uint8 batches are raw pixels (``input_dtype='uint8'``, 4× less
      host→device traffic than f32): the ImageNet normalize runs on the
      device in f32 with the op order of ``pipeline.normalize_image``
      (``/255``, ``−mean``, ``/std``, each a correctly rounded division —
      PyTorch on CUDA turns a division by a Python scalar into a multiply
      by its reciprocal, so 255 goes as a tensor filled on the device),
      then casts to the compute dtype;
    - float batches were normalized on the host and are just cast."""
    if images.dtype == torch.uint8:
        x = images.to(torch.float32) / torch.full((), 255.0, device=images.device)
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
        x = (x - mean) / std
        return x.to(compute_dtype)
    return images.to(compute_dtype)


def metrics_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
    """loss-sum / correct / count from f32 logits; ``labels < 0`` mark
    padding rows and count nowhere."""
    valid = labels >= 0
    per_ex = F.cross_entropy(logits, labels.clamp(min=0).long(), reduction="none")
    return {
        "loss": torch.sum(per_ex * valid),
        "correct": torch.sum((torch.argmax(logits, dim=-1) == labels) & valid),
        "count": torch.sum(valid.to(torch.int32)),
    }


def head_terms(model: nn.Module, outputs,
               labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(masked CE sum with autograd, correct count) of ``model``'s train
    output: over the vocab shards of a
    :class:`~mpi_pytorch_tpu_torch.models.common.VocabParallelDense` head
    (each rank of the model axis holds a block of the classes), else of
    the whole logits — for inception's ``(logits, aux)`` pair the CE sum
    with 0.4 of the auxiliary one (``ops.losses.classification_ce_sum``)
    and the logits' correct count."""
    fc = getattr(model, "fc", None)
    if isinstance(fc, VocabParallelDense):
        return (vocab_parallel_ce_sum(outputs, labels, fc.vocab_start, fc.axis),
                vocab_parallel_accuracy_count(outputs.detach(), labels, fc.vocab_start, fc.axis))
    logits = outputs[0] if isinstance(outputs, tuple) else outputs
    return classification_ce_sum(outputs, labels), accuracy_count(logits.detach(), labels)


def model_metrics(model: nn.Module, logits: torch.Tensor,
                  labels: torch.Tensor) -> dict[str, torch.Tensor]:
    """:func:`metrics_from_logits` of ``model``'s f32 logits, over the
    vocab shards of a vocab-parallel head."""
    if not isinstance(getattr(model, "fc", None), VocabParallelDense):
        return metrics_from_logits(logits, labels)
    loss, correct = head_terms(model, logits, labels)
    return {"loss": loss, "correct": correct, "count": valid_count(labels)}


def grad_norm(model: nn.Module) -> torch.Tensor:
    """The global L2 norm over every parameter's gradient, as an f32
    scalar (``optax.global_norm``), frozen parameters included. Each
    gradient's norm accumulates in float64: the CPU's f32 norm sums a
    tensor in order, 3.6e-5 off on a 2.4 M-element one."""
    grads = [p.grad.float() for p in model.parameters() if p.grad is not None]
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    norms = torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float64))
    return torch.linalg.vector_norm(norms).float()


def _running_stats(model: nn.Module) -> list[torch.Tensor]:
    return [
        t for m in model.modules() if isinstance(m, BatchNorm)
        for t in (m.running_mean, m.running_var)
    ]


def _sq_sum(tensors: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Σ ‖t‖² in float64, each tensor's norm as :func:`grad_norm` takes it."""
    if not tensors:
        return torch.zeros((), dtype=torch.float64, device=device)
    norms = torch.stack(torch._foreach_norm([t.float() for t in tensors], 2,
                                            dtype=torch.float64))
    return torch.sum(norms * norms)


def placed_grad_norm(placement: Placement, data: Axis) -> torch.Tensor:
    """:func:`grad_norm` of a placed model's synced gradients — the norm of
    the unsharded gradient (``optax.global_norm``): the blocks' squared
    sums summed over their axis (data-split over ``data``, the head's
    over the model axis), the replicated gradients counted once, in
    float64."""
    held = placement.held
    device = next(iter(held.values())).device

    def grads(axis_name):
        return [held[n].grad for n in placement.by_axis(axis_name) if held[n].grad is not None]

    sq = (_sq_sum(grads(None), device)
          + collectives.all_reduce(_sq_sum(grads(DATA_AXIS), device), "sum", data)
          + collectives.all_reduce(_sq_sum(grads(MODEL_AXIS), device), "sum",
                                   placement.mesh.model))
    return torch.sqrt(sq).float()


def _auto_sync(state: TrainState, data: Axis, model_axis: Axis) -> torch.Tensor:
    """The auto step's gradient sync; returns the global grad norm. Every
    gradient not already summed is summed over the data axis (an FSDP
    block's was, by its gather's reduce-scatter). Under a model axis the
    ranks of a model group compute the trunk on the same rows, each its
    own replica: its synced gradients and the running statistics come
    from the group's first rank (a broadcast), so the replicas stay
    bit-identical whatever the card's convolution algorithms sum in."""
    model, placement = state.model, state.placement
    if placement is None:
        collectives.sum_grads(model, data)
        return grad_norm(model)
    held = placement.held
    names = [n for n in placement.names if held[n].grad is not None]
    collectives.all_reduce_([held[n].grad for n in names if placement.specs[n].axis != DATA_AXIS],
                            "sum", "collectives.sum_grads", data)
    if model_axis.size > 1:
        collectives.broadcast_from(
            [held[n].grad for n in names if placement.specs[n].axis != MODEL_AXIS]
            + _running_stats(model), axis=model_axis)
    return placed_grad_norm(placement, data) if placement.sharded else grad_norm(model)


def make_train_step(compute_dtype: torch.dtype, bad_step_skip: bool = False, *,
                    mesh: Mesh | None = None, accum_steps: int = 1) -> Callable:
    """The auto-mode step (see the module docstring and :func:`_make_step`)
    over ``mesh`` (``parallel.mesh.create_mesh``; by default the flat data
    axis over the world): its sums run over the data axis, never the
    world, so the ranks of a model group (which hold the same rows) count
    once. The state may be placed (``train/state.place_model``: the TP
    head, ZeRO-1, FSDP) on this mesh; each lever alone or composed leaves
    the step's function as it was.

    ``accum_steps > 1`` (JAX ``accum_train_step``): each rank splits its
    rows into k contiguous microbatches (JAX's device-local split, so
    microbatch j holds the same rows), runs each forward and backward in
    turn — batchnorm statistics updated per microbatch over the data axis
    — with each microbatch's loss its CE sum over the global valid count
    of the whole batch, so the accumulated gradient is the count-weighted
    one; then one sync, one norm (the accumulated gradient's) and one
    optimizer update. The loss is the count-weighted mean."""
    return _make_step(compute_dtype, bad_step_skip, sync=None, mesh=mesh,
                      accum_steps=accum_steps)


def make_spmd_train_step(
    compute_dtype: torch.dtype,
    bad_step_skip: bool = False,
    *,
    zero_opt_state: bool = False,
    grad_bucket_mb: float = 0.0,
    mesh: Mesh | None = None,
) -> Callable:
    """The spmd-mode step (see the module docstring and :func:`_make_step`)
    over ``mesh`` (``parallel.mesh.create_mesh``; by default the flat
    layout over the world), with the JAX step's three levers, alone or
    composed; all off, the step is the reference-parity baseline:

    - ``zero_opt_state``: ``state.optimizer`` is a
      ``train.state.ZeroOptimizer`` over the ZeRO axis
      (``mesh.zero_shard_axis``). Each rank gets its slice of the mean
      gradients, updates its slice of the parameters, and one all-gather
      over that axis reassembles them.
    - ``grad_bucket_mb > 0``: the post-backward sync becomes one
      collective per ~N-MiB bucket (:func:`grad_bucket_plan`), each issued
      as an ``async_op`` collective from a post-accumulate-grad hook the
      moment the bucket's last gradient lands, so it runs while the
      backward computes earlier layers; all are waited on before the norm
      and the update (:class:`GradBuckets`).
    - a nested ``mesh`` (``--mesh-pods``): every gradient collective is
      two-phase — a reduce-scatter within the pod, an all-reduce of the
      1/ici slice across the pods — and the running statistics go through
      ``hier_pmean``.

    The collective is JAX's choice in each composition (``_GradSync``).
    The grad norm under ZeRO is the root of the slices' squared sums,
    summed over the ZeRO axis only: on a nested layout the slices are
    pod-replicated, and a sum over every rank would count each one
    ``pods`` times."""
    return _make_step(compute_dtype, bad_step_skip,
                      sync=_GradSync(zero_opt_state, grad_bucket_mb, mesh))


def grad_bucket_plan(params: Sequence[torch.Tensor], bucket_mb: float) -> list[list[int]]:
    """``params``' indices in ~``bucket_mb``-MiB buckets, walking them in
    REVERSE order (JAX ``grad_bucket_plan``): the backward produces the
    later layers' gradients first, so the first bucket to fill is the
    first whose collective can run under the rest of the backward. Pass
    the parameters in ``named_parameters()`` order, the registration order
    (the JAX tree's flatten order is alphabetical, the port's is not).
    Tensors of different dtypes never share a bucket, and a tensor larger
    than the cap gets a bucket of its own."""
    cap = max(1, int(bucket_mb * (1 << 20)))
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes, cur_dtype = 0, None
    for i in reversed(range(len(params))):
        nbytes = params[i].numel() * params[i].element_size()
        if cur and (cur_bytes + nbytes > cap or params[i].dtype != cur_dtype):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = params[i].dtype
    if cur:
        buckets.append(cur)
    return buckets


def bucket_overlap_frac(params: Sequence[torch.Tensor], buckets: list[list[int]]) -> float:
    """The plan's overlap opportunity (JAX ``bucket_overlap_frac``): the
    share of sync bytes whose collective is issued BEFORE the final bucket,
    which holds the earliest layers' gradients and so can never run under
    the backward. An upper bound from the plan, not a measurement (one
    bucket, the fused baseline: 0.0)."""

    def nbytes(bucket):
        return sum(params[i].numel() * params[i].element_size() for i in bucket)

    total = sum(nbytes(b) for b in buckets)
    if total == 0 or len(buckets) <= 1:
        return 0.0
    return round(1.0 - nbytes(buckets[-1]) / total, 4)


def hier_dcn_overlap_frac(params: Sequence[torch.Tensor], buckets: list[list[int]]) -> float:
    """The cross-pod share of :func:`bucket_overlap_frac` (JAX
    ``hier_dcn_overlap_frac``): each bucket's cross-pod payload is its
    bytes over ici, so the share is the same number, under the name of the
    claim it backs — the cross-pod phase hides under the backward."""
    return bucket_overlap_frac(params, buckets)


def synced_params(model: nn.Module) -> list[torch.Tensor]:
    """The parameters the spmd sync reduces, in ``named_parameters()``
    order: every one that takes a gradient."""
    return [p for p in model.parameters() if p.requires_grad]


class GradBuckets:
    """The bucketed gradient sync of ``model``: post-accumulate-grad hooks
    on every synced parameter count each bucket's landed gradients, and
    when the last one lands the bucket's collective is issued
    (``chain(grads) -> collectives.Chain``, ``async_op``). Issuing a bucket
    first moves the bucket issued before it to its next phase when it has
    one (the cross-pod all-reduce of the hierarchical sync), so that phase
    too runs under the backward; every rank issues its collectives in the
    same order, the hooks' order. Not ``DistributedDataParallel``: the plan
    and the order are the JAX step's.

    :meth:`arm` before the backward, :meth:`finish` after it: it issues
    any bucket whose gradients never landed (zeros, as JAX's gradient of
    an unused leaf), waits for every bucket in issue order and returns
    each parameter's result. Outside those two the hooks do nothing.
    ``timeline`` holds the last step's buckets in issue order: index,
    bytes, whether a hook issued it, and when it was issued and done
    (``time.perf_counter()``; done as first seen by a later hook or by the
    wait, so a bucket seen done by a hook was done before the backward
    ended)."""

    def __init__(self, model: nn.Module, bucket_mb: float, chain: Callable):
        self.model = model
        self.params = synced_params(model)
        self.plan = grad_bucket_plan(self.params, bucket_mb)
        self._chain = chain
        self._bucket_of = {i: b for b, bucket in enumerate(self.plan) for i in bucket}
        self._armed = False
        self.timeline: list[dict] = []
        for i, p in enumerate(self.params):
            p.register_post_accumulate_grad_hook(lambda _p, i=i: self._landed(i))

    def arm(self) -> None:
        self._missing = [len(b) for b in self.plan]
        self._chains: dict[int, Chain] = {}
        self._by_hook: dict[int, bool] = {}
        self._armed = True

    def _landed(self, i: int) -> None:
        if not self._armed:
            return
        for chain in self._chains.values():  # the timeline's done_at
            chain.poll()
        b = self._bucket_of[i]
        self._missing[b] -= 1
        if self._missing[b] == 0:
            self._issue(b, by_hook=True)

    def _issue(self, b: int, by_hook: bool) -> None:
        if self._chains:
            last = next(reversed(self._chains.values()))
            if last.issued == 1 and last.phases > 1:
                last.advance()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in (self.params[i] for i in self.plan[b])]
        with torch.profiler.record_function("collectives.grad_bucket"):
            self._chains[b] = self._chain(grads)
        self._by_hook[b] = by_hook

    def finish(self) -> list:
        for b in range(len(self.plan)):
            if b not in self._chains:
                self._issue(b, by_hook=False)
        self._armed = False
        out: list = [None] * len(self.params)
        for b, chain in self._chains.items():
            for i, r in zip(self.plan[b], chain.finish()):
                out[i] = r
        self.timeline = [
            {"bucket": b, "bytes": sum(self.params[i].numel() * self.params[i].element_size()
                                       for i in self.plan[b]),
             "issued_at": c.issued_at, "done_at": c.done_at, "by_hook": self._by_hook[b]}
            for b, c in self._chains.items()
        ]
        return out


class _GradSync:
    """spmd mode's sync of the running statistics and the gradients over a
    mesh, with the levers, in JAX's choice of collective:

    ============  =================================  ===================================
    layout        without ZeRO                       with ZeRO (this rank's slices)
    ============  =================================  ===================================
    flat          one all-reduce (``avg_grads``);    one all-reduce, then the owned
                  buckets: one all-reduce a bucket   slice; buckets: one reduce-scatter
                                                     a bucket
    nested        ``hier_pmean`` (three phases);     ``hier_reduce_scatter_mean`` (ici
                  buckets: the same a bucket         reduce-scatter, pod all-reduce);
                                                     buckets: the same a bucket
    ============  =================================  ===================================

    The mesh is made at the first step when none was given (the flat
    layout over the world: no process group to create)."""

    def __init__(self, zero: bool, bucket_mb: float, mesh: Mesh | None):
        self.zero, self.bucket_mb, self._mesh = zero, bucket_mb, mesh
        self.buckets: GradBuckets | None = None

    @property
    def mesh(self) -> Mesh:
        if self._mesh is None:
            self._mesh = create_mesh()
        return self._mesh

    def _hier_axes(self):
        return self.mesh.axis(ICI_AXIS), self.mesh.axis(POD_AXIS)

    def running_stats(self, model: nn.Module) -> None:
        """The running statistics averaged over every rank (after the
        forward, as the JAX step's ``pmean`` of its new batch stats)."""
        stats = _running_stats(model)
        if not is_hierarchical(self.mesh):
            collectives.all_reduce_(stats, "mean")
            return
        with torch.no_grad():
            for t, mean in zip(stats, collectives.hier_pmean(stats, *self._hier_axes())):
                t.copy_(mean)

    def _chain(self, grads: list[torch.Tensor]) -> Chain:
        """One bucket's sync, its first collective issued."""
        if is_hierarchical(self.mesh):
            ici, pod = self._hier_axes()
            if self.zero:
                return Chain(collectives.hier_reduce_scatter_chain(grads, ici, pod), phases=2)
            flat = torch.cat([g.reshape(-1) for g in grads])
            return Chain(_split_back(collectives.hier_psum_chain([flat], ici, pod, mean=True),
                                     grads), phases=3)
        axis = self.mesh.axes[0]
        if self.zero:
            return Chain(collectives.reduce_scatter_chain(grads, axis), phases=1)
        return Chain(collectives.mean_chain(grads, axis), phases=1)

    def arm(self, model: nn.Module) -> None:
        """Before the backward: with buckets, the hooks listen."""
        if self.bucket_mb <= 0:
            return
        if self.buckets is None:
            self.buckets = GradBuckets(model, self.bucket_mb, self._chain)
        elif self.buckets.model is not model:
            raise ValueError("a bucketed step syncs the model of its first call: its hooks "
                             "are on that model's parameters")
        self.buckets.arm()

    def gradients(self, model: nn.Module) -> tuple[list[torch.Tensor] | None, torch.Tensor]:
        """After the backward: (this rank's [chunk] slice of each synced
        parameter's mean gradient under ZeRO, else None with the means in
        the ``.grad``s; the global grad norm)."""
        params = synced_params(model)
        hier = is_hierarchical(self.mesh)
        if self.bucket_mb > 0:
            out = self.buckets.finish()
        elif not hier:
            collectives.avg_grads(model)
            out = None
            if self.zero:
                axis = self.mesh.axes[0]
                out = [owned_slice(_grad(p), axis.size, axis.index) for p in params]
        elif self.zero:
            out = collectives.hier_reduce_scatter_mean([_grad(p) for p in params],
                                                       *self._hier_axes())
        else:
            out = collectives.hier_pmean([_grad(p) for p in params], *self._hier_axes())
        if not self.zero:
            if out is not None:
                with torch.no_grad():
                    for p, mean in zip(params, out):
                        if p.grad is None:
                            p.grad = mean
                        else:
                            p.grad.copy_(mean)
            return None, grad_norm(model)
        # Each slice's norm as ``grad_norm`` takes each gradient's, their
        # squares summed in float64 over the slices and the ZeRO axis.
        norms = torch.stack(torch._foreach_norm([s.float() for s in out], 2,
                                                dtype=torch.float64))
        zero_axis, _ = zero_shard_axis(self.mesh)
        sq = collectives.all_reduce(torch.sum(norms * norms), "sum", zero_axis)
        return out, torch.sqrt(sq).float()

    def update(self, state: TrainState, slices: list[torch.Tensor] | None) -> None:
        """The optimizer's update: on the synced ``.grad``s, or under ZeRO
        on the slices of the optimizer's parameters."""
        if slices is None:
            state.optimizer.step()
            return
        opt = state.optimizer
        if not isinstance(opt, ZeroOptimizer):
            raise TypeError("zero_opt_state needs the optimizer make_optimizer(..., "
                            "zero_axis=...) builds (train.state.ZeroOptimizer)")
        index = {id(p): i for i, p in enumerate(synced_params(state.model))}
        opt.step([slices[index[id(p)]] for p in opt.params])


def _grad(p: torch.Tensor) -> torch.Tensor:
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _split_back(gen, like: Sequence[torch.Tensor]):
    """A chain over one concatenated vector, its result split back into
    ``like``'s shapes."""
    (flat,) = yield from gen
    return [part.view(t.shape) for part, t in zip(flat.split([t.numel() for t in like]), like)]


def _make_step(compute_dtype: torch.dtype, bad_step_skip: bool, sync: _GradSync | None,
               mesh: Mesh | None = None, accum_steps: int = 1) -> Callable:
    """``step(state, images, labels) -> metrics``: one optimizer update on
    this rank's rows (the whole batch for one process), in auto mode or,
    with ``sync``, in spmd mode. The model's batchnorms must already take
    the mode's statistics (``set_batchnorm_sync``: on in auto mode,
    ``sync_batchnorm`` in spmd mode).

    ``metrics`` holds 0-d device tensors ``loss`` (the masked mean CE over
    the global batch), ``correct``, ``count`` and ``grad_norm``, plus
    ``skipped`` (0/1) with ``bad_step_skip``. Nothing here waits for the
    device, except the skip policy, which must read the verdict on the
    host, and the collectives of a world of more than one rank.

    ``bad_step_skip`` (``--bad-step-policy skip``): a step whose loss or
    grad norm is not finite changes nothing — the state is bit-identical to
    before it, as the JAX step's whole-state select leaves it. The verdict
    is read before the update, so the parameters, the optimizer's moments
    (whole or sliced) and the step counter are never touched; but the
    forward has already moved the batchnorm running statistics (torch
    updates them in place during the forward), so those are restored from
    a copy taken before it."""
    spmd = sync is not None

    def axes() -> tuple[Axis, Axis]:
        if mesh is None:  # the world is the data axis (spmd: any layout)
            return collectives.world_axis(), Axis(MODEL_AXIS, 1, 0)
        return data_axis(mesh), mesh.model

    def forward(model, images):
        return model(ingest_images(images, compute_dtype).permute(0, 3, 1, 2))

    def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        model = state.model
        model.train()
        data, model_axis = axes()
        # This step's dropout and stochastic-depth masks: the data shard's
        # stream. The ranks of a model group hold the same rows, so they
        # draw the same masks and the vocab-sharded head sees one trunk.
        set_rng(model, state.masks_generator(data.index))
        saved = [t.clone() for t in _running_stats(model)] if bad_step_skip else None
        model.zero_grad(set_to_none=True)
        count = valid_count(labels)
        f32 = torch.float32
        if accum_steps == 1:
            logits = forward(model, images)
            ce_sum, correct = head_terms(model, logits, labels)
            if spmd:
                # The JAX step pmeans its new batch stats after the forward.
                sync.running_stats(model)
            # The global CE sum, valid count and correct count, all-reduced
            # before the backward.
            sums = collectives.all_reduce(torch.stack([
                ce_sum.detach(), count.to(f32), correct.to(f32)]), "sum", data)
            global_count = sums[1].to(torch.int32)
            # spmd: the local masked mean. auto: this rank's share of the
            # global mean, its CE sum over the global valid count.
            loss = ce_sum / torch.clamp(count if spmd else global_count, min=1)
            if spmd:
                sync.arm(model)
            loss.backward()
        else:
            rows = labels.shape[0]
            if rows % accum_steps:
                raise ValueError(
                    f"batch {rows * data.size} not divisible by data size {data.size} "
                    f"x accum_steps {accum_steps}"
                )
            mb = rows // accum_steps
            n = collectives.all_reduce(count.to(f32), "sum", data)
            global_count = n.to(torch.int32)
            ce_total = correct_total = 0
            for j in range(accum_steps):
                part = slice(j * mb, (j + 1) * mb)
                ce_sum, correct = head_terms(model, forward(model, images[part]), labels[part])
                (ce_sum / torch.clamp(global_count, min=1)).backward()
                ce_total = ce_total + ce_sum.detach()
                correct_total = correct_total + correct
            ce_correct = collectives.all_reduce(
                torch.stack([ce_total, correct_total.to(f32)]), "sum", data)
            sums = torch.stack([ce_correct[0], n, ce_correct[1]])
        if spmd:
            slices, norm = sync.gradients(model)
        else:
            slices, norm = None, _auto_sync(state, data, model_axis)
        metrics = {
            "loss": sums[0] / torch.clamp(sums[1], min=1),
            "correct": sums[2].to(torch.int64),
            "count": global_count,
            "grad_norm": norm,
        }
        if bad_step_skip:
            ok = bool(torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"]))
            metrics["skipped"] = torch.tensor(int(not ok), dtype=torch.int32)
            if not ok:
                with torch.no_grad():
                    for t, old in zip(_running_stats(model), saved):
                        t.copy_(old)
                model.zero_grad(set_to_none=True)
                return metrics
        state.set_learning_rate()
        if spmd:
            sync.update(state, slices)
        else:
            state.optimizer.step()
        state.step += 1
        return metrics

    # The bucket plan and the last step's bucket timeline (chip_smoke.py).
    train_step.grad_sync = sync
    return train_step


def make_eval_step(compute_dtype: torch.dtype) -> Callable:
    """``eval_step(model, images, labels) -> {loss (sum), correct, count}``:
    the eval-mode forward, logits recast to f32, masked metrics (over the
    vocab shards of a vocab-parallel head). The caller puts the model in
    eval mode."""

    @torch.no_grad()
    def eval_step(model: nn.Module, images: torch.Tensor, labels: torch.Tensor):
        logits = model(ingest_images(images, compute_dtype).permute(0, 3, 1, 2)).float()
        return model_metrics(model, logits, labels)

    return eval_step


def _gather_batch(dataset: torch.Tensor, labels_all: torch.Tensor, idx: torch.Tensor,
                  valid: torch.Tensor, compute_dtype: torch.dtype, data: Axis | None = None):
    """This rank's rows of one batch of the device cache, gathered by index
    on the device: the one ingest of the cached train step, the scanned
    epoch and the cached eval step (JAX ``_gather_batch`` with
    ``_sharded_cache_take``), so none can drift from the others.

    ``idx`` ([B] int32) and ``valid`` ([B] bool) name the GLOBAL batch, the
    same on every rank. The cache's rows are sharded over the data axis
    ``data`` (the world by default; the ranks of a model group hold the
    same rows). One data rank holds every row: an index select. With N
    each holds a contiguous 1/N of the rows
    (``trainer.build_device_cache``): each takes the rows it owns for the
    whole batch, writes literal zeros where it owns none, and the sum over
    the data axis is the batch — exact in uint8 and f32 alike, since each
    row has one owner and every other term is a zero. The rank keeps the
    slice of B/N rows at its data index, as JAX's ``psum`` and the
    data-axis shard give it. Labels are ``labels_all[idx]``, −1 where not
    ``valid``.

    Returns (images [B/N, H, W, 3] ingested into ``compute_dtype``, labels
    [B/N] int32)."""
    data = data or collectives.world_axis()
    idx = idx.long()
    labels = torch.where(valid, labels_all[idx], -1)
    if data.size == 1:
        raw = dataset.index_select(0, idx)
    else:
        n, d, per = data.size, data.index, dataset.shape[0]
        local = idx - d * per
        owned = ((local >= 0) & (local < per)).view(-1, *(1,) * (dataset.dim() - 1))
        rows = dataset.index_select(0, local.clamp(0, per - 1))
        rows = collectives.all_reduce(torch.where(owned, rows, torch.zeros_like(rows)),
                                      "sum", data)
        mine = slice(d * idx.shape[0] // n, (d + 1) * idx.shape[0] // n)
        raw, labels = rows[mine], labels[mine]
    return ingest_images(raw, compute_dtype), labels


def make_cached_train_step(compute_dtype: torch.dtype, bad_step_skip: bool = False, *,
                           mesh: Mesh | None = None) -> Callable:
    """``cached_step(state, dataset, labels_all, idx, valid) -> metrics``:
    the auto-mode step over ``mesh`` — :func:`_make_step`'s body itself,
    so the two cannot drift, with the levers of a placed state — on the
    batch :func:`_gather_batch` takes from the device cache (its rows
    sharded over the data axis). The host sends a ``[B]`` index and mask a
    step, not pixels. Auto mode only: ``validate_config`` refuses the
    cache in spmd mode and with ``accum_steps``, as the JAX package
    does."""
    step = make_train_step(compute_dtype, bad_step_skip, mesh=mesh)

    def cached_step(state: TrainState, dataset, labels_all, idx, valid):
        data = data_axis(mesh) if mesh is not None else None
        return step(state, *_gather_batch(dataset, labels_all, idx, valid, compute_dtype, data))

    return cached_step


def make_scanned_epoch(compute_dtype: torch.dtype, bad_step_skip: bool = False, *,
                       mesh: Mesh | None = None) -> Callable:
    """``epoch_fn(state, dataset, labels_all, idx_all, valid_all) ->
    metrics``: every step of an epoch from device-resident ``[n_steps, B]``
    index and mask tensors (``--scan-epoch``, JAX ``make_scanned_epoch``).
    ``metrics`` maps ``loss``, ``correct``, ``count`` and ``grad_norm``
    (and ``skipped`` with ``bad_step_skip``) to ``[n_steps]`` tensors.

    JAX runs the epoch as one ``lax.scan``: one dispatch an epoch.
    PyTorch has no scan, so the steps are still launched from Python one
    by one, each :func:`make_cached_train_step`'s step — the same
    operations on the same batches, so the same bits. What carries over is
    that nothing reads the device between steps: the host queues the whole
    epoch and the caller reads its metrics once, at the end. Under
    ``bad_step_skip`` each step still waits once, where it reads its
    verdict on the host, as the per-step path does; that keeps the state
    after every step the JAX step's. One dispatch an epoch (a CUDA graph)
    is ROADMAP A12's."""
    step = make_cached_train_step(compute_dtype, bad_step_skip, mesh=mesh)

    def epoch_fn(state: TrainState, dataset, labels_all, idx_all, valid_all):
        per_step = [step(state, dataset, labels_all, idx, valid)
                    for idx, valid in zip(idx_all, valid_all)]
        return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return epoch_fn


def make_cached_eval_step(compute_dtype: torch.dtype, data: Axis | None = None) -> Callable:
    """``cached_eval_step(model, dataset, labels_all, idx, valid) ->
    {loss (sum), correct, count}``: :func:`make_eval_step`'s forward and
    metrics on the batch :func:`_gather_batch` takes from the device cache
    (JAX ``make_cached_eval_step``), sharded over ``data``; this rank's
    rows only. The caller puts the model in eval mode."""
    eval_step = make_eval_step(compute_dtype)

    @torch.no_grad()
    def cached_eval_step(model: nn.Module, dataset, labels_all, idx, valid):
        return eval_step(model, *_gather_batch(dataset, labels_all, idx, valid, compute_dtype,
                                               data))

    return cached_eval_step
