"""Sharded offload units: the op set's ``torch_fn``s on DTensors over a mesh.

The reference places an entry unit's arguments with ``NamedSharding`` and
lets GSPMD partition the jitted unit (``core/convert.py`` there).  The port
runs one process per rank (:mod:`.spmd`), every rank running the same
guest program (the emulator is deterministic, so the guest side is
replicated), and partitions a unit with DTensor, PyTorch's counterpart of
``NamedSharding`` plus GSPMD:

* at a crossing, :func:`to_mesh` turns each argument into a DTensor over
  the mesh's ``DeviceMesh``: the entry unit's by its ``arg_specs`` (this
  rank keeps its shard, cut locally, no communication), every other
  argument and every staged global replicated;
* the unit body runs the op set's ``torch_fn``s on those DTensors under
  ``implicit_replication`` (a tensor an op makes itself, such as rope's
  tables, counts as replicated), so each op computes its share of the
  **global** result by DTensor's sharding rules; the three registered
  kernel operators have theirs in :func:`repro_torch.kernels.library.register_sharding_rules`;
* :func:`to_host` gives every rank the full value of an output (a gather,
  or a sum of partial values), as the reference's ``np.asarray`` does.

Where an op's inputs are placed in a way its rule does not take, DTensor
redistributes them first.  :func:`run_op` counts the collectives each op
issues in ``redistributions_by_op`` (per process, keyed by op kind), so a
run shows where the partitioner gathered.

**Collectives.**  DTensor redistributes through PyTorch's functional
collectives, which hang on gloo with CUDA tensors (two ranks sharing the
H100, route ``"shared"``: the first all-gather of a probe never returned).
So every sharded unit runs under :class:`_Collectives`, a dispatch mode
that carries out each functional collective DTensor issues as the plain
``torch.distributed`` call :mod:`.spmd` makes (``all_gather_into_tensor``,
``all_reduce``, ``all_to_all_single``; a reduce-scatter as an all-reduce
and this rank's chunk), synchronously, on every route, and counts it.
"""
from __future__ import annotations

import contextlib
import math
import threading
from collections import Counter

import torch

redistributions_by_op: Counter = Counter()

# the functional collectives DTensor issues, carried out by _collective
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd")
_CARRIED = ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
            "all_to_all_single")


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def placements(mesh, spec, ndim: int) -> tuple:
    """``spec`` (a :class:`~repro_torch.parallel.sharding.P` or ``None``)
    as DTensor placements over ``mesh``'s axes: ``Shard(dim)`` on each axis
    that splits a tensor dim, ``Replicate()`` on the rest.  A dim split over
    several axes must name them in the mesh's order (major first)."""
    from torch.distributed.tensor import Replicate, Shard

    from .sharding import _axes_of

    spec = tuple(spec or ())
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the argument's {ndim} dims")
    on = {}
    for dim, part in enumerate(spec):
        axes = _axes_of(part)
        order = [mesh.axis_names.index(a) for a in mesh.axes(axes)] if axes else []
        if order != sorted(order):
            raise ValueError(f"spec {spec}: the axes of dim {dim} must follow the mesh's "
                             f"order {mesh.axis_names}")
        for a in axes:
            if a in on:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            on[a] = dim
    return tuple(Shard(on[a]) if a in on else Replicate() for a in mesh.axis_names)


def to_mesh(mesh, x: torch.Tensor, spec=None):
    """The full tensor ``x`` (every rank holds it) as a DTensor placed by
    ``spec`` (``None``: replicated); this rank keeps its shard.  Raises
    :class:`ValueError` where a split dim does not divide evenly."""
    from torch.distributed.tensor import DTensor, Shard

    place = placements(mesh, spec, x.ndim)
    for a, p in zip(mesh.axis_names, place):
        if isinstance(p, Shard) and x.shape[p.dim] % mesh.size(a):
            raise ValueError(f"dim {p.dim} of shape {tuple(x.shape)} does not split "
                             f"{mesh.size(a)} ways over {a!r}")
    local = x
    for a, p in zip(mesh.axis_names, place):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(a), p.dim)[mesh.axis_index(a)]
    return DTensor.from_local(local.contiguous(), mesh.device_mesh, place, run_check=False,
                              shape=x.shape, stride=x.stride())


def to_host(x) -> torch.Tensor:
    """The full value of a unit's output on this rank: a DTensor gathered
    (and its partial sums reduced) over the mesh, a tensor as it is."""
    if not isinstance(x, _dtensor()):
        return x
    if _modes():
        return x.full_tensor()
    with unit_scope():
        return x.full_tensor()


def _group(name):
    import torch.distributed.distributed_c10d as c10d

    return name if isinstance(name, c10d.ProcessGroup) else c10d._resolve_process_group(name)


def _all_reduce(x, op: str, group):
    import torch.distributed as dist

    out = x.contiguous().clone()
    if op == "avg":           # gloo has no AVG: a sum over the group's ranks
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / dist.get_world_size(group)
    dist.all_reduce(out, op=getattr(dist.ReduceOp, op.upper()), group=group)
    return out


# each functional collective's kind in spmd's collective_stats (a
# reduce-scatter is carried out as an all-reduce)
_KINDS = {"all_gather_into_tensor": "all_gather", "all_reduce": "all_reduce",
          "reduce_scatter_tensor": "all_reduce", "all_to_all_single": "all_to_all"}


def _count_bytes(name: str, x, group) -> None:
    """Count the collective in :mod:`.spmd`'s counters, under the mesh axis
    of its group."""
    import torch.distributed as dist

    from . import spmd

    spmd.count_collective(dist.get_backend(group), _KINDS[name], _KINDS[name], x,
                          spmd.axis_of(group))


def _collective(name: str, args):
    """One functional collective, carried out with ``torch.distributed``'s
    plain calls (the ones :mod:`.spmd` uses on every route), its operand
    bytes counted in ``spmd.collective_stats``."""
    import torch.distributed as dist

    if name in _KINDS:
        _count_bytes(name, args[0], _group(args[-1]))

    if name == "all_gather_into_tensor":
        x, n, group = args
        x = x.contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=_group(group))
        return out
    if name == "all_reduce":
        x, op, group = args
        return _all_reduce(x, op, _group(group))
    if name == "reduce_scatter_tensor":
        x, op, n, group = args
        group = _group(group)
        return _all_reduce(x, op, group).chunk(n)[dist.get_rank(group)].contiguous()
    if name == "all_to_all_single":
        x, out_splits, in_splits, group = args
        x = x.contiguous()
        out = torch.empty((sum(out_splits),) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_to_all_single(out, x, output_split_sizes=list(out_splits),
                               input_split_sizes=list(in_splits), group=_group(group))
        return out
    raise NotImplementedError(f"sharded units: DTensor issued the functional collective "
                              f"{name!r}; the units carry out only {_CARRIED}")


class _Collectives(torch.utils._python_dispatch.TorchDispatchMode):
    """Carries out (and counts, under the current op's kind) the functional
    collectives issued while active: DTensor desugars an op into them below
    this mode, as ``CommDebugMode`` relies on."""

    def __init__(self):
        super().__init__()
        self.kind = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is _dtensor() for t in types):
            return NotImplemented
        name = func._overloadpacket.__name__
        if func.namespace not in _COLLECTIVE_NAMESPACES or name.startswith("_"):
            return func(*args, **(kwargs or {}))
        if name == "wait_tensor":          # ours completed synchronously
            return args[0]
        redistributions_by_op[self.kind or "<outputs>"] += 1
        return _collective(name, args)


_MODES = threading.local()         # this thread's active _Collectives


def _modes() -> list:
    if not hasattr(_MODES, "stack"):
        _MODES.stack = []
    return _MODES.stack


def _kept(in_shape, out_shape, d: int) -> bool:
    """Whether a reshape of ``in_shape`` to ``out_shape`` keeps dim ``d``
    whole (the same extent, after the same number of elements)."""
    before, acc = math.prod(in_shape[:d]), 1
    for n in out_shape:
        if acc == before and n == in_shape[d]:
            return True
        acc *= n
        if acc > before:
            return False
    return False


def _replicated_where(x, lost):
    """x with the mesh dims in ``lost`` redistributed to replicated."""
    from torch.distributed.tensor import Replicate

    place = [Replicate() if i in lost else p for i, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, place)


def _prepare(kind: str, params, ins):
    """The input of a ``reshape`` that would merge a sharded dim with
    another (one that does not keep the dim whole), redistributed to
    replicated over the mesh dims that shard it: DTensor refuses such a view
    in some versions and gathers in others.  ``embed`` needs no such step:
    its lookup keeps the ids' shape (``core/opset.py:_torch_embed``), so
    split ids stay split over the replicated table."""
    from torch.distributed.tensor import Shard

    if kind != "reshape" or not isinstance(ins[0], _dtensor()):
        return ins
    x = ins[0]
    shape = tuple(x.shape)
    target = list(params["shape"])
    if -1 in target:
        target[target.index(-1)] = math.prod(shape) // -math.prod(target)
    lost = {m for m, p in enumerate(x.placements)
            if isinstance(p, Shard) and not _kept(shape, target, p.dim)}
    if not lost:
        return ins
    return [_replicated_where(x, lost)] + list(ins[1:])


def _local_matmul(fn, params, a, b):
    """``matmul`` of ``a`` split on its leading dims by a replicated matrix
    ``b``, on each rank's rows, as a DTensor placed as ``a``; None where the
    layout is another.  The product is local there, but ``torch.matmul``
    flattens the leading dims into one, which DTensor 2.11 refuses where a
    dim other than the first is split (2.13 tracks the split through the
    flatten)."""
    from torch.distributed.tensor import Replicate, Shard

    DTensor = _dtensor()
    if not isinstance(a, DTensor) or b.dim() != 2 or a.dim() < 2:
        return None
    if isinstance(b, DTensor) and not all(isinstance(p, Replicate) for p in b.placements):
        return None
    if not all(isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim < a.dim() - 1)
               for p in a.placements):
        return None
    local = fn(params, a.to_local(), b.to_local() if isinstance(b, DTensor) else b)[0]
    shape = torch.Size(tuple(a.shape[:-1]) + (local.shape[-1],))
    stride = torch.empty(shape, device="meta").stride()
    return (DTensor.from_local(local, a.device_mesh, a.placements, run_check=False,
                               shape=shape, stride=stride),)


def run_op(kind: str, fn, params, ins) -> tuple:
    """``fn(params, *ins)``, one op of a sharded unit, its redistributions
    counted under ``kind``; a ``matmul`` of rows split on leading dims by a
    replicated matrix runs on each rank's rows (:func:`_local_matmul`)."""
    mode = _modes()[-1]
    mode.kind = kind
    try:
        if kind == "matmul":
            out = _local_matmul(fn, params, *ins)
            if out is not None:
                return out
        return fn(params, *_prepare(kind, params, ins))
    finally:
        mode.kind = None


@contextlib.contextmanager
def unit_scope():
    """The context a sharded unit runs in: the operators' sharding rules
    registered, plain tensors taken as replicated, and DTensor's
    collectives carried out by :class:`_Collectives`."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..kernels.library import register_sharding_rules

    register_sharding_rules()
    mode = _Collectives()
    _modes().append(mode)
    try:
        with implicit_replication(), mode:
            yield
    finally:
        _modes().pop()
