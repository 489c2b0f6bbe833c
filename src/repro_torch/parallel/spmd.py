"""SPMD substrate of the port: meshes, worlds of ranks, axis-named collectives.

The reference runs its sharded code as one JAX program over a device mesh
(``jax.make_mesh``; ``shard_map`` for the hand-written blocks; its tests
force several host devices).  The port runs one process per rank, each
eager, talking through ``torch.distributed``:

* :class:`Mesh` names the axes of a ``DeviceMesh`` over the world and gives
  each axis's size, this rank's index on it and its process group;
* :func:`run_spmd` spawns a world of ranks, runs a function in each and
  returns what each returned;
* the collectives (:func:`psum`, :func:`all_gather`, :func:`all_to_all`,
  :func:`ppermute`) take an axis name, resolved against the mesh entered
  with ``with mesh:``, as JAX resolves it inside ``shard_map``.  Each is a
  ``torch.autograd.Function`` whose backward is the transpose JAX gives the
  collective under ``shard_map(check_rep=False)``.

**Replicated values.**  Each rank runs autograd on its own copy of the loss,
so a value replicated over an axis carries the whole cotangent on every
rank of it.  ``shard_map`` fixes this at its boundary: an input replicated
over an axis gets its cotangent psummed over it (:func:`enter`), an output
replicated over an axis gets its cotangent divided by the axis size
(:func:`leave`).  :func:`psum_replicated` is ``leave(psum(x))`` with the two
backward steps folded: psum of n copies of ct/n is ct.

**Routes.**  A world's backend follows from the ranks' devices alone
(:func:`spmd_route`, counted in ``ranks_by_route``): ``"nccl"`` when each
rank has its own card, ``"shared"`` (gloo) when ranks share a card (NCCL
refuses two ranks on one device), ``"cpu"`` (gloo) on the CPU.  Every
collective here is one that both backends take on CUDA tensors as well as
on the CPU's (gloo 2.11 on the H100's machine runs ``all_reduce``,
``all_gather_into_tensor`` and ``all_to_all_single`` with even and uneven
splits on CUDA tensors; it refuses the list form ``all_to_all``, which is
not used), so each goes straight to the backend, counted by backend and
operation in ``collectives_by_route``.  Both counters belong to the process
that runs them.

**Collective bytes.**  :data:`collective_stats` holds, per backend, a
:class:`CollectiveStats`: the calls and the operand bytes of every
collective by kind (``all_reduce``, ``all_gather``, ``all_to_all``,
``ppermute``; the tensor each rank hands the backend, as the reference's
``launch/hlo_analysis.py`` sums the operand sizes of the compiled HLO's
collectives) and the operand bytes by mesh axis, which the roofline's link
term reads (:mod:`repro_torch.launch.rooflines`).  The sharded units'
DTensor redistributions count here too (:mod:`.units`).
"""
from __future__ import annotations

import math
import os
import pickle
import queue
import tempfile
import traceback
import weakref
from collections import Counter
from typing import Callable, Sequence

import torch
import torch.distributed as dist

BACKENDS = {"nccl": "nccl", "shared": "gloo", "cpu": "gloo"}

ranks_by_route: Counter = Counter()
collectives_by_route: dict[str, Counter] = {}
KINDS = ("all_reduce", "all_gather", "all_to_all", "ppermute")


class CollectiveStats:
    """Calls and operand bytes of one backend's collectives.

    ``count_by_kind`` and ``bytes_by_kind`` are keyed by the collective's
    kind (:data:`KINDS`), ``bytes_by_axis`` by the mesh axis it ran over
    (``"<group>"`` where only the process group is known).  The port runs
    eagerly, so a collective inside a loop (the layers, the microbatches,
    a recurrence's steps) is counted once per trip as it runs: the counts
    need no loop multiplier, where the reference multiplies the ops of an
    HLO while-body by its trip count.
    """

    def __init__(self):
        self.count_by_kind: Counter = Counter()
        self.bytes_by_kind: Counter = Counter()
        self.bytes_by_axis: Counter = Counter()

    def add(self, kind: str, nbytes: int, axis: str) -> None:
        if kind not in KINDS:
            raise ValueError(f"collective kind {kind!r}: one of {KINDS}")
        self.count_by_kind[kind] += 1
        self.bytes_by_kind[kind] += int(nbytes)
        self.bytes_by_axis[axis] += int(nbytes)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def as_dict(self) -> dict:
        return {"bytes_by_kind": dict(self.bytes_by_kind),
                "count_by_kind": dict(self.count_by_kind),
                "bytes_by_axis": dict(self.bytes_by_axis),
                "total_bytes": self.total_bytes}


collective_stats: dict[str, CollectiveStats] = {}


def count_collective(backend: str, op: str, kind: str, x, axis: str) -> None:
    """Count one collective call: ``op`` (the backend operation) in
    ``collectives_by_route``, and its kind and operand ``x``'s bytes in
    ``collective_stats``."""
    collectives_by_route.setdefault(backend, Counter())[op] += 1
    collective_stats.setdefault(backend, CollectiveStats()).add(
        kind, x.numel() * x.element_size(), axis)


def reset_collectives() -> None:
    """Set this process's collective counts and bytes to 0."""
    collectives_by_route.clear()
    collective_stats.clear()

_MESHES: list = []
_BUILT: "weakref.WeakSet" = weakref.WeakSet()   # every Mesh of this process, for axis_of
_RANK: dict = {}        # this process's rank device, set by run_spmd's worker


def spmd_route(world: int, device) -> str:
    """The route of a world of ``world`` ranks on ``device``: ``"nccl"``
    when each rank has a card of its own, ``"shared"`` when they share,
    ``"cpu"`` on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise ValueError(f"run_spmd runs on cuda or cpu, got {device}")
    return "nccl" if world <= torch.cuda.device_count() else "shared"


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

class Mesh:
    """Named axes over the ranks of the current world (a ``DeviceMesh``).

    ``shape`` maps each axis to its size and ``axis_names`` orders them,
    major to minor, as ``jax.make_mesh`` lays out its devices.  ``with
    mesh:`` makes it the mesh the collectives resolve axis names against.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        from torch.distributed.device_mesh import init_device_mesh

        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} differ in length")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if math.prod(shape) != world:
            raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks, "
                             f"the world has {world}")
        # the device run_spmd gave this rank (the CPU in a world made elsewhere)
        self.device = _RANK.get("device", torch.device("cpu"))
        self.backend = dist.get_backend()
        self.device_mesh = init_device_mesh(self.device.type, shape,
                                            mesh_dim_names=axis_names)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        _BUILT.add(self)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, backend={self.backend!r}, device={self.device})"

    def axes(self, axis) -> tuple[str, ...]:
        """``axis`` (a name or a tuple of names, major to minor) as a tuple."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in names:
            if a not in self.shape:
                raise KeyError(f"axis {a!r} is not in the mesh {self.axis_names}")
        return names

    def size(self, axis) -> int:
        return math.prod(self.shape[a] for a in self.axes(axis))

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis``; over a tuple of axes, the index
        in their joint order (the first axis major)."""
        idx = 0
        for a in self.axes(axis):
            idx = idx * self.shape[a] + self.device_mesh.get_local_rank(a)
        return idx

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(self.axes(axis)[0])

    def __enter__(self):
        _MESHES.append(self)
        return self

    def __exit__(self, *exc):
        _MESHES.pop()


def axis_of(group) -> str:
    """The mesh axis whose process group is ``group`` (on any mesh this
    process built), or ``"<group>"``."""
    for mesh in list(_BUILT):
        for a in mesh.axis_names:
            if mesh.group(a) is group:
                return a
    return "<group>"


def current_mesh() -> Mesh:
    if not _MESHES:
        raise RuntimeError("no mesh is active: collectives resolve their axis names "
                           "inside `with mesh:`")
    return _MESHES[-1]


# ---------------------------------------------------------------------------
# worlds of ranks
# ---------------------------------------------------------------------------

def _worker(rank: int, world: int, route: str, store_path: str, fn, args, results):
    try:
        if route == "cpu":
            # one thread a rank: a world shares the host with its parent
            device = torch.device("cpu")
            torch.set_num_threads(1)
        else:
            device = torch.device("cuda", rank if route == "nccl" else 0)
            torch.cuda.set_device(device)
        _RANK["device"] = device
        store = dist.FileStore(store_path, world)
        dist.init_process_group(BACKENDS[route], store=store, rank=rank, world_size=world,
                                device_id=device if route == "nccl" else None)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:        # the parent re-raises it with this traceback
        results.put((rank, False, traceback.format_exc()))
        raise


def run_spmd(fn: Callable, world: int, *, device, args: tuple = (),
             timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in each of ``world`` spawned ranks and return their
    results in rank order.

    Each rank joins a process group (rendezvous through a ``FileStore`` in a
    fresh temporary directory) on the backend of :func:`spmd_route` and
    computes on its device: ``cuda:rank`` on the ``"nccl"`` route,
    ``cuda:0`` on ``"shared"``, the CPU on ``"cpu"``.  ``fn`` and ``args``
    must pickle (a module-level function), and so must the results.  Raises
    :class:`RuntimeError` with the failing rank's traceback if any rank
    fails, or :class:`TimeoutError` if a rank reports nothing within
    ``timeout`` seconds; every rank is stopped before it returns.
    """
    route = spmd_route(world, device)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="spmd-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(r, world, route, store, fn, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        ranks_by_route[route] += world
        got: dict[int, object] = {}
        try:
            while len(got) < world:
                try:
                    rank, ok, payload = results.get(timeout=timeout)
                except queue.Empty:
                    missing = sorted(set(range(world)) - set(got))
                    raise TimeoutError(f"ranks {missing} of {world} reported nothing in "
                                       f"{timeout:.0f} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} ({route}) failed:\n{payload}")
                got[rank] = pickle.loads(payload)
        finally:
            for p in procs:
                p.join(timeout=30 if len(got) == world else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _count(mesh: Mesh, op: str, x, axis: str, kind: str | None = None) -> None:
    count_collective(mesh.backend, op, kind or op, x, axis)


def _all_reduce(mesh, x, axis, op=dist.ReduceOp.SUM):
    """x reduced over each axis of ``axis`` in turn (a new tensor)."""
    out = x.contiguous().clone()
    for a in mesh.axes(axis):
        if mesh.shape[a] > 1:
            _count(mesh, "all_reduce", out, a)
            dist.all_reduce(out, op=op, group=mesh.group(a))
    return out


def _gather_one(mesh, x, a: str, dim: int):
    n = mesh.shape[a]
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _count(mesh, "all_gather", xt, a)
    dist.all_gather_into_tensor(out, xt, group=mesh.group(a))
    return out.movedim(0, dim)


def _all_gather(mesh, x, axis, dim: int):
    """x gathered along ``dim`` over ``axis`` (tiled), the minor axis first
    so the chunks land in the joint order."""
    for a in reversed(mesh.axes(axis)):
        x = _gather_one(mesh, x, a, dim)
    return x


def _take(mesh, x, axis, dim: int):
    """This rank's chunk of x along ``dim`` over ``axis``."""
    n = mesh.size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not split {n} ways")
    return x.chunk(n, dim)[mesh.axis_index(axis)]


def _all_to_all(mesh, x, axis: str, split: int, concat: int):
    n = mesh.shape[axis]
    if n == 1:
        return x
    if x.shape[split] % n:
        raise ValueError(f"all_to_all: dim {split} of shape {tuple(x.shape)} does not "
                         f"split {n} ways")
    # chunk j of the split dim goes to rank j; chunk i received from rank i
    # is concatenated at position i of the concat dim (lax.all_to_all)
    xs = x.reshape(x.shape[:split] + (n, x.shape[split] // n) + x.shape[split + 1:])
    xs = xs.movedim(split, 0).contiguous()
    out = torch.empty_like(xs)
    _count(mesh, "all_to_all", xs, axis)
    dist.all_to_all_single(out, xs, group=mesh.group(axis))
    return torch.cat(out.unbind(0), dim=concat)


def _ppermute(mesh, x, axis: str, perm):
    n = mesh.shape[axis]
    me = mesh.axis_index(axis)
    dst = [j for i, j in perm if i == me]
    src = [i for i, j in perm if j == me]
    xc = x.contiguous()
    out = torch.zeros_like(xc)
    if n == 1:
        return xc.clone() if dst == [0] else out
    size = xc.numel()
    send = [size if j in dst else 0 for j in range(n)]
    recv = [size if i in src else 0 for i in range(n)]
    flat_out = out.reshape(-1) if src else torch.empty(0, dtype=x.dtype, device=x.device)
    flat_in = xc.reshape(-1) if dst else torch.empty(0, dtype=x.dtype, device=x.device)
    _count(mesh, "all_to_all", flat_in, axis, kind="ppermute")
    dist.all_to_all_single(flat_out, flat_in, output_split_sizes=recv, input_split_sizes=send,
                           group=mesh.group(axis))
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, g, ctx.axis), None, None


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, g, ctx.axis), None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.n = mesh.size(axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        # psum_scatter: the summed cotangent's chunk of this rank
        return _take(ctx.mesh, _all_reduce(ctx.mesh, g, ctx.axis), ctx.axis, ctx.dim), \
            None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        # the output is replicated: every rank holds the whole cotangent
        return _take(ctx.mesh, g, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split, concat):
        ctx.mesh, ctx.axis, ctx.split, ctx.concat = mesh, axis, split, concat
        return _all_to_all(mesh, x, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(ctx.mesh, g, ctx.axis, ctx.concat, ctx.split), \
            None, None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _ppermute(mesh, x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((j, i) for i, j in ctx.perm)
        return _ppermute(ctx.mesh, g, ctx.axis, inverse), None, None, None


def psum(x, axis):
    """Sum of x over ``axis`` (a name or tuple of names); its transpose is
    psum (``lax.psum``)."""
    return _Psum.apply(x, current_mesh(), axis)


def pmax(x, axis):
    """Max of x over ``axis``; carries no gradient (``lax.pmax`` under
    ``stop_gradient``)."""
    return _all_reduce(current_mesh(), x.detach(), axis, dist.ReduceOp.MAX)


def psum_replicated(x, axis):
    """Sum of x over ``axis`` into a value replicated over it:
    ``leave(psum(x))``, whose backward passes the cotangent through."""
    return _PsumReplicated.apply(x, current_mesh(), axis)


def enter(x, axis):
    """x, replicated over ``axis``, entering per-rank code: its cotangent
    is psummed over ``axis`` (``shard_map``'s input boundary)."""
    return _Enter.apply(x, current_mesh(), axis)


def leave(x, axis):
    """x, replicated over ``axis``, leaving per-rank code: its cotangent is
    divided by the axis size (``shard_map``'s output boundary)."""
    return _Leave.apply(x, current_mesh(), axis)


def all_gather(x, axis, dim: int = 0, tiled: bool = True):
    """Every rank's x along ``axis``, concatenated along ``dim`` (``tiled``)
    or stacked on a new leading axis; the transpose is psum_scatter."""
    mesh = current_mesh()
    if tiled:
        return _AllGather.apply(x, mesh, axis, dim)
    return _AllGather.apply(x.unsqueeze(dim), mesh, axis, dim)


def gather_replicated(x, axis, dim: int):
    """Every rank's x along ``axis``, concatenated along ``dim``, as a value
    replicated over ``axis``: the backward keeps this rank's slice of the
    cotangent, which every rank holds whole (``all_gather`` then
    :func:`leave`, with the two backward steps folded)."""
    return _GatherReplicated.apply(x, current_mesh(), axis, dim)


def all_to_all(x, axis: str, split: int, concat: int):
    """``lax.all_to_all(x, axis, split_axis=split, concat_axis=concat)``:
    chunk j of dim ``split`` goes to rank j, and the chunk from rank i lands
    at block i of dim ``concat``; the transpose swaps the two dims."""
    return _AllToAll.apply(x, current_mesh(), axis, split, concat)


def ppermute(x, axis: str, perm):
    """``lax.ppermute``: rank i's x goes to rank j for each (i, j) of
    ``perm``; a rank nobody sends to gets zeros.  Built on
    ``all_to_all_single`` with uneven splits (gloo has no CUDA send/recv);
    the transpose is the inverse permutation."""
    return _Ppermute.apply(x, current_mesh(), axis, tuple(tuple(p) for p in perm))


def take(x, axis, dim: int):
    """This rank's chunk of x along ``dim`` over ``axis`` (no
    communication; autograd pads the cotangent with zeros)."""
    return _take(current_mesh(), x, axis, dim)


def axis_index(axis) -> int:
    return current_mesh().axis_index(axis)


def axis_size(axis) -> int:
    return current_mesh().size(axis)
