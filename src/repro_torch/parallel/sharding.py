"""Sharding rules of the port: logical param/activation layout -> specs.

The reference's ``parallel/sharding.py``, rule for rule.  Placement on the
production mesh (see launch/mesh.py):

  * batch           -> ("pod", "data")  (pure DP across pods)
  * attention heads -> "model"          (TP; head-planned, see attention_plan)
  * d_ff / experts  -> "model"          (TP / EP)
  * vocab           -> "model"
  * long-context caches/seq -> "data"   (SP for the long_500k cells)

Rules map a leaf's key path (``optim/tree.py``'s ``"a/b/c"`` names) to a
:class:`P`, a tuple of mesh-axis names (or tuples of them, or ``None``) per
tensor dim that prints like the reference's ``PartitionSpec``.  A mesh here
is anything with ``axis_names`` and a ``shape`` mapping each axis to its size
(:class:`~repro_torch.parallel.spmd.Mesh`, or a stand-in in the tests).

The reference hands its specs to XLA, which partitions the program; the
port runs one eager process per rank, so the specs cut trees into each
rank's shards (:func:`shard_tree`, :func:`gather_tree`) and the models do
their own communication (``models/layers.py``, ``models/moe.py``).
:func:`constrain_batch` and :func:`constrain_layer_params` steer XLA's
propagation in the reference; per-rank eager code has none to steer, so they
return their input (``constrain_layer_params`` still casts).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..optim.tree import tree_build, tree_items


class P(tuple):
    """A partition spec: one entry per tensor dim, each a mesh-axis name, a
    tuple of names (major to minor) or ``None`` (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        # pickled (to a spawned rank) as its parts, not as one tuple part
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(repr(p) for p in self)})"


def _axes_of(part) -> tuple:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def spec_axes(spec: P) -> tuple[str, ...]:
    """Every mesh axis that shards some dim of ``spec``."""
    return tuple(a for part in spec for a in _axes_of(part))


def dp_axes(mesh) -> tuple:
    """Data-parallel mesh axes: ("pod","data") on multi-pod, ("data",) else."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def _stacked(parts: list) -> bool:
    # stacked-layer params carry a leading L axis; the list-of-layers
    # families (xlstm) index layers as tree positions ("layers/0/..."),
    # which adds no tensor axis
    return (parts[0] in ("layers", "enc_layers", "dec_layers") and len(parts) > 1
            and not parts[1].isdigit())


def param_pspec(cfg: ModelConfig, path: str, ndim: int) -> P:
    """PartitionSpec for one parameter, by key-path suffix."""
    M = "model"
    parts = path.split("/")
    leaf = parts[-1]
    pre = (None,) if _stacked(parts) else ()

    def spec(*s):
        out = pre + s
        assert len(out) == ndim, (path, ndim, out)
        return P(*out)

    # embeddings / lm head: vocab sharded
    if leaf == "table":
        return P("model", None)
    if leaf == "patch_proj":
        return P(None, "model")
    # attention
    if leaf in ("wq", "wk", "wv"):
        if ndim - len(pre) == 3:
            return spec(None, M, None)        # (d, H, hd): heads -> model
        return spec(None, M)                  # xlstm mLSTM dv sharding handled below
    if leaf in ("bq", "bk", "bv"):
        return spec(M, None)
    if leaf == "wo":
        if ndim - len(pre) == 3:
            return spec(M, None, None)        # (H, hd, d)
        return spec(M, None)
    if leaf == "wo_gate":
        return spec(None, None, M)
    # mlp
    if leaf in ("wg", "wu"):
        if ndim - len(pre) == 3:              # moe experts (E, d, f): EP
            return spec(M, None, None)
        return spec(None, M)
    if leaf == "wd":
        if ndim - len(pre) == 3:
            return spec(M, None, None)
        return spec(M, None)
    if leaf == "router":
        return spec(None, None)
    # mamba2
    if leaf in ("w_z", "w_x"):
        return spec(None, M)                  # d_inner (heads*P) -> model
    if leaf in ("w_B", "w_C"):
        return spec(None, None)
    if leaf == "w_dt":
        return spec(None, M)
    if leaf == "conv":
        return spec(None, M)
    if leaf in ("A_log", "D", "dt_bias"):
        return spec(M)
    if leaf == "w_out":
        return spec(M, None)
    # xlstm
    if leaf in ("wi", "wf"):
        return spec(None, None)
    if leaf == "fb":
        return spec(None)
    if leaf == "wx":
        return spec(None, None, M)            # sLSTM input gates: D -> model
    if leaf == "rh":
        return spec(None, None, None, None)   # block-diag recurrent: replicated
    # norms / everything else: replicated
    return P(*([None] * ndim))


def _xlstm_overrides(cfg: ModelConfig, path: str, ndim: int) -> P | None:
    """mLSTM shards the value dim (dv), not heads (only 4 of them)."""
    if cfg.family != "ssm":
        return None
    leaf = path.split("/")[-1]
    if leaf == "wv" and ndim == 3:
        return P(None, None, "model")         # (d, H, dv): dv -> model
    if leaf in ("wq", "wk") and ndim == 3:
        return P(None, None, None)            # dk replicated (normalizer needs it)
    if leaf == "wo" and ndim == 3:
        return P(None, "model", None)         # mLSTM (H, dv, d)
    return None


def _add_fsdp(spec: P, shape: tuple, *, data_size: int = 16, skip_dim0: bool = False) -> P:
    """ZeRO/FSDP: additionally shard the largest free dim over "data"."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = None, -1
    for i, (p, d) in enumerate(zip(parts, shape)):
        if p is None and d % data_size == 0 and d > best_dim and not (skip_dim0 and i == 0):
            best, best_dim = i, d
    if best is None:
        return P(*parts)
    parts[best] = "data"
    return P(*parts)


def _fully_sharded_spec(path: str, shape: tuple, mesh) -> P:
    """Pure-FSDP layout: shard the largest weight dim over as many mesh axes
    as divide it (("pod","data","model") jointly where possible); embedding
    tables stay vocab-dim sharded; MoE experts keep expert parallelism over
    "model" and ZeRO their per-expert matrices over "data"."""
    leaf = path.split("/")[-1]
    parts = path.split("/")
    stacked = _stacked(parts)
    axes_by_pref = [a for a in ("pod", "data", "model") if a in mesh.axis_names]
    sizes = dict(mesh.shape)
    if leaf in ("table", "patch_proj"):
        dim0 = shape[0]
        group: list = []
        n = 1
        for a in axes_by_pref:
            if dim0 % (n * sizes[a]) == 0:
                group.append(a)
                n *= sizes[a]
        spec = [tuple(group) if len(group) > 1 else (group[0] if group else None)]
        spec += [None] * (len(shape) - 1)
        return P(*spec)
    if leaf in ("wg", "wu", "wd") and len(shape) == 3 and not stacked or (
            leaf in ("wg", "wu", "wd") and len(shape) == 4):
        pre = (None,) if len(shape) == 4 else ()
        d1 = shape[-2]
        return P(*(pre + ("model", "data" if d1 % sizes.get("data", 16) == 0 else None,
                          None)))
    # the largest dim (skipping the stacked L axis) divisible by the largest
    # possible product of mesh axes
    best = (0, None, None)  # (n_ways, dim_index, axis_group)
    start = 1 if stacked else 0
    for i in range(start, len(shape)):
        group = []
        n = 1
        for a in axes_by_pref:
            if shape[i] % (n * sizes[a]) == 0:
                group.append(a)
                n *= sizes[a]
        if group and n > best[0]:
            best = (n, i, tuple(group) if len(group) > 1 else group[0])
    spec = [None] * len(shape)
    if best[1] is not None:
        spec[best[1]] = best[2]
    return P(*spec)


def param_pspecs(cfg: ModelConfig, params: Any, *, fsdp: bool = False,
                 strategy: str = "tp", mesh=None) -> Any:
    """A tree of :class:`P` laid out as ``params`` (tensors, or anything
    with ``shape``)."""
    def assign(ps, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if strategy == "fsdp":
            assert mesh is not None, "fsdp strategy needs the mesh"
            return _fully_sharded_spec(ps, shape, mesh)
        ov = _xlstm_overrides(cfg, ps, nd)
        spec = ov if ov is not None else param_pspec(cfg, ps, nd)
        if fsdp and ps.split("/")[-1] not in ("table", "patch_proj"):
            # ZeRO on top of TP: additionally shard over "data"
            spec = _add_fsdp(spec, shape, skip_dim0=_stacked(ps.split("/")))
        return spec

    return tree_build((name, assign(name, leaf)) for name, leaf in tree_items(params))


def opt_state_pspecs(cfg: ModelConfig, params: Any, *, fsdp: bool = False,
                     strategy: str = "tp", mesh=None) -> Any:
    """AdamW moments mirror the param layout; step is replicated."""
    pspecs = param_pspecs(cfg, params, fsdp=fsdp, strategy=strategy, mesh=mesh)
    return {"m": pspecs, "v": pspecs, "step": P()}


# ---------------------------------------------------------------------------
# activations / batch / cache
# ---------------------------------------------------------------------------

def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 *, strategy: str = "tp") -> dict[str, P]:
    dp = dp_axes(mesh)
    dspec = dp if len(dp) > 1 else dp[0]
    if strategy == "fsdp":
        # no tensor parallelism: batch shards over as many axes as divide it
        sizes = dict(mesh.shape)
        for cand in (("pod", "data", "model"), ("data", "model"), ("pod", "data"), ("data",)):
            axes = tuple(a for a in cand if a in sizes)
            n = math.prod(sizes[a] for a in axes) if axes else 1
            if axes and shape.global_batch % n == 0:
                dspec = axes if len(axes) > 1 else axes[0]
                break
    out: dict[str, P] = {}
    if shape.kind == "train":
        out = {"tokens": P(dspec, None), "labels": P(dspec, None)}
    elif shape.kind == "prefill":
        out = {"tokens": P(dspec, None)}
    else:
        out = {"token": P(dspec, None)}
    if cfg.family == "encdec" and shape.kind != "decode":
        out["frames"] = P(dspec, None, None)
    if cfg.family == "vlm" and shape.kind != "decode":
        out["patches"] = P(dspec, None, None)
    if shape.global_batch == 1:
        # long-context decode: batch unshardable; sequence-parallel instead
        out = {k: P(*([None] * 2)) if k == "token" else v for k, v in out.items()}
    return out


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh, cache: Any) -> Any:
    """PartitionSpecs for the serving cache, by leaf path + family."""
    dp = dp_axes(mesh)
    dspec = dp if len(dp) > 1 else dp[0]
    seq_parallel = shape.global_batch == 1  # long_500k: shard the sequence dim

    def assign(ps, leaf):
        nd = len(tuple(leaf.shape))
        leaf_name = ps.split("/")[-1]
        if leaf_name == "pos" or nd == 0:
            return P()
        if cfg.family in ("dense", "moe", "vlm", "encdec"):
            # (L, B, S, H, hd) attention caches (k/v/xk/xv)
            if nd == 5:
                if seq_parallel:
                    return P(None, None, dspec, "model", None)
                return P(None, dspec, None, "model", None)
            return P(*([None] * nd))
        if cfg.family == "hybrid":
            if leaf_name in ("ak", "av"):
                if seq_parallel:
                    return P(None, None, dspec, "model", None)
                return P(None, dspec, None, "model", None)
            if leaf_name == "S":      # (L, B, H, N, P): heads -> model
                return P(None, None if seq_parallel else dspec, "model", None, None)
            if leaf_name == "conv":   # (L, B, K-1, d_inner)
                return P(None, None if seq_parallel else dspec, None, "model")
            return P(*([None] * nd))
        if cfg.family == "ssm":
            from ..models.xlstm import is_slstm_layer

            bspec = None if seq_parallel else dspec
            parts = ps.split("/")
            lidx = int(parts[1]) if len(parts) > 2 and parts[0] == "layers" else -1
            slstm = lidx >= 0 and is_slstm_layer(cfg, lidx)
            if slstm:
                # (B, D) scalar-memory states: D -> model
                return P(*((bspec, "model") + (None,) * (nd - 2)))
            if leaf_name == "C":      # mLSTM (B, H, dk, dv): dv -> model
                return P(bspec, None, None, "model")
            return P(*((bspec,) + (None,) * (nd - 1)))
        return P(*([None] * nd))

    return tree_build((name, assign(name, leaf)) for name, leaf in tree_items(cache))


def layer_slice_pspecs(cfg: ModelConfig, params: Any, *, strategy: str, mesh,
                       key: str = "layers") -> Any:
    """Per-layer (scan-slice) shard specs: stacked specs minus the L axis."""
    full = param_pspecs(cfg, params, strategy=strategy, mesh=mesh)
    return strip_layer_axis(full[key], params[key])


def strip_layer_axis(specs: Any, stacked: Any) -> Any:
    """A spec tree of stacked (L, ...) leaves as one layer's: each spec
    without its first entry."""
    shapes = dict(tree_items(stacked))

    def strip(name, spec):
        parts = list(spec) + [None] * (len(shapes[name].shape) - len(spec))
        return P(*parts[1:])

    return tree_build((name, strip(name, spec)) for name, spec in _spec_items(specs))


# ---------------------------------------------------------------------------
# specs over a mesh: placements, shards
# ---------------------------------------------------------------------------

def _spec_items(tree_specs: Any):
    """(path, spec) pairs of a spec tree (a :class:`P` is a leaf)."""
    if isinstance(tree_specs, P):
        yield "", tree_specs
        return
    if isinstance(tree_specs, dict):
        children = [(str(k), tree_specs[k]) for k in sorted(tree_specs)]
    else:
        children = [(str(i), t) for i, t in enumerate(tree_specs)]
    for k, child in children:
        for name, spec in _spec_items(child):
            yield (f"{k}/{name}" if name else k), spec


def _map_specs(fn, tree_specs: Any, *trees) -> Any:
    """``fn(spec, *leaves)`` over a spec tree and trees laid out as it."""
    leaves = [dict(tree_items(t)) for t in trees]
    items = [(name, fn(spec, *(lv[name] for lv in leaves)))
             for name, spec in _spec_items(tree_specs)]
    if len(items) == 1 and items[0][0] == "":
        return items[0][1]
    return tree_build(items)


def to_named(mesh, tree_pspecs: Any) -> Any:
    """Each spec as DTensor placements over ``mesh.device_mesh``: per mesh
    axis, ``Shard(dim)`` for the tensor dim it shards, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    def named(spec):
        dims = {a: i for i, part in enumerate(spec) for a in _axes_of(part)}
        return tuple(Shard(dims[a]) if a in dims else Replicate() for a in mesh.axis_names)

    return _map_specs(named, tree_pspecs)


def _shard(mesh, spec: P, x):
    for dim, part in enumerate(spec):
        axes = _axes_of(part)
        if not axes:
            continue
        n = math.prod(mesh.shape[a] for a in axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not split "
                             f"{n} ways over {axes}")
        x = x.chunk(n, dim)[mesh.axis_index(axes)]
    return x


def shard_tree(mesh, tree: Any, specs: Any) -> Any:
    """This rank's shards of a full tree: each leaf cut along every dim its
    spec names, at this rank's index over those axes (a tuple of axes in
    their joint order, the first major), as fresh contiguous tensors."""
    return _map_specs(lambda spec, x: _shard(mesh, spec, x).clone(), specs, tree)


def gather_tree(mesh, tree: Any, specs: Any) -> Any:
    """The full tree from every rank's shards (:func:`shard_tree` undone),
    on every rank; no autograd."""
    from .spmd import _all_gather

    def gather(spec, x):
        with torch.no_grad():
            for dim, part in enumerate(spec):
                if _axes_of(part):
                    x = _all_gather(mesh, x, _axes_of(part), dim)
        return x

    return _map_specs(gather, specs, tree)


# ---------------------------------------------------------------------------
# activation sharding constraints (context-scoped)
# ---------------------------------------------------------------------------

_ACT_CTX: list = []


class activation_sharding:
    """Context manager installing the layout of the step it wraps, which the
    models read from here: the mesh, the ``strategy`` (``"tp"``: tensor
    parallelism over ``model``, :func:`tensor_parallel`; ``"fsdp"``: none),
    the axes that split the batch (``batch_axes``, a name or a tuple) and
    ``layer_pspecs``, the per-layer specs :func:`constrain_layer_params`
    gathers a layer's leaves by (a dict from the params' layer key,
    ``"layers"``, ``"enc_layers"``, ``"dec_layers"`` or ``"shared"``, to a
    spec tree of one layer, or for xLSTM's list of layers a list of them),
    and ``seq_axes``, the axes a decode step's caches split their sequence
    over (a global batch of 1; :func:`cache_seq_axes`).  The reference's
    context steers XLA's propagation with the same specs; here they say
    what each rank gathers."""

    def __init__(self, mesh, *, strategy: str = "tp", layer_pspecs=None,
                 batch_axes=None, skip=(), seq_axes=None):
        self.mesh = mesh
        self.strategy = strategy
        self.layer_pspecs = layer_pspecs
        self.batch_axes = batch_axes
        self.skip = tuple(skip)
        self.seq_axes = tuple(seq_axes) if seq_axes else None

    def __enter__(self):
        _ACT_CTX.append(self)
        return self

    def __exit__(self, *exc):
        _ACT_CTX.pop()


def tensor_parallel() -> bool:
    """Whether the active step runs tensor parallelism: the innermost
    :class:`activation_sharding` has strategy ``"tp"`` and a ``model`` axis
    of more than one rank."""
    return (bool(_ACT_CTX) and _ACT_CTX[-1].strategy == "tp"
            and _ACT_CTX[-1].mesh.shape.get("model", 1) > 1)


def cache_seq_axes():
    """The axes the active decode step's caches split their sequence over
    (each rank holds a contiguous slice, in the axes' joint order), or None
    where each rank holds whole sequences."""
    return _ACT_CTX[-1].seq_axes if _ACT_CTX else None


def tokens_split_over(axis: str) -> bool:
    """Whether the active step's batch is split over ``axis`` (so the ranks
    along it hold different tokens; under ``"tp"`` only the data axes
    split it)."""
    return bool(_ACT_CTX) and axis in _axes_of(_ACT_CTX[-1].batch_axes)


def _gathered(axis: str, strategy: str) -> bool:
    return strategy == "fsdp" or axis != "model"


def gathered_axes(spec: P, strategy: str) -> tuple[str, ...]:
    """The axes a step gathers a leaf of ``spec`` over before using it: all
    that split it under ``"fsdp"``; under ``"tp"`` those but ``model``,
    whose shards the tensor-parallel code uses as they are."""
    return tuple(a for a in spec_axes(spec) if _gathered(a, strategy))


layer_gathers: dict = {"calls": 0, "leaves": 0}


def gather_params(tree: Any, specs: Any, cast_to=None) -> Any:
    """``tree`` (this rank's shards, laid out as ``specs``) with each leaf
    gathered over :func:`gathered_axes` of the active step, floating leaves
    first cast to ``cast_to`` on the shard (so the gather moves that dtype).
    The gather's backward keeps this rank's slice of the summed cotangent: a
    reduce-scatter.  Leaves named in the context's ``skip`` (the experts an
    expert-parallel block gathers itself) pass through."""
    from .spmd import all_gather

    ctx = _ACT_CTX[-1]
    spec_of = dict(_spec_items(specs))
    out, n = [], 0
    with ctx.mesh:
        for name, x in tree_items(tree):
            if cast_to is not None and x.is_floating_point():
                x = x.to(cast_to)
            if not any(name.startswith(k) for k in ctx.skip):
                for dim, part in enumerate(spec_of[name]):
                    axes = tuple(a for a in _axes_of(part) if ctx.mesh.shape[a] > 1
                                 and _gathered(a, ctx.strategy))
                    if axes:
                        x = all_gather(x, axes, dim)
                        n += 1
            out.append((name, x))
    layer_gathers["leaves"] += n
    return tree_build(out)


def constrain_layer_params(lp, cast_to=None, *, key: str = "layers", index: int | None = None):
    """A layer's parameters as its code uses them.  The reference pins a
    layer slice's params to their shard specs so that XLA streams the FSDP
    gathers, one layer at a time.  Here, inside a sharded step that holds
    ZeRO/FSDP shards (the context's ``layer_pspecs`` for ``key``; ``index``
    picks xLSTM's layer), each leaf is gathered over the axes that split it
    (:func:`gather_params`), inside the layer and its remat, so one layer's
    full weights exist at a time.  Floating leaves are cast to ``cast_to``
    first, on the shard, so the gather moves that dtype.  Elsewhere the
    params come back as they are (the layers cast each leaf at its use)."""
    ctx = _ACT_CTX[-1] if _ACT_CTX else None
    specs = None if ctx is None or ctx.layer_pspecs is None else ctx.layer_pspecs.get(key)
    if specs is None:
        return lp
    layer_gathers["calls"] += 1
    return gather_params(lp, specs if index is None else specs[index], cast_to)


_MOE_EP_CTX: list = []


class moe_ep_context:
    """Enables the expert-parallel MoE dispatch inside steps: the mesh, and
    the axis (if any) that also shards the experts' tokens over the
    sequence."""

    def __init__(self, mesh, seq_axis=None):
        self.mesh = mesh
        self.seq_axis = seq_axis

    def __enter__(self):
        _MOE_EP_CTX.append((self.mesh, self.seq_axis))
        return self

    def __exit__(self, *exc):
        _MOE_EP_CTX.pop()


def current_moe_ep():
    return _MOE_EP_CTX[-1] if _MOE_EP_CTX else None


def constrain_batch(x, *rest_spec, batch_shardable: bool = True):
    """The reference pins x's leading dim to the data axes for XLA's
    propagation; per-rank eager code holds its batch shard already, so x
    comes back unchanged."""
    return x
