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
    stacked = dict(tree_items(params[key]))

    def strip(name, spec):
        parts = list(spec) + [None] * (len(stacked[name].shape) - len(spec))
        return P(*parts[1:])

    return tree_build((name, strip(name, spec)) for name, spec in tree_items(full[key]))


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
    """Context manager installing the mesh of the step it wraps: the models
    read it from here (:func:`tensor_parallel`).  The reference's context
    also carries ``layer_pspecs`` and ``batch_axes`` to steer XLA's
    propagation; per-rank eager code holds its shards already, so the port
    takes neither (ROADMAP, Differences)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _ACT_CTX.append(self.mesh)
        return self

    def __exit__(self, *exc):
        _ACT_CTX.pop()


def tensor_parallel() -> bool:
    """Whether the active step runs tensor parallelism: the mesh of the
    innermost :class:`activation_sharding` has a ``model`` axis of more
    than one rank."""
    return bool(_ACT_CTX) and _ACT_CTX[-1].shape.get("model", 1) > 1


def constrain_layer_params(lp, cast_to=None):
    """The reference pins a layer slice's params to their shard specs so XLA
    streams FSDP gathers per layer.  Per-rank eager code holds its shards
    already: the params come back as they are, floating ones cast to
    ``cast_to`` when given."""
    if cast_to is None:
        return lp
    return tree_build((name, x.to(cast_to) if x.is_floating_point() else x)
                      for name, x in tree_items(lp))


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
