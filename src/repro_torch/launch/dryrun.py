"""Launch dry run of the port: every (arch x shape x mesh) cell's step on
tensors without data, rank 0 of a fake world.

The reference lowers and compiles each cell's jitted step on forced host
devices and reads XLA's memory and cost analyses and the compiled HLO's
collectives.  The port runs eagerly, so its dry run runs the step itself,
on meta tensors (shapes and dtypes, no data, nothing allocated), as rank 0
of a world of 256 or 512 ranks that exists only as a ``fake`` process group
(``torch.testing._internal.distributed.fake_pg``: every collective returns
at once, nothing is sent).  It needs no card and no other process:

* **World and mesh.** The process joins the fake group as rank 0 and
  :func:`~repro_torch.launch.mesh.make_production_mesh` builds the mesh
  over it: single 16x16 ("data", "model"), multi 2x16x16 ("pod", "data",
  "model"), or a mesh given as ``data=2,model=1``.
* **Tensors.** The parameters (and the train cells' AdamW state), the cache
  and the batch are meta tensors, cut to rank 0's shards by
  ``param_layout``, ``cache_layout`` and ``local_batch``, as a step on the
  card would hold them.  Caches are bf16, as the reference's dry run has
  them.
* **Kernels.** Each kernel entry sends meta tensors to its shape-only
  stand-in (:mod:`repro_torch.kernels.fake`), counted as route ``"fake"``,
  so no kernel's plain version runs and each kernel shows the output
  shapes it gives on the card.
* **Records.** Rank 0's parameter, optimizer-state, cache and batch bytes;
  its activation peak (``MemTracker``: the most bytes live during the step
  beyond those) and whether the sum fits one H100's 81,559 MiB; the
  collectives' calls and operand bytes by kind and by mesh axis (the
  counterpart of the reference's HLO collective statistics); the FLOPs the
  step's matmuls (``FlopCounterMode``) and kernels (:mod:`~repro_torch.kernels.fake`)
  perform on rank 0; the H100 roofline terms (:mod:`.rooflines`); launches
  by route; the wall time; with ``--op-hist`` the step's aten operators
  (the counterpart of the reference's ``--hlo-hist``).

A cell the grid skips (``configs.base.shape_grid``) is recorded with the
reference's reason.  An error is recorded with its trace and counts as a
failure; the exit code is 0 only when no cell failed.  MoE cells run with
expert parallelism on every mesh with a ``model`` axis of more than one
rank, as the port's steps require (``launch/steps.py:_check_mesh``); the
reference partitions the experts with GSPMD there.  The reference's
``--qblock`` has no counterpart: the flash kernel tiles the query axis
itself.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both          # every cell
  python -m repro_torch.launch.dryrun --arch zamba2-2.7b --shape long_500k \\
      --mesh data=2,model=1 --out DIR
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import time
import traceback
from collections import Counter
from pathlib import Path

import torch

from ..configs import ARCHS, SHAPES, get_config
from ..configs.base import ShapeConfig, shape_grid
from ..kernels import fake
from ..models import api, dense
from ..optim import adamw_init
from ..optim.tree import tree_items
from ..parallel import sharding as shd
from ..parallel import spmd
from . import rooflines
from .mesh import make_production_mesh
from .steps import _global_params, cache_layout, param_layout, step_for_shape

TP = 16
OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
CARD_BYTES = 81_559 * 2**20      # one H100 80GB HBM3 as the card reports it
CACHE_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# the world and its mesh
# ---------------------------------------------------------------------------

def fake_world(size: int) -> None:
    """Make this process rank 0 of a fake world of ``size`` ranks (a fake
    world of another size is left first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def parse_mesh(kind: str) -> tuple[tuple, tuple]:
    """(shape, axis names) of a mesh: ``single``, ``multi`` or
    ``axis=n,axis=n`` (major first)."""
    if kind == "single":
        return (16, 16), ("data", "model")
    if kind == "multi":
        return (2, 16, 16), ("pod", "data", "model")
    parts = [p.split("=") for p in kind.split(",")]
    if not parts or any(len(p) != 2 for p in parts):
        raise ValueError(f"mesh {kind!r}: single, multi or axis=n,... (e.g. data=2,model=1)")
    return tuple(int(n) for _, n in parts), tuple(a for a, _ in parts)


def make_mesh(kind: str):
    shape, axes = parse_mesh(kind)
    fake_world(math.prod(shape))
    if kind in ("single", "multi"):
        return make_production_mesh(multi_pod=kind == "multi")
    return spmd.Mesh(shape, axes)


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_items(tree))


def build_cell(cfg, shape: ShapeConfig, mesh, *, microbatch: int = 1, fsdp: bool = False,
               strategy: str = "tp", kv_quant: bool = False, moe_ep: bool = False):
    """(step, args, resident) for one cell on rank 0: the step of
    :func:`~.steps.step_for_shape` and its arguments as meta tensors,
    nothing allocated; ``resident`` maps parameters, optimizer state, cache
    and batch to rank 0's bytes."""
    strat = strategy if shape.kind in ("train", "prefill") else "tp"
    moe_ep = cfg.moe is not None and (moe_ep or strat == "fsdp"
                                      or mesh.shape.get("model", 1) > 1)
    layout = param_layout(cfg, _global_params(cfg, TP), moe_ep=moe_ep, strategy=strat,
                          fsdp=fsdp, mesh=mesh)
    params = shd.shard_tree(mesh, _global_params(cfg, TP), layout)
    batch = api.input_specs(cfg, shape)
    options = dict(mesh=mesh, moe_ep=moe_ep, strategy=strat, fsdp=fsdp)
    if shape.kind == "train":
        options["microbatch"] = microbatch
    kind, step = step_for_shape(cfg, shape, tp=TP, **options)
    local = {k: shd._shard(mesh, spec, batch[k])
             for k, spec in shd.batch_pspecs(cfg, shape, mesh, strategy=strat).items()}
    resident = {"params": _nbytes(params), "batch": _nbytes(local)}
    if kind == "train":
        opt = adamw_init(params)
        resident["opt_state"] = _nbytes(opt)
        return step, (params, opt, batch), resident
    if kv_quant and cfg.family == "dense":
        cache = dense.init_cache(cfg, shape.global_batch, shape.seq_len, tp=TP,
                                 quantize=True, device=torch.device("meta"))
    else:
        cache = api.family_module(cfg).init_cache(cfg, shape.global_batch, shape.seq_len,
                                                  tp=TP, dtype=CACHE_DTYPE,
                                                  device=torch.device("meta"))
    cache = shd.shard_tree(mesh, cache, cache_layout(cfg, shape, mesh, cache, strategy=strat))
    resident["cache"] = _nbytes(cache)
    if kind == "prefill":
        return step, (params, batch, cache), resident
    return step, (params, cache, batch), resident


class OpHistogram(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten operators a step dispatches (the counterpart of the
    reference's HLO op histogram)."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))

    def top(self, n: int = 25) -> dict:
        return dict(self.counts.most_common(n))


def _routes() -> dict:
    out = {}
    for name, (module, attr) in fake._WRAPPERS.items():
        wrapper = getattr(importlib.import_module(f"repro_torch.kernels.{module}"), attr)
        routes = {r: n for r, n in wrapper.launches_by_route.items() if n}
        if routes:
            out[name] = routes
    return out


def run_step(step, args, resident: dict, *, op_hist: bool = False) -> dict:
    """Run ``step(*args)`` on meta tensors with the counters reset: its
    memory, FLOPs, collectives, launches and (``op_hist``) aten operators."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from ..kernels import ops

    spmd.reset_collectives()
    fake.reset()
    ops.reset_launches()
    leaves = [t for arg in args for _, t in tree_items(arg)]
    tracker = MemTracker()
    tracker.track_external(*leaves)
    flops = FlopCounterMode(display=False)
    hist = OpHistogram() if op_hist else None
    t0 = time.perf_counter()
    with tracker, flops:
        if hist is not None:
            with hist:
                step(*args)
        else:
            step(*args)
    wall = time.perf_counter() - t0
    peak = sum(v["Total"] for v in tracker.get_tracker_snapshot("peak").values())
    held = sum(t.numel() * t.element_size() for t in leaves)
    stats = spmd.collective_stats.get("fake", spmd.CollectiveStats())
    kernel_flops = dict(fake.flops)
    out = {
        "wall_s": wall,
        "memory": dict(resident, activation_peak=max(peak - held, 0)),
        "collectives": stats.as_dict(),
        "counted_flops": {"matmul": int(flops.get_total_flops()), "kernels": kernel_flops,
                          "total": int(flops.get_total_flops()) + sum(kernel_flops.values())},
        "launches_by_route": _routes(),
    }
    mem = out["memory"]
    mem["total"] = sum(mem[k] for k in ("params", "opt_state", "cache", "batch",
                                        "activation_peak") if k in mem)
    mem["card_bytes"] = CARD_BYTES
    mem["fits"] = mem["total"] <= CARD_BYTES
    if hist is not None:
        out["aten_ops"] = hist.top()
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, save: bool = True,
             out_dir=None, op_hist: bool = False, microbatch: int = 1, fsdp: bool = False,
             strategy: str = "tp", kv_quant: bool = False, moe_ep: bool = False,
             tag: str = "") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = {s: (o, w) for s, o, w in shape_grid(cfg)}[shape_name]
    result: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "microbatch": microbatch, "fsdp": fsdp, "strategy": strategy,
        "kv_quant": kv_quant, "moe_ep": moe_ep,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    if not ok:
        result.update(status="skipped", reason=why)
        _maybe_save(result, save, out_dir)
        return result
    try:
        t0 = time.perf_counter()
        mesh = make_mesh(mesh_kind)
        with torch.no_grad() if shape.kind != "train" else contextlib.nullcontext():
            step, args, resident = build_cell(cfg, shape, mesh, microbatch=microbatch,
                                              fsdp=fsdp, strategy=strategy,
                                              kv_quant=kv_quant, moe_ep=moe_ep)
            t_build = time.perf_counter() - t0
            ran = run_step(step, args, resident, op_hist=op_hist)
        coll = ran["collectives"]
        roof = rooflines.roofline(cfg, shape, mesh.size(mesh.axis_names),
                                  coll["bytes_by_axis"], tp=TP, kv_quant=kv_quant,
                                  mesh_shape=dict(mesh.shape), axis_names=mesh.axis_names)
        result.update(status="ok", chips=mesh.size(mesh.axis_names),
                      mesh_shape=dict(mesh.shape), build_s=t_build, roofline=roof, **ran)
    except Exception as e:  # record the failure, don't crash the sweep
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-4000:])
    _maybe_save(result, save, out_dir)
    return result


def _maybe_save(result: dict, save: bool, out_dir=None) -> None:
    if not save:
        return
    out = Path(out_dir) if out_dir else OUT_DIR
    out.mkdir(parents=True, exist_ok=True)
    tag = result.get("tag") or ""
    suffix = f"_{tag}" if tag else ""
    name = f"{result['arch']}_{result['shape']}_{result['mesh']}{suffix}.json"
    (out / name.replace("/", "-")).write_text(json.dumps(result, indent=2, default=str))


def summary_line(r: dict) -> str:
    line = f"[{r['status']:7s}] {r['arch']:24s} {r['shape']:12s} {r['mesh']:6s}"
    if r["status"] == "ok":
        mem = r["memory"]
        line += (f" wall={r['wall_s']:7.1f}s"
                 f" coll={r['collectives']['total_bytes'] / 1e6:9.1f}MB"
                 f" dominant={r['roofline']['terms']['dominant']}"
                 f" rank0={mem['total'] / 2**30:.2f}GiB fits={mem['fits']}")
    elif r["status"] == "error":
        line += " " + r["error"][:120]
    else:
        line += " " + r["reason"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    help="single, multi, both, or axis=n,... (e.g. data=2,model=1)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--op-hist", action="store_true",
                    help="record the step's aten operator histogram")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--strategy", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--moe-ep", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None, help=f"output directory (default {OUT_DIR})")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(arch, s, m) for arch in ARCHS for s in SHAPES for m in meshes]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    failures = 0
    for arch, s, m in cells:
        r = run_cell(arch, s, m, out_dir=args.out, op_hist=args.op_hist,
                     microbatch=args.microbatch, fsdp=args.fsdp, strategy=args.strategy,
                     kv_quant=args.kv_quant, moe_ep=args.moe_ep, tag=args.tag)
        failures += r["status"] == "error"
        print(summary_line(r), flush=True)
    print(f"done; {failures} failures")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
