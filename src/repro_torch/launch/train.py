"""End-to-end trainer of the port: data -> train step -> checkpoint/restart.

The reference's ``launch/train.py``: the token-only families (dense,
hybrid, moe, ssm), float32 master weights drawn on the CPU from ``seed``
(so a run on the card and one on the CPU start from the same weights),
synthetic batches from :class:`~repro_torch.data.pipeline.TokenPipeline`,
checkpoints carrying (params, opt_state, data cursor) so ``--resume``
continues exactly where a run stopped.  Runs on the card unless asked for
the CPU.  The pipeline makes tokens only, so the encdec and vlm families,
whose batches need ``frames`` or ``patches``, are refused with a
``ValueError`` (the reference's ``train()`` fails on the missing key); they
train through :func:`~repro_torch.launch.steps.make_train_step` on
``make_batch`` batches.

:func:`train` runs on the world it is called in: one process outside
:func:`~repro_torch.parallel.spmd.run_spmd` (tp=1, no mesh, as before), or
every rank of a world on :func:`local_mesh` (or the mesh it is given).
There every rank draws the full initial parameters from the same seeded
generator and keeps its shards (``launch/steps.py:param_layout``; the moe
family runs expert-parallel), and the checkpoint holds the gathered full
tree, written by rank 0, so a run can resume at another world size (the
elastic path ``runtime/fault_tolerance.py`` plans).  The CLI spawns one rank
per visible card, as the reference trains over all local devices; with one
card that is one process.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --full \\
      --steps 6 --batch 8 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b --full \\
      --steps 3 --batch 8 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced \\
      --steps 20 --batch 4 --seq 64 --device cpu --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from ..checkpoint.checkpoint import AsyncCheckpointer, latest_step
from ..configs import get_config, reduced_config
from ..configs.base import ShapeConfig
from ..core.api import resolve_device
from ..data.pipeline import DataConfig, TokenPipeline
from ..models import api
from ..optim import AdamWConfig, adamw_init
from ..optim.tree import tree_map
from ..parallel import sharding as shd
from ..parallel import spmd
from .steps import make_train_step, param_layout


def local_mesh() -> spmd.Mesh:
    """The ("data", "model") mesh of the current world, the reference's
    rule: ``model`` is the largest of 16, 8, 4, 2, 1 that divides the world
    size.  Every rank of an initialised world calls it."""
    n = dist.get_world_size()
    model = next(c for c in (16, 8, 4, 2, 1) if n % c == 0)
    return spmd.Mesh((n // model, model), ("data", "model"))


def train(arch: str, *, reduced: bool = True, steps: int = 50, batch: int = 8,
          seq: int = 128, ckpt_dir: str | None = None, resume: bool = False,
          ckpt_every: int = 20, log_every: int = 10, lr: float = 3e-4,
          seed: int = 0, device=None, mesh=None) -> dict:
    """Train ``arch`` for ``steps`` steps (counting those a resumed
    checkpoint already took).  Returns ``history`` ((step, loss) at each
    log), ``metrics`` (loss, grad norm and host milliseconds of every step
    this call ran, each step synchronised), ``params``, ``opt_state`` (in a
    world, this rank's shards, laid out by ``specs``), ``specs`` (None
    outside a world) and ``cfg``.  In a world the rank's device is the one
    ``run_spmd`` gave it, and ``mesh`` defaults to :func:`local_mesh`.  An
    elastic restart passes the mesh its plan gives
    (``fault_tolerance.build_mesh(plan_elastic_mesh(...))``), which keeps
    ``model`` fixed as the world shrinks and so need not be
    :func:`local_mesh`'s: on 4 ranks the plan at ``model_parallel=2`` is
    (2, 2) where :func:`local_mesh` gives (1, 4)."""
    cfg = reduced_config(arch) if reduced else get_config(arch)
    need = sorted(set(api.input_shapes(cfg, ShapeConfig("train", "train", seq, batch)))
                  - {"tokens", "labels"})
    if need:
        raise ValueError(
            f"train() feeds TokenPipeline batches of tokens and labels, which carry no "
            f"{need[0]!r}: the {cfg.family} family ({cfg.name}) needs {need[0]!r} in every "
            f"batch; train it through make_train_step on api.make_batch batches")
    if dist.is_initialized():
        mesh = mesh or local_mesh()
        device = mesh.device
    else:
        device = resolve_device(device)
    tp = mesh.shape["model"] if mesh is not None else 1
    moe_ep = mesh is not None and cfg.family == "moe"
    step_fn = make_train_step(cfg, tp=tp, opt=AdamWConfig(lr=lr),
                              total_steps=max(steps, 10), mesh=mesh, moe_ep=moe_ep)
    # the full tree on the CPU (on the device outside a world)
    params = api.init(cfg, torch.Generator().manual_seed(seed), tp=tp,
                      device=device if mesh is None else "cpu")
    opt_state = adamw_init(params)
    step0 = 0

    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                    seed=seed))
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if resume and ckpt is not None and latest_step(ckpt_dir) is not None:
        restored = ckpt.restore({"params": params, "opt": opt_state})
        if restored is not None:
            tree, step0, extra = restored
            params, opt_state = tree["params"], tree["opt"]
            print(f"resumed from step {step0}")
    specs = None
    if mesh is not None:
        specs = param_layout(cfg, params, moe_ep=moe_ep)
        opt_specs = {"m": specs, "v": specs, "step": shd.P()}
        params = _to(shd.shard_tree(mesh, params, specs), device)
        opt_state = _to(shd.shard_tree(mesh, opt_state, opt_specs), device)
    writer = ckpt if mesh is None or dist.get_rank() == 0 else None

    def save(step: int) -> None:
        state = {"params": params, "opt": opt_state}
        if mesh is not None:       # every rank gathers, rank 0 writes
            state = shd.gather_tree(mesh, state, {"params": specs, "opt": opt_specs})
        if writer is not None:
            writer.save(step, state, extra={"next_data_index": step})

    history, metrics = [], []
    t0 = time.time()
    for i in range(step0, steps):
        t_step = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, data.batch_at(i))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])     # synchronises
        metrics.append({"step": i + 1, "loss": loss, "grad_norm": gnorm,
                        "ms": (time.perf_counter() - t_step) * 1e3})
        if (i + 1) % log_every == 0 or i == steps - 1:
            history.append((i + 1, loss))
            print(f"step {i+1:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"({(time.time()-t0)/max(1,i+1-step0):.2f}s/step)", flush=True)
        if ckpt is not None and (i + 1) % ckpt_every == 0:
            save(i + 1)
    if ckpt is not None:
        save(steps)
        if writer is not None:
            writer.wait()
    return {"history": history, "metrics": metrics, "params": params,
            "opt_state": opt_state, "specs": specs, "cfg": cfg}


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def _train_rank(kwargs: dict) -> dict:
    """One rank of the CLI's world: the last history line."""
    out = train(**kwargs)
    return {"history": out["history"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true", default=False)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    kwargs = dict(reduced=args.reduced, steps=args.steps, batch=args.batch, seq=args.seq,
                  ckpt_dir=args.ckpt_dir, resume=args.resume, ckpt_every=args.ckpt_every,
                  lr=args.lr)
    cards = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 0
    if cards > 1:
        history = spmd.run_spmd(_train_rank, cards, device="cuda",
                                args=(dict(kwargs, arch=args.arch),))[0]["history"]
    else:
        history = train(args.arch, device=args.device, **kwargs)["history"]
    losses = [l for _, l in history]
    if len(losses) >= 2 and losses[-1] < losses[0]:
        print(f"loss improved: {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
