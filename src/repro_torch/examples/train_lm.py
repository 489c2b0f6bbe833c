"""End to end: train SmolLM-360M for a few hundred steps.

Exercises the full substrate: deterministic data pipeline, the train step
(AdamW, clipping, cosine schedule), asynchronous checkpointing, and
restart-resume — the "complete cross-compilation" limit of the paper's
spectrum where the whole step is one offloaded region (what
``mixed.trace(prog).plan("native")`` produces when no host-only ops block
it; see ``repro_torch.examples.quickstart`` for the staged frontend
itself).  On the card the step runs the training flash-attention kernels
(forward with statistics, dQ, dK/dV) and RMSNorm.

    PYTHONPATH=src python -m repro_torch.examples.train_lm            # SmolLM-360M uncut
    PYTHONPATH=src python -m repro_torch.examples.train_lm --tiny     # smoke (seconds)
    PYTHONPATH=src python -m repro_torch.examples.train_lm --tiny --device cpu
"""
from __future__ import annotations

import argparse
import sys
import tempfile

from ..core.api import resolve_device
from ..launch.train import train

ARCH = "smollm-360m"


def run(*, tiny: bool = False, steps: int | None = None, device=None,
        ckpt_dir: str | None = None, resume: bool = False,
        ckpt_every: int | None = None) -> dict:
    """Train as the example does; returns :func:`train`'s result plus
    ``losses`` (the logged losses).  ``ckpt_dir`` defaults to a temporary
    directory removed afterwards; ``resume`` continues from the newest
    checkpoint in it; ``ckpt_every`` defaults to ``max(20, steps // 4)``."""
    resolve_device(device)
    if tiny:
        reduced, default_steps, batch, seq = True, 30, 4, 64
    else:
        reduced, default_steps, batch, seq = False, 200, 8, 256
    steps = steps or default_steps
    if ckpt_dir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run(tiny=tiny, steps=steps, device=device, ckpt_dir=tmp,
                       resume=resume, ckpt_every=ckpt_every)
    out = train(ARCH, reduced=reduced, steps=steps, batch=batch, seq=seq,
                ckpt_dir=ckpt_dir, resume=resume,
                ckpt_every=ckpt_every or max(20, steps // 4),
                log_every=max(5, steps // 20), lr=1e-3, device=device)
    out["losses"] = [loss for _, loss in out["history"]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true", help="seconds-fast smoke run")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="device: omit for the CUDA card, 'cpu' for the CPU")
    args = ap.parse_args(argv)
    losses = run(tiny=args.tiny, steps=args.steps, device=args.device)["losses"]
    print(f"\nfinal loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    if losses[-1] >= losses[0]:
        print("WARNING: loss did not improve", file=sys.stderr)
        return 1
    print("loss improved — training substrate works end to end")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
