"""Fig. 7 analogue: the technique on a second program class.

The paper's Fig. 7 repeats the evaluation in the other emulation direction
(AArch64-on-x86-64) to show low sensitivity to the guest/host pairing.  Our
guest/host pair is an execution-model pair (interpreter/accelerator), so the
corresponding robustness axis is the *program class*: instead of the
numeric-kernel workloads, we run exported FRAMEWORK MODEL programs (reduced
dense LMs with a host-side safety check in the hot path) through the same
scheme ablation.  Consistent speedup ordering across both program classes
is the analogue of the paper's consistent cross-direction results.

On the card the programs' ``rmsnorm`` and ``sdpa`` ops run the RMSNorm and
float32 flash-attention kernels inside the offload units.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs import reduced_config
from ..models import api, programs
from .common import SCHEMES, SchemeRun, csv_row, geomean, sweep_schemes

MODEL_ARCHS = ["smollm-360m", "llama3.2-1b"]
BATCH = 2
TP = 2          # the reference's head plan: plan_heads(4, 2, 2) admits it


def seq_len(scale: str) -> int:
    return 128 if scale == "bench" else 32


def model_program(arch: str, batch: int = BATCH, seq: int = 64, *, seed: int = 0):
    """A reduced dense LM exported as a Program: float32, d_model 128,
    4 layers, weights drawn from a seeded generator."""
    cfg = dataclasses.replace(
        reduced_config(arch), compute_dtype="float32",
        d_model=128, d_ff=256, n_layers=4)
    params = api.init(cfg, torch.Generator().manual_seed(seed), tp=TP, device="cpu")
    return programs.export_dense_forward(cfg, params, batch=batch, seq=seq, tp=TP)


def sweep(scale: str = "bench", *, device=None, repeats: int = 3,
          archs=None) -> dict[str, dict[str, SchemeRun]]:
    out = {}
    for arch in archs or MODEL_ARCHS:
        prog, args = model_program(arch, seq=seq_len(scale))
        out[arch] = sweep_schemes(prog, args, repeats=repeats, device=device)
    return out


def rows(sweeps: dict[str, dict[str, SchemeRun]]) -> list[str]:
    out = []
    per_scheme = {s: [] for s in SCHEMES[2:]}
    for arch, res in sweeps.items():
        t_qemu = res["qemu"].seconds
        for scheme in SCHEMES:
            run = res[scheme]
            secs = run.seconds
            sp = t_qemu / secs if np.isfinite(secs) and secs > 0 else float("nan")
            if scheme in per_scheme and np.isfinite(sp):
                per_scheme[scheme].append(sp)
            derived = (f"speedup_vs_qemu={sp:.3f}" if np.isfinite(sp)
                       else "native_infeasible(host_check)")
            if scheme in ("tech", "tech-gf", "tech-gfp") and run.infeasible is None:
                derived += f";g2h={run.steady.guest_to_host}"
            out.append(csv_row(f"fig7/{arch}/{scheme}", secs * 1e6, derived))
    for scheme, sp in per_scheme.items():
        out.append(csv_row(f"fig7/geomean/{scheme}", float("nan"),
                           f"geomean_speedup={geomean(sp):.3f}"))
    return out


def run(scale: str = "bench", *, device=None):
    return rows(sweep(scale, device=device))


if __name__ == "__main__":
    for r in run():
        print(r)
