"""Fault tolerance & elasticity of the port (the reference's
``runtime/fault_tolerance.py``).

* :class:`HeartbeatRegistry` — per-host liveness with deadline-based failure
  detection.
* :class:`StragglerPolicy` — per-step duration tracking; hosts persistently
  slower than ``threshold x`` the fleet median get flagged for exclusion.
* :class:`MeshPlan` / :func:`plan_elastic_mesh` — the largest usable
  (data, model) mesh from the surviving device count, TP kept fixed;
  :func:`build_mesh` builds it over the current world of ranks, and training
  resumes from the latest checkpoint, which holds the full (gathered) tree
  (``launch/train.py``).
* :func:`compressed_psum` — int8 quantize/dequantize gradient all-reduce
  with error feedback, for cross-pod DP links.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel import spmd


# ---------------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HeartbeatRegistry:
    deadline_s: float = 30.0
    _last: dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host: int, now: float) -> None:
        self._last[host] = now

    def dead_hosts(self, now: float) -> list[int]:
        return sorted(h for h, t in self._last.items() if now - t > self.deadline_s)

    def alive_hosts(self, now: float) -> list[int]:
        return sorted(h for h, t in self._last.items() if now - t <= self.deadline_s)


# ---------------------------------------------------------------------------
# stragglers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerPolicy:
    threshold: float = 1.5        # x fleet median
    window: int = 8               # consecutive slow steps before exclusion
    _history: dict[int, list[float]] = dataclasses.field(default_factory=dict)

    def record_step(self, host: int, duration_s: float) -> None:
        self._history.setdefault(host, []).append(duration_s)

    def stragglers(self) -> list[int]:
        if not self._history:
            return []
        lasts = {h: v[-self.window:] for h, v in self._history.items()}
        med = float(np.median([np.median(v) for v in lasts.values()]))
        out = []
        for h, v in lasts.items():
            if len(v) >= self.window and all(d > self.threshold * med for d in v):
                out.append(h)
        return sorted(out)


# ---------------------------------------------------------------------------
# elastic re-meshing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))


def plan_elastic_mesh(n_devices: int, *, model_parallel: int = 16,
                      pods: int | None = None) -> MeshPlan:
    """Largest usable mesh from the surviving device count.

    Keeps TP fixed (= model_parallel — resharding TP params across a
    different TP degree would change layouts); shrinks the data axis to the
    largest multiple that fits, dropping remainder devices.
    """
    if n_devices < model_parallel:
        raise ValueError(f"need >= {model_parallel} devices, have {n_devices}")
    if pods and pods > 1:
        per_pod = n_devices // pods
        data = per_pod // model_parallel
        if data < 1:
            raise ValueError("not enough devices per pod")
        return MeshPlan((pods, data, model_parallel), ("pod", "data", "model"))
    data = n_devices // model_parallel
    return MeshPlan((data, model_parallel), ("data", "model"))


def build_mesh(plan: MeshPlan) -> spmd.Mesh:
    """The plan's mesh over the current world of ranks (every rank calls
    it).  Raises :class:`ValueError` if the world has fewer ranks than the
    plan needs; a world with more must be re-formed at the plan's size (a
    rank holds no device it could leave out)."""
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    n = plan.n_devices
    if world < n:
        raise ValueError(f"plan needs {n} devices, have {world}")
    return spmd.Mesh(plan.shape, plan.axes)


# ---------------------------------------------------------------------------
# gradient compression (error-feedback int8)
# ---------------------------------------------------------------------------

def quantize_int8(x):
    scale = torch.clamp(torch.amax(torch.abs(x)), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum(grads, axis_name: str, error: dict | None = None):
    """int8-quantized psum with error feedback, over ``axis_name`` of the
    active mesh.

    Returns (mean_grads, new_error).  ``error`` carries the quantization
    residual to the next step (error feedback keeps the method unbiased over
    time).  As in the reference, the psum moves the dequantized float32
    values.
    """
    from ..optim.tree import tree_build, tree_items

    names, leaves = zip(*tree_items(grads))
    errs_in = dict(tree_items(error)) if error is not None else {}
    n = spmd.axis_size(axis_name)
    outs, errs = [], []
    for name, g in zip(names, leaves):
        gf = g.to(torch.float32)
        if name in errs_in:
            gf = gf + errs_in[name]
        q, scale = quantize_int8(gf)
        deq = dequantize_int8(q, scale)
        errs.append((name, gf - deq))
        summed = spmd.psum(deq, axis_name)
        outs.append((name, (summed / n).to(g.dtype)))
    return tree_build(outs), tree_build(errs)
