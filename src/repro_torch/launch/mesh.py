"""Production mesh of the port (the reference's ``launch/mesh.py``).

Functions, not module-level constants.  Single-pod: 16x16 = 256 devices
("data", "model").  Multi-pod: 2x16x16 = 512 ("pod", "data", "model") — the
pod axis is pure DP.  :func:`production_plan` keeps the shapes and axis
names as a :class:`~repro_torch.runtime.fault_tolerance.MeshPlan`;
:func:`make_production_mesh` builds the
:class:`~repro_torch.parallel.spmd.Mesh`, which needs a world of exactly
that many ranks and raises :class:`ValueError` in any other.
"""
from __future__ import annotations

from ..runtime.fault_tolerance import MeshPlan, build_mesh


def production_plan(*, multi_pod: bool = False) -> MeshPlan:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshPlan(shape, axes)


def make_production_mesh(*, multi_pod: bool = False):
    return build_mesh(production_plan(multi_pod=multi_pod))
