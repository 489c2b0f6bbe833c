"""Calling conversion — the guest↔host "ABI" bridge.

Guest side ("emulated"): values are host numpy arrays.
Host side ("native"):   values are torch tensors on the unit's
:class:`torch.device`, dtype-cast to the host function's compute dtype and
narrowed to 32-bit types (:func:`~repro_torch.core.opset.canonical_dtype`):
float64 arrives as float32 and int64 as int32, the same placement rule the
32-bit reference engine applies to every argument and global.

A :class:`ConversionPlan` is the analogue of the paper's per-function stub
metadata: the argument marshaling recipe (shapes/dtypes/device), the output
un-marshaling recipe, and the *staged globals* (device-resident copies of
the program constants the offloaded unit references — the paper's "global
references propagated to the host side").

Building a plan is deliberately real work (aval resolution and the device
placement of every global).  The baseline scheme rebuilds it on every
crossing; the GRT caches it (see :mod:`repro_torch.core.grt`).

Under a mesh (a :class:`~repro_torch.parallel.spmd.Mesh`, every rank of the
world running the same guest program) the host side is a DTensor per value
(:mod:`repro_torch.parallel.units`): ``convert_in`` keeps this rank's shard
of each argument by its spec (``None``: replicated), the staged globals are
replicated, and ``convert_out`` gives every rank the full value.

A guest value may also be a :class:`Resident`: a handle on a tensor that
already lives on the unit's device (the paper's calling channel carrying a
reference, not the bytes, as the staged globals do).  ``convert_in`` hands
the tensor over as it is; nothing copies it back to the guest, which can
only pass it on to another unit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from .opset import AVal, canonical_dtype, numpy_dtype
from .program import Program


class Resident:
    """A guest value that is a tensor already on a unit's device.

    The tensor is in its canonical 32-bit dtype; the handle shows the guest
    its ``shape``, numpy ``dtype`` and ``nbytes``, so its aval (and every
    signature it is part of) equals that of a numpy array of the same shape.
    A crossing passes it to the unit by reference; a guest leaf op given one
    raises, and so does any attempt to read it as a numpy array.
    """

    __slots__ = ("tensor", "dtype")

    def __init__(self, tensor: torch.Tensor):
        dtype = numpy_dtype(tensor.dtype)
        if canonical_dtype(dtype) != dtype:
            raise TypeError(f"a resident value is held in its canonical dtype "
                            f"{canonical_dtype(dtype)}, not {dtype}")
        self.tensor = tensor
        self.dtype = dtype

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.tensor.shape)

    @property
    def nbytes(self) -> int:
        return self.tensor.nbytes

    @property
    def device(self) -> torch.device:
        return self.tensor.device

    def __array__(self, *args, **kwargs):
        raise TypeError(f"a resident {self.dtype}{list(self.shape)} on {self.device} "
                        f"is never copied back to the guest")

    def __repr__(self) -> str:
        return f"Resident({self.dtype}{list(self.shape)} on {self.device})"


def aval_of(x) -> AVal:
    if isinstance(x, Resident):
        return AVal(x.shape, str(x.dtype))
    a = np.asarray(x)
    return AVal(tuple(a.shape), str(a.dtype))


def signature_of(args: Sequence[Any]) -> tuple[AVal, ...]:
    """Canonical entry-signature key: one AVal per positional argument.

    This is the cache key of the staged API's signature-polymorphic plan
    cache (:class:`repro_torch.core.api.CompiledHybrid`) — two argument lists
    with the same shapes and dtypes share one offload plan and executor state.
    """
    return tuple(aval_of(a) for a in args)


def place(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Guest array → tensor on ``device`` in its canonical 32-bit dtype."""
    a = np.asarray(a)
    dt = canonical_dtype(a.dtype)
    # a contiguous, writable array is shared with the tensor as-is (no copy
    # on the CPU); anything else gets one host copy first
    a = np.require(a.astype(dt, copy=False), requirements=("C", "W"))
    return torch.from_numpy(a).to(device)


@dataclasses.dataclass
class ConversionPlan:
    fname: str
    arg_avals: tuple[AVal, ...]
    out_avals: tuple[AVal, ...]
    global_names: tuple[str, ...]
    staged_globals: tuple[torch.Tensor, ...]   # device tensors (DTensors under a mesh)
    device: torch.device
    compute_dtype: str | None                  # cast floating args on entry
    mesh: Any = None                           # spmd.Mesh of a sharded unit
    in_specs: tuple | None = None              # a spec (or None) per arg under a mesh

    # -- marshaling ---------------------------------------------------------

    def convert_in(self, args: Sequence[np.ndarray | Resident]) -> tuple[torch.Tensor, ...]:
        """Guest → host: cast + place every argument on the unit's device
        (under a mesh: this rank's shard of it, as a DTensor).  A
        :class:`Resident` argument on the unit's device is passed as it is;
        one on another device, one in another float dtype than the unit
        computes in, or one under a mesh raises."""
        out = []
        for i, a in enumerate(args):
            if isinstance(a, Resident):
                if self.mesh is not None:
                    raise ValueError(f"{self.fname}: a resident argument cannot cross "
                                     f"to a unit sharded over {self.mesh}")
                if a.device != self.device:
                    raise ValueError(f"{self.fname}: {a!r} cannot cross to a unit on "
                                     f"{self.device}: it is passed by reference only")
                if (self.compute_dtype is not None
                        and np.issubdtype(a.dtype, np.floating)
                        and a.dtype != np.dtype(self.compute_dtype)):
                    raise ValueError(f"{self.fname}: {a!r} is not in the unit's "
                                     f"compute dtype {self.compute_dtype}")
                out.append(a.tensor)
                continue
            a = np.asarray(a)
            if (
                self.compute_dtype is not None
                and np.issubdtype(a.dtype, np.floating)
                and a.dtype != np.dtype(self.compute_dtype)
            ):
                a = a.astype(self.compute_dtype)
            t = place(a, self.device)
            if self.mesh is not None:
                from ..parallel.units import to_mesh

                t = to_mesh(self.mesh, t, self.in_specs[i] if self.in_specs else None)
            out.append(t)
        return tuple(out)

    def convert_out(self, outs: Sequence[torch.Tensor]) -> tuple[np.ndarray, ...]:
        """Host → guest: gather to host memory (blocking: the copy waits for
        the device stream).  Always a fresh array, never a view of a guest
        input that the unit passed through (on the CPU a tensor and its
        numpy array share memory).  Under a mesh every rank gets the full
        value."""
        if self.mesh is not None:
            from ..parallel.units import to_host

            outs = [to_host(o) for o in outs]
        return tuple(o.to("cpu", copy=True).numpy() for o in outs)


def stage_globals(program: Program, names: Sequence[str], device: torch.device,
                  mesh=None) -> tuple:
    """Place every referenced program constant on ``device``, replicated
    over ``mesh`` when given (the GRT caches this)."""
    staged = tuple(place(program.constants[n], device) for n in names)
    if mesh is None:
        return staged
    from ..parallel.units import to_mesh

    return tuple(to_mesh(mesh, t) for t in staged)


def build_plan(
    program: Program,
    fname: str,
    arg_avals: tuple[AVal, ...],
    out_avals: tuple[AVal, ...],
    global_names: tuple[str, ...],
    *,
    device: torch.device,
    compute_dtype: str | None = None,
    mesh=None,
    arg_specs: Sequence | None = None,
) -> ConversionPlan:
    """Construct the full calling-conversion recipe for one offload unit.

    This is the work GRT amortizes: aval validation and the device staging
    of globals both happen here.  Under ``mesh`` the arguments are placed
    by ``arg_specs`` (one spec or ``None`` per argument; omitted: all
    replicated) and the globals replicated.
    """
    # validate avals (the paper's "correct parameter delivery" requirement)
    for i, a in enumerate(arg_avals):
        if any(d < 0 for d in a.shape):
            raise ValueError(f"{fname}: bad aval for arg {i}: {a}")
    if arg_specs is not None and len(arg_specs) != len(arg_avals):
        raise ValueError(f"{fname}: {len(arg_specs)} arg_specs for {len(arg_avals)} args")
    staged = stage_globals(program, global_names, device, mesh)
    return ConversionPlan(
        fname=fname,
        arg_avals=tuple(arg_avals),
        out_avals=tuple(out_avals),
        global_names=tuple(global_names),
        staged_globals=staged,
        device=device,
        compute_dtype=compute_dtype,
        mesh=mesh,
        in_specs=tuple(arg_specs) if mesh is not None and arg_specs is not None else None,
    )
