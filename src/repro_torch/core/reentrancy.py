"""Emulation reentrancy — host→guest callbacks.

Paper §3.3: offloaded host functions may call back into emulated code
(function pointers, non-offloaded callees), requiring nested guest↔host
transitions with consistent stacks.

In the eager torch host a unit is ordinary Python, so the callback is a
direct call: the operands are gathered to host memory, the interpreter is
re-entered (:class:`~repro_torch.core.emulator.Emulator` is re-entrant —
nested guest frames live on the host Python stack), and the interpreter may
itself *re-offload* (its router dispatches nested offloaded calls back to
compiled units), giving arbitrarily interleaved call chains — exactly the
paper's reentrancy structure.  The results are cast to the avals inferred by
abstract evaluation and placed back on the unit's device, preserving "stack"
(value) consistency at the boundary by construction.

Reentry channel tokens: offload units are *shared* across entry signatures
and concurrent serving sessions (see :class:`~repro_torch.core.offload.UnitCache`),
so a closure cannot identify the calling session.  The caller's identity
travels with the call instead: every unit takes a scalar ``token`` (an
int32 channel id) and ``reentry(token, callee, args)`` resolves it to the
in-flight call's context in a global registry.  This is the paper's per-call
reentry channel, kept as an explicit argument so the crossing accounting
matches the reference engine's.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .opset import AVal, canonical_dtype, numpy_dtype
from .program import Program, abstract_eval


def emit_guest_callback(
    reentry: Callable[[int, str, tuple], tuple],
    program: Program,
    callee: str,
    args: Sequence[torch.Tensor],
    token,
    device: torch.device,
) -> tuple:
    """Call back into the guest from inside a host region.

    ``reentry(token, callee, host_args)`` is provided by the engine: it
    resolves ``token`` to the in-flight call context, bumps its host→guest
    counter, and re-enters the (re-entrant) emulator.  The guest's results
    come back as tensors on ``device`` in the 32-bit dtypes of the callee's
    abstract result avals.
    """
    in_avals = tuple(AVal(tuple(map(int, a.shape)), numpy_dtype(a.dtype).name)
                     for a in args)
    out_avals, _ = abstract_eval(program, callee, in_avals)
    if any(type(a).__name__ == "DTensor" for a in args):   # a sharded unit's values
        from ..parallel.units import to_host

        args = [to_host(a) for a in args]
    outs = reentry(int(token), callee, tuple(a.cpu().numpy() for a in args))
    return tuple(
        torch.from_numpy(np.array(o, dtype=canonical_dtype(av.dtype))).to(device)
        for o, av in zip(outs, out_avals)
    )
