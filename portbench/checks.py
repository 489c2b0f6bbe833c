"""The comparisons that decide ``correct``, and the lower precision that
their control runs in.

Every number compared is worst-case over the answers checked, and is held
to a limit of its own in the configuration's ``check.limits``.
"""
from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits (to nearest, ties to even): the
    operands a TF32 tensor-core product reads.  The control computes the
    reference's products on operands rounded so, on any device."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def logit_gap(ref: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which a chosen token's reference logit lies below
    the reference's best at its position; ``ref`` (n, vocab), ``tokens``
    (n,).  0 when every token is the reference's greedy choice."""
    best = ref.max(dim=-1).values
    chosen = ref.gather(-1, tokens.long().view(-1, 1)).squeeze(-1)
    return float((best - chosen).max())


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max())

