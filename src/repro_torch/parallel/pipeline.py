"""Pipeline parallelism (GPipe-style) of the port (the reference's
``parallel/pipeline.py``).

Each rank on the pipeline axis holds its stage's layer stack; microbatches
stream through a slot that :func:`~repro_torch.parallel.spmd.ppermute`
rotates to the next stage between ticks.  For S stages and M microbatches
the schedule runs M + S − 1 ticks (the GPipe bubble: (S−1)/(M+S−1) idle).
Stage 0 ingests microbatch t at tick t; the last stage retires microbatch
t − S + 1; a masked psum replicates the outputs.

The schedule is differentiable through the autograd collectives (ppermute's
transpose is the inverse permutation), so the backward pass is the reverse
pipeline.  Every rank runs the same sequence of operations and collectives,
choosing by ``torch.where`` masks where the reference's ``jnp.where`` does,
so their backward passes issue the same collectives in the same order.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..optim.tree import tree_map
from . import spmd


def pipeline_apply(stage_fn: Callable, stage_params, x_micro, *, mesh, axis: str = "pod"):
    """Run microbatches through a pipeline of stages over a mesh axis.

    stage_fn(params_slice, h) -> h : one stage's computation (same shape).
    stage_params: this rank's stage, the leading stage axis of the
      reference's (S, ...) tree cut to 1 (``shard_tree`` by ``P(axis)``).
    x_micro: (M, mb, ...) microbatched input, replicated over ``axis``.
    Returns (M, mb, ...) outputs (as produced by the last stage), replicated
    over ``axis``.
    """
    S = mesh.shape[axis]
    M = x_micro.shape[0]
    with mesh:
        params_me = tree_map(lambda a: a[0], stage_params)
        stage_id = mesh.axis_index(axis)
        first = torch.tensor(stage_id == 0, device=x_micro.device)
        last = torch.tensor(stage_id == S - 1, device=x_micro.device)
        xs = spmd.enter(x_micro, axis)
        slot = torch.zeros_like(xs[0])
        outs = [torch.zeros_like(xs[0]) for _ in range(M)]
        perm = [(i, (i + 1) % S) for i in range(S)]
        for t in range(M + S - 1):
            # stage 0 ingests microbatch t (while t < M); others use the slot
            h_in = torch.where(first, xs[min(t, M - 1)], slot)
            h_out = stage_fn(params_me, h_in)
            # the last stage retires microbatch t - S + 1 when valid
            retire = t - (S - 1)
            if retire >= 0:
                outs[retire] = torch.where(last, h_out, outs[retire])
            # rotate activations to the next stage (not after the last tick)
            if t < M + S - 2:
                slot = spmd.ppermute(h_out, axis, perm)
        # only the last stage holds real outputs; replicate via a masked psum
        out = torch.where(last, torch.stack(outs), 0.0)
        return spmd.psum_replicated(out, axis)


def stage_split(params_stacked, n_stages: int):
    """Reshape (L, ...) stacked layer params into (S, L/S, ...) stages."""
    def split(a):
        L = a.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])

    return tree_map(split, params_stacked)
