"""Sequence-parallel decode at a global batch of 1 (the ``long_500k`` cells'
layout) on gloo worlds on the CPU, and row 2's log-sum-exp output.

At a global batch of 1 the reference's ``cache_pspecs`` splits the
attention caches' sequence over the data axes and keeps the recurrent
states replicated there.  The port's decode step takes that layout: the
rank whose slice holds ``pos`` writes the new k/v row, each rank attends
over its slice and the ranks fold their (o, log-sum-exp) partials
(``models/layers.py:decode_attend``).  Reduced Zamba2 (its shared attention
block) and xLSTM (replicated states only) decode from a one-rank prefill of
5 tokens through 6 steps that cross the ranks' boundary at position 8, on
(data 2) and (data 2, model 2), against the reference's unsharded
``decode_step`` at the engine's 2e-3/2e-4; the gathered cache equals the
reference's.  Also: ``decode_attention_plain``'s log-sum-exp against a
float64 logsumexp, two halves folded against the whole, the refusal of a
train or prefill batch of 1 on data ranks, and xLSTM on (data 1, model 4),
where the sLSTM's 2 heads split into slices whose h is gathered every step
(gradients and a decode step against one rank).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.launch.steps import (local_batch, loss_and_grads, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.optim.tree import tree_items
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import spmd

TP = 2
ARCHS = ["zamba2-2.7b", "xlstm-350m"]
CACHE, PROMPT, STEPS = 16, 5, 6          # data 2: slices [0, 8) and [8, 16)
MESHES = {2: [(2, 1)], 4: [(2, 2)]}


def _cfg(arch):
    return dataclasses.replace(reduced_config(arch), compute_dtype="float32")


def _tokens(cfg):
    return np.random.default_rng(3).integers(0, cfg.vocab, (1, PROMPT + STEPS), dtype=np.int32)


def _reference_init(arch):
    import jax
    from repro.configs import reduced_config as jreduced
    from repro.models import api as japi

    tree = japi.init(jreduced(arch), jax.random.PRNGKey(0), tp=TP)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _reference(arch, tree):
    """The reference's unsharded prefill and decode steps: each step's
    logits and the final cache's leaves."""
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced
    from repro.models import api as japi

    jcfg = dataclasses.replace(jreduced(arch), compute_dtype="float32")
    toks = _tokens(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    cache = japi.init_cache(jcfg, 1, CACHE, tp=TP)
    _, cache = japi.prefill(jcfg, params, {"tokens": toks[:, :PROMPT]}, cache, tp=TP,
                            q_block=8)
    logits = []
    for t in range(PROMPT, PROMPT + STEPS):
        lg, cache = japi.decode(jcfg, params, cache, {"token": toks[:, t:t + 1]}, tp=TP)
        logits.append(np.asarray(lg))
    return logits, dict(tree_items(jax.tree_util.tree_map(np.asarray, cache)))


def _one_rank_prefill(cfg, tree):
    params = api.load_reference_params(cfg, tree, tp=TP, device="cpu")
    cache = api.init_cache(cfg, 1, CACHE, tp=TP, device="cpu")
    with torch.no_grad():
        _, cache = api.prefill(cfg, params, {"tokens": _tokens(cfg)[:, :PROMPT]}, cache, tp=TP)
    return params, cache


def _decode_on(mesh, arch, tree):
    """Decode STEPS tokens at batch 1 on ``mesh`` from the one-rank prefill:
    each step's logits (gathered over model) and the gathered final cache."""
    cfg = _cfg(arch)
    params, cache = _one_rank_prefill(cfg, tree)
    specs = shd.param_pspecs(cfg, params)
    shape = ShapeConfig("d", "decode", CACHE, 1)
    cspecs = shd.cache_pspecs(cfg, shape, mesh, cache)
    local_params = shd.shard_tree(mesh, params, specs)
    local_cache = shd.shard_tree(mesh, cache, cspecs)
    step = make_decode_step(cfg, tp=TP, mesh=mesh)
    toks, logits = _tokens(cfg), []
    with torch.no_grad():
        for t in range(PROMPT, PROMPT + STEPS):
            lg, local_cache = step(local_params, local_cache, {"token": toks[:, t:t + 1]})
            full = shd.gather_tree(mesh, {"l": lg}, {"l": shd.P(None, None, "model")})["l"]
            logits.append(full.numpy())
    cache = shd.gather_tree(mesh, local_cache, cspecs)
    return {"logits": logits, "cache": {k: v.numpy() for k, v in tree_items(cache)},
            "local_ak": (tuple(local_cache["ak"].shape) if "ak" in local_cache else None)}


def _fold_check():
    """Each rank's half of a cache, attended and folded over ``data``."""
    mesh = spmd.Mesh((2,), ("data",))
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 4, 1, 16, generator=g)
    k, v = torch.randn(2, 2, 24, 16, generator=g), torch.randn(2, 2, 24, 16, generator=g)
    out = {}
    r = mesh.axis_index("data")
    for pos in (3, 11, 12, 17, 23, -1):
        lpos = torch.tensor(max(-1, min(pos - 12 * r, 11)), dtype=torch.int32)
        o, lse = decode_attention_plain(q, k[:, :, 12 * r:12 * r + 12],
                                        v[:, :, 12 * r:12 * r + 12], lpos, return_lse=True)
        with mesh:
            out[pos] = (L.fold_partials(o, lse, ("data",)).numpy(),
                        decode_attention_plain(q, k, v, torch.tensor(pos)).numpy())
    return out


def _xlstm_split_heads(tree):
    """xLSTM on (data 1, model 4): the sLSTM's 2 heads of 32 split into
    slices of 16, h gathered every step."""
    cfg = _cfg("xlstm-350m")
    mesh = spmd.Mesh((1, 4), ("data", "model"))
    params = api.load_reference_params(cfg, tree, tp=TP, device="cpu")
    specs = shd.param_pspecs(cfg, params)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 9), dtype=np.int32)
    batch = {"tokens": toks[:, :8], "labels": toks[:, 1:]}
    loss, grads = loss_and_grads(cfg, shd.shard_tree(mesh, params, specs), batch, tp=TP,
                                 mesh=mesh)
    grads = {k: v.numpy() for k, v in tree_items(shd.gather_tree(mesh, grads, specs))}
    cache = api.init_cache(cfg, 2, 16, tp=TP, device="cpu")
    cspecs = shd.cache_pspecs(cfg, ShapeConfig("d", "decode", 16, 2), mesh, cache)
    local = shd.shard_tree(mesh, params, specs)
    with torch.no_grad():
        _, c = make_prefill_step(cfg, tp=TP, mesh=mesh)(
            local, {"tokens": toks[:, :8]}, shd.shard_tree(mesh, cache, cspecs))
        lg, _ = make_decode_step(cfg, tp=TP, mesh=mesh)(local, c, {"token": toks[:, 8:9]})
    lg = shd.gather_tree(mesh, {"l": lg}, {"l": shd.P("data", None, "model")})["l"]
    return {"loss": float(loss), "grads": grads, "decode": lg.numpy()}


def _refusal(cfg, mesh, batch, kind):
    with pytest.raises(ValueError) as e:
        local_batch(cfg, mesh, batch, kind)
    return str(e.value)


def _rank(trees):
    world = torch.distributed.get_world_size()
    out = {}
    for shape in MESHES[world]:
        mesh = spmd.Mesh(shape, ("data", "model"))
        for arch in ARCHS:
            out[(shape, arch)] = _decode_on(mesh, arch, trees[arch])
    if world == 2:
        out["fold"] = _fold_check()
        mesh = spmd.Mesh((2, 1), ("data", "model"))
        cfg = _cfg("zamba2-2.7b")
        batch = {"tokens": _tokens(cfg)[:, :PROMPT], "labels": _tokens(cfg)[:, 1:PROMPT + 1]}
        out["refusals"] = [_refusal(cfg, mesh, batch, kind) for kind in ("train", "prefill")]
    else:
        out["split_heads"] = _xlstm_split_heads(trees["xlstm-350m"])
    return out


@pytest.fixture(scope="module")
def worlds():
    trees = {arch: _reference_init(arch) for arch in ARCHS}
    ranks = {n: spmd.run_spmd(_rank, n, device="cpu", args=(trees,), timeout=300)
             for n in MESHES}
    refs = {arch: _reference(arch, trees[arch]) for arch in ARCHS}
    return trees, ranks, refs


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["data2", "data2-model2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_one_decode_equals_the_reference(worlds, arch, shape):
    _, ranks, refs = worlds
    want_logits, want_cache = refs[arch]
    for r in ranks[math.prod(shape)]:
        got = r[(shape, arch)]
        for g, w in zip(got["logits"], want_logits):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4)
        assert sorted(got["cache"]) == sorted(want_cache)
        for name, w in want_cache.items():
            np.testing.assert_allclose(got["cache"][name], w, rtol=2e-3, atol=2e-4,
                                       err_msg=name)
        if arch == "zamba2-2.7b":      # each data rank held half the sequence
            assert got["local_ak"][2] == CACHE // 2


def test_decode_attention_lse_matches_float64():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 6, 1, 16, generator=g)
    k, v = torch.randn(2, 3, 20, 16, generator=g), torch.randn(2, 3, 20, 16, generator=g)
    for pos in (0, 7, 19, 30):
        o, lse = decode_attention_plain(q, k, v, torch.tensor(pos), return_lse=True)
        assert o.shape == (2, 6, 1, 16) and lse.shape == (2, 6) and lse.dtype == torch.float32
        kk = torch.repeat_interleave(k.double(), 2, dim=1)[:, :, :pos + 1]
        s = (q.double() @ kk.transpose(-1, -2))[:, :, 0] / 4.0
        np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_array_equal(o.numpy(), decode_attention_plain(
            q, k, v, torch.tensor(pos)).numpy())
    o, lse = decode_attention_plain(q, k, v, -1, return_lse=True)
    assert torch.all(o == 0) and torch.all(torch.isneginf(lse))


def test_folded_halves_equal_the_whole(worlds):
    """Positions in the first half, on and past the boundary, the last, and
    none (-1: exact zeros on both ranks)."""
    _, ranks, _ = worlds
    for r in ranks[2]:
        for pos, (folded, whole) in r["fold"].items():
            np.testing.assert_allclose(folded, whole, rtol=1e-5, atol=1e-6, err_msg=str(pos))
            if pos < 0:
                assert np.all(folded == 0)


def test_train_and_prefill_refuse_a_batch_of_one_on_data_ranks(worlds):
    _, ranks, _ = worlds
    for r in ranks[2]:
        assert [e.split(" batch of 1")[0] for e in r["refusals"]] == ["a train", "a prefill"]


def test_xlstm_splits_slstm_heads_across_model_ranks(worlds):
    trees, ranks, _ = worlds
    cfg = _cfg("xlstm-350m")
    params = api.load_reference_params(cfg, trees["xlstm-350m"], tp=TP, device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 9), dtype=np.int32)
    loss, grads = loss_and_grads(cfg, params, {"tokens": toks[:, :8], "labels": toks[:, 1:]},
                                 tp=TP)
    cache = api.init_cache(cfg, 2, 16, tp=TP, device="cpu")
    with torch.no_grad():
        _, cache = api.prefill(cfg, params, {"tokens": toks[:, :8]}, cache, tp=TP)
        want, _ = api.decode(cfg, params, cache, {"token": toks[:, 8:9]}, tp=TP)
    for r in ranks[4]:
        got = r["split_heads"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
        for name, g in tree_items(grads):
            w = g.numpy()
            assert np.all(np.abs(got["grads"][name] - w) <= 1e-4 * np.abs(w).max() + 1e-30), name
        np.testing.assert_allclose(got["decode"], want.numpy(), rtol=1e-5, atol=1e-5)
