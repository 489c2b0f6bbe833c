"""The port's MoE layer against the reference's ``models/moe.py``.

Routing, capacity and the dispatch/combine of ``moe_block`` at the reduced
Granite MoE and DBRX configs (4 experts, top-2), with the reference's
weights carried across.  At capacity 1.25 with tokens crowding a few
experts, pairs are dropped: the kept pairs and their slots equal the
reference's (its top-k and exclusive running count, here run with a small
``chunk`` so that its blocked count is exercised) and the outputs agree in
float32 at rtol 2e-4 / atol 2e-5.  In bfloat16 the combine sums the k
contributions once, where the reference's scatter-add rounds after each, so
it is held to the bf16 rule of ROADMAP Queue 3: at most twice the
reference's own distance from its float32 output.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import api, moe

TP = 2
MOE = ["granite-moe-1b-a400m", "dbrx-132b"]
F32_TOL = dict(rtol=2e-4, atol=2e-5)


def _cfg(arch, capacity=1.25, dtype="float32"):
    c = reduced_config(arch)
    return dataclasses.replace(c, compute_dtype=dtype,
                               moe=dataclasses.replace(c.moe, capacity_factor=capacity))


def _jcfg(arch, capacity=1.25, dtype="float32"):
    from repro.configs import reduced_config as jreduced
    c = jreduced(arch)
    return dataclasses.replace(c, compute_dtype=dtype,
                               moe=dataclasses.replace(c.moe, capacity_factor=capacity))


def _layer(arch):
    """Layer 0's parameters: the reference's (jnp) and the port's."""
    import jax
    import jax.numpy as jnp
    from repro.models import api as japi

    tree = jax.tree_util.tree_map(np.asarray, japi.init(_jcfg(arch), jax.random.PRNGKey(0),
                                                        tp=TP))
    params = api.load_reference_params(_cfg(arch), tree, tp=TP, device="cpu")
    jlp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), tree["layers"])
    lp = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
          for k, v in params["layers"].items()}
    return jlp, lp


def _crowded(B=2, T=48, D=64, seed=0):
    """Tokens sharing one strong direction, so the router sends most of
    them to the same few experts and capacity 1.25 drops pairs."""
    rng = np.random.default_rng(seed)
    common = rng.standard_normal(D).astype(np.float32)
    return (3.0 * common + rng.standard_normal((B, T, D))).astype(np.float32)


def _reference_routing(jcfg, jlp, x, chunk):
    """The reference's top-k and exclusive running count (``moe_block``'s
    lines 60-84), in jnp, with its token blocks of ``chunk`` pairs."""
    import jax
    import jax.numpy as jnp
    from repro.models.moe import _capacity

    m = jcfg.moe
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    gates = jax.nn.softmax((xf @ jlp["router"]).astype(jnp.float32), axis=-1)
    _, top_i = jax.lax.top_k(gates, m.top_k)
    flat_e = top_i.reshape(-1)
    blocks = flat_e.reshape(-1, chunk)
    carry = jnp.zeros((m.num_experts,), jnp.int32)
    pos = []
    for eblk in blocks:
        oh = jax.nn.one_hot(eblk, m.num_experts, dtype=jnp.int32)
        within = jnp.cumsum(oh, axis=0) - oh
        pos.append(jnp.take_along_axis(within, eblk[:, None], axis=1)[:, 0]
                   + jnp.take(carry, eblk))
        carry = carry + jnp.sum(oh, axis=0)
    slot = jnp.concatenate(pos).reshape(top_i.shape)
    return np.asarray(top_i), np.asarray(slot), np.asarray(slot < _capacity(jcfg, xf.shape[0]))


@pytest.mark.parametrize("arch", MOE)
def test_kept_pairs_and_slots_equal_reference_at_capacity_1_25(arch):
    jlp, lp = _layer(arch)
    x = _crowded()
    cfg, jcfg = _cfg(arch), _jcfg(arch)
    want_e, want_slot, want_keep = _reference_routing(jcfg, jlp, x, chunk=16)
    _, top_i, slot, keep = moe.route(cfg, lp, torch.from_numpy(x).reshape(-1, x.shape[-1]))
    assert (~want_keep).sum() > 0, "the crowded tokens must overflow some expert"
    np.testing.assert_array_equal(top_i.numpy(), want_e)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_array_equal(keep.numpy(), want_keep)


@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_reference_with_drops(arch):
    import jax.numpy as jnp
    from repro.models.moe import moe_block as jmoe_block

    jlp, lp = _layer(arch)
    x = _crowded(seed=1)
    want = jmoe_block(_jcfg(arch), jlp, jnp.asarray(x), chunk=16)
    got = moe.moe_block(_cfg(arch), lp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # the dropped pairs matter: the same block at capacity 4.0 differs
    full = moe.moe_block(_cfg(arch, capacity=4.0), lp, torch.from_numpy(x))
    assert not np.allclose(full.numpy(), got.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("arch", MOE)
def test_moe_block_bfloat16_within_the_bf16_rule(arch):
    import jax.numpy as jnp
    from repro.models.moe import moe_block as jmoe_block

    jlp, lp = _layer(arch)
    x = _crowded(seed=2)
    exact = np.asarray(jmoe_block(_jcfg(arch), jlp, jnp.asarray(x)))
    want = np.asarray(jmoe_block(_jcfg(arch, dtype="bfloat16"), jlp,
                                 jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = moe.moe_block(_cfg(arch, dtype="bfloat16"), lp,
                        torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    own = got.to(torch.float32).numpy()
    assert np.abs(own - exact).max() <= 2 * np.abs(want - exact).max()


def test_moe_matches_dense_mixture_at_high_capacity():
    """With capacity >= tokens * top_k / E, capacity routing is exact: it
    equals the explicit weighted mixture of the expert MLPs (the port of
    ``tests/test_models.py``'s test)."""
    cfg = dataclasses.replace(
        reduced_config("dbrx-132b"), compute_dtype="float32",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32, capacity_factor=4.0))
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    lp = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
          for k, v in params["layers"].items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, cfg.d_model))
                         .astype(np.float32))
    got = moe.moe_block(cfg, lp, x)

    xf = x.reshape(-1, cfg.d_model)
    gates = torch.softmax(xf @ lp["router"], dim=-1)
    top_v, top_i = torch.topk(gates, 2)
    top_v = top_v / top_v.sum(dim=-1, keepdim=True)
    w = lp["experts"]
    ys = torch.stack([(torch.nn.functional.silu(xf @ w["wg"][e]) * (xf @ w["wu"][e]))
                      @ w["wd"][e] for e in range(4)], dim=1)      # (N, E, D)
    want = sum(top_v[:, j:j + 1] * ys[torch.arange(xf.shape[0]), top_i[:, j]]
               for j in range(2))
    np.testing.assert_allclose(got.reshape(-1, cfg.d_model).numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_tokens", [1, 8, 100, 1000, 4096])
@pytest.mark.parametrize("capacity", [1.25, 4.0])
def test_capacity_equals_reference(n_tokens, capacity):
    from repro.models.moe import _capacity

    for arch in MOE:
        assert moe._capacity(_cfg(arch, capacity), n_tokens) == \
            _capacity(_jcfg(arch, capacity), n_tokens)


def test_equal_gates_keep_the_lower_expert_first():
    """Ties (common with bf16 router logits) break as ``lax.top_k`` breaks
    them: the lower expert first."""
    import jax
    import jax.numpy as jnp

    cfg = _cfg("granite-moe-1b-a400m")
    _, lp = _layer("granite-moe-1b-a400m")
    lp = dict(lp, router=torch.zeros_like(lp["router"]))
    xf = torch.from_numpy(np.random.default_rng(3).standard_normal((5, cfg.d_model))
                          .astype(np.float32))
    top_v, top_i, slot, keep = moe.route(cfg, lp, xf)
    _, want = jax.lax.top_k(jnp.full((5, cfg.moe.num_experts), 0.25), cfg.moe.top_k)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(want))
    np.testing.assert_array_equal(top_v.numpy(), np.full((5, 2), 0.5, np.float32))
    np.testing.assert_array_equal(slot.numpy(), np.repeat(np.arange(5)[:, None], 2, 1))


def test_dispatch_places_kept_pairs_and_drops_the_rest():
    xf = torch.arange(12, dtype=torch.float32).reshape(4, 3)      # 4 tokens, D = 3
    # pairs (token, k): experts and slots; pair 5 dropped (row E = 2)
    e_flat = torch.tensor([0, 1, 1, 0, 0, 2, 1, 0])
    s_flat = torch.tensor([0, 0, 1, 1, 2, 0, 2, 3])
    xe = moe.dispatch(xf, e_flat, s_flat, 2, 4)
    assert tuple(xe.shape) == (2, 4, 3)
    want = torch.zeros(2, 4, 3)
    for p, (e, s) in enumerate(zip(e_flat.tolist(), s_flat.tolist())):
        if e < 2:
            want[e, s] = xf[p // 2]
    assert torch.equal(xe, want)


def test_combine_sums_the_kept_contributions():
    he = torch.arange(2 * 3 * 2, dtype=torch.float32).reshape(2, 3, 2)   # E=2, C=3, D=2
    e_flat = torch.tensor([0, 1, 2, 0])          # token 1's first pair dropped
    s_flat = torch.tensor([0, 2, 0, 1])
    keep = torch.tensor([[True, True], [False, True]])
    top_v = torch.tensor([[0.25, 0.75], [0.5, 0.5]])
    got = moe.combine(he, e_flat, s_flat, keep, top_v)
    want = torch.stack([0.25 * he[0, 0] + 0.75 * he[1, 2], 0.5 * he[0, 1]])
    assert torch.equal(got, want)
