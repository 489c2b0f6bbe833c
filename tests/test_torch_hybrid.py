"""The port's hybrid family (Zamba2: Mamba2 layers + a shared attention
block) against the reference package.

``reduced_config("zamba2-2.7b")`` (4 Mamba2 layers, the shared block every
2, d_model 64, N 16, chunk 16), with the reference's weights from
``repro.models.api.init(cfg, PRNGKey(0), tp=2)`` carried across by
``load_reference_params`` (norm scales, ``A_log``, ``D`` and ``dt_bias``
perturbed first, so every parameter matters).  Teacher-forcing logits,
prefill and decode agree with the reference's: float32 at rtol 2e-4 / atol
2e-5, bfloat16 at 2e-2.  The port's own decode reproduces its teacher
forcing (``tests/test_models.py``'s 5e-3 contract), and greedy generation
gives the reference's tokens.  On the CPU the SSD scan, attention cores and
norms run the kernels' plain versions; on the card (``gpu``) the kernels
themselves.  The reference package is imported inside the tests that use
it, so the ``gpu`` case also runs without JAX.

bfloat16 and SiLU.  XLA on the CPU expands the reference's bf16
``jax.nn.silu`` into exp, add, divide and multiply, each rounded to bf16
(the HLO of ``jax.nn.silu``); the port's ``F.silu`` rounds once.  The
reduced hybrid amplifies that one-ulp difference to 0.042 in the logits,
while the reference's own bf16 logits lie 0.069 from its float32 ones (at
T=37).  So the bf16 comparisons run the port with SiLU rounded as the
reference's is (``xla_silu``), which leaves the port's own type flow to be
checked at 2e-2; the port's own bf16 logits are held to lie about as far
from the float32 answer as the reference's do.  As in the dense family's
tests, the caches are compared in float32.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels.decode_attention import decode_attention_kernel
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.rmsnorm import rmsnorm_kernel
from repro_torch.kernels.ssm_scan import ssd_scan_kernel
from repro_torch.launch.serve import greedy_generate
from repro_torch.models import api, layers, mamba2

ARCH = "zamba2-2.7b"
TP = 2
F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _cfg(dtype="float32"):
    return dataclasses.replace(reduced_config(ARCH), compute_dtype=dtype)


def _jcfg(dtype="float32"):
    from repro.configs import reduced_config as jreduced
    return dataclasses.replace(jreduced(ARCH), compute_dtype=dtype)


def _reference_params():
    """The reference's params as nested numpy dicts, perturbed so that norm
    scales, decay rates, skip weights and step biases are not trivial."""
    import jax
    from repro.models import api as japi

    tree = jax.tree_util.tree_map(np.asarray, japi.init(_jcfg(), jax.random.PRNGKey(0), tp=TP))
    rng = np.random.default_rng(5)

    def perturb(name, a):
        if name in ("scale", "D"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name in ("A_log", "dt_bias"):
            return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.array(a)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else perturb(k, v) for k, v in node.items()}

    return walk(tree)


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _setup(dtype):
    import jax.numpy as jnp

    tree = _reference_params()
    return (_jcfg(dtype), _map(tree, jnp.asarray),
            api.load_reference_params(_cfg(dtype), tree, tp=TP, device="cpu"))


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.to(torch.float32).numpy()


def _tokens(cfg, B=2, T=37, seed=1):
    # 37 tokens: two full chunks of 16 and a short last one
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T), dtype=np.int32)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def xla_silu(x):
    """SiLU with the reference's bf16 rounding on the CPU: one rounding per
    op of ``x * (1 / (1 + exp(-x)))``."""
    return x * (1 / (1 + torch.exp(-x)))


@pytest.fixture
def reference_silu(monkeypatch):
    """Run the port with ``xla_silu`` in place of ``F.silu`` (the model's
    gates and the shared block's MLP)."""
    monkeypatch.setattr(torch.nn.functional, "silu", xla_silu)
    monkeypatch.setitem(layers._ACTS, "silu", xla_silu)


def test_logits_match_reference():
    from repro.models import api as japi

    jcfg, jparams, params = _setup("float32")
    toks = _tokens(jcfg)
    want = japi.logits(jcfg, jparams, {"tokens": toks}, tp=TP, q_block=8)
    got = api.logits(_cfg(), params, {"tokens": toks}, tp=TP)
    assert got.shape == want.shape and str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_bfloat16_logits_match_reference(monkeypatch):
    from repro.models import api as japi

    jcfg, jparams, params = _setup("bfloat16")
    toks = _tokens(jcfg)
    want = _np(japi.logits(jcfg, jparams, {"tokens": toks}, tp=TP, q_block=8))
    exact = _np(japi.logits(_jcfg(), jparams, {"tokens": toks}, tp=TP, q_block=8))
    own = api.logits(_cfg("bfloat16"), params, {"tokens": toks}, tp=TP)
    assert own.dtype == torch.bfloat16 and tuple(own.shape) == want.shape
    # the port's own bf16 and the reference's lie at the same distance from
    # the float32 answer (0.072 and 0.069 here): bf16 noise, not a fault
    assert np.abs(_np(own) - exact).max() < 2 * np.abs(want - exact).max()
    # with the reference's SiLU rounding, the same logits at 2e-2
    monkeypatch.setattr(torch.nn.functional, "silu", xla_silu)
    monkeypatch.setitem(layers._ACTS, "silu", xla_silu)
    got = api.logits(_cfg("bfloat16"), params, {"tokens": toks}, tp=TP)
    np.testing.assert_allclose(_np(got), want, **BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype, request):
    from repro.models import api as japi

    if dtype == "bfloat16":
        request.getfixturevalue("reference_silu")

    jcfg, jparams, params = _setup(dtype)
    cfg = _cfg(dtype)
    toks = _tokens(cfg, T=40)
    tol = _tol(dtype)
    jcache = japi.init_cache(jcfg, 2, 44, tp=TP)
    jl, jcache = japi.prefill(jcfg, jparams, {"tokens": toks[:, :37]}, jcache, tp=TP,
                              q_block=8)
    cache = api.init_cache(cfg, 2, 44, tp=TP, device="cpu")
    tl, cache = api.prefill(cfg, params, {"tokens": toks[:, :37]}, cache, tp=TP)
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    assert int(cache["pos"]) == int(jcache["pos"]) == 37
    for key in ("S", "conv", "ak", "av"):
        assert tuple(cache[key].shape) == jcache[key].shape, key
        if dtype == "float32":
            np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **tol)
    for t in range(37, 40):
        jl, jcache = japi.decode(jcfg, jparams, jcache, {"token": toks[:, t:t + 1]}, tp=TP)
        tl, cache = api.decode(cfg, params, cache, {"token": toks[:, t:t + 1]}, tp=TP)
        assert str(tl.dtype) == f"torch.{jl.dtype}"
        np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    assert int(cache["pos"]) == int(jcache["pos"]) == 40
    if dtype == "float32":
        for key in ("S", "conv", "ak", "av"):
            np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **tol)


def _decode_vs_teacher_forcing(cfg, params, device, T=33, steps=3):
    toks = _tokens(cfg, T=T + steps, seed=3)
    full = api.logits(cfg, params, {"tokens": toks}, tp=TP)
    cache = api.init_cache(cfg, 2, T + steps + 1, tp=TP, device=device)
    got, cache = api.prefill(cfg, params, {"tokens": toks[:, :T]}, cache, tp=TP)
    np.testing.assert_allclose(_np(got[:, 0].cpu()), _np(full[:, T - 1].cpu()),
                               rtol=5e-3, atol=5e-3)
    for t in range(T, T + steps):
        got, cache = api.decode(cfg, params, cache, {"token": toks[:, t:t + 1]}, tp=TP)
        np.testing.assert_allclose(_np(got[:, 0].cpu()), _np(full[:, t].cpu()),
                                   rtol=5e-3, atol=5e-3)


def test_decode_matches_teacher_forcing():
    """prefill(prompt) + decode(next...) == logits(prompt + next...)."""
    cfg = _cfg()
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    _decode_vs_teacher_forcing(cfg, params, "cpu")


def test_greedy_tokens_equal_reference():
    from repro.launch.serve import greedy_generate as jgreedy

    jcfg, jparams, params = _setup("float32")
    prompt = _tokens(jcfg, B=3, T=20, seed=4)
    want = jgreedy(jcfg, jparams, prompt, steps=6, tp=TP)
    got = greedy_generate(_cfg(), params, prompt, steps=6, tp=TP)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_reference(dtype, request):
    """One Mamba2 layer's decode (and its ``ssd_decode_step``) from a
    random state, against the reference's, types included."""
    import jax.numpy as jnp
    from repro.models import mamba2 as jm

    if dtype == "bfloat16":
        request.getfixturevalue("reference_silu")

    jcfg, jparams, params = _setup(dtype)
    cfg = _cfg(dtype)
    d_inner, H, P, N = mamba2._dims_mamba(cfg)
    rng = np.random.default_rng(6)
    S = rng.standard_normal((2, H, N, P)).astype(np.float32)
    conv = rng.standard_normal((2, cfg.ssm.conv_kernel - 1, d_inner)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    lp = mamba2.layer_params(params, 1)
    jlp = {k: v[1] for k, v in jparams["layers"].items() if not isinstance(v, dict)}
    jlp["ln"] = {"scale": jparams["layers"]["ln"]["scale"][1]}
    jdt = getattr(jnp, dtype)
    want, wst = jm.mamba_decode(jcfg, jlp, {"S": jnp.asarray(S), "conv": jnp.asarray(conv)},
                                jnp.asarray(x1, jdt))
    got, st = mamba2.mamba_decode(cfg, lp, {"S": torch.from_numpy(S),
                                            "conv": torch.from_numpy(conv)},
                                  torch.from_numpy(x1).to(getattr(torch, dtype)))
    assert str(got.dtype) == f"torch.{want.dtype}"
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(st["S"]), _np(wst["S"]), **tol)
    np.testing.assert_allclose(_np(st["conv"]), _np(wst["conv"]), **tol)

    # the SSD step alone
    x = rng.standard_normal((2, H, P)).astype(np.float32)
    dt = (rng.random((2, H)) * 0.5 + 0.1).astype(np.float32)
    A = (-rng.random(H) - 0.2).astype(np.float32)
    Bn, Cn = (rng.standard_normal((2, N)).astype(np.float32) for _ in range(2))
    wy, wS = jm.ssd_decode_step(*(jnp.asarray(a) for a in (S, x, dt, A, Bn, Cn)))
    gy, gS = mamba2.ssd_decode_step(*(torch.from_numpy(a) for a in (S, x, dt, A, Bn, Cn)))
    np.testing.assert_allclose(_np(gy), _np(wy), **F32_TOL)
    np.testing.assert_allclose(_np(gS), _np(wS), **F32_TOL)


def test_load_reference_params_carries_the_hybrid_tree():
    """Every leaf of the reference's tree — the stacked ``layers``, the
    nested ``shared`` block — arrives under its name with its values."""
    tree = _reference_params()
    params = api.load_reference_params(_cfg(), tree, tp=TP, device="cpu")
    got, want = dict(api._leaves(params)), dict(api._leaves(tree))
    assert sorted(got) == sorted(want)
    assert "shared/attn/wq" in got and "layers/w_dt" in got and "layers/ln/scale" in got
    for name, value in want.items():
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)
    mine = dict(api._leaves(api.init(_cfg(), torch.Generator().manual_seed(7), tp=TP,
                                     device="cpu")))
    for name, t in mine.items():
        assert tuple(t.shape) == want[name].shape, name
    del tree["shared"]["mlp"]["wg"]
    with pytest.raises(ValueError, match="missing.*shared/mlp/wg"):
        api.load_reference_params(_cfg(), tree, tp=TP, device="cpu")


def test_prefill_refuses_what_the_cache_cannot_hold():
    cfg = _cfg()
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    cache = api.init_cache(cfg, 2, 8, tp=TP, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        api.prefill(cfg, params, {"tokens": _tokens(cfg, T=9)}, cache, tp=TP)
    with pytest.raises(ValueError, match="conv state"):
        api.prefill(cfg, params, {"tokens": _tokens(cfg, T=2)}, cache, tp=TP)


# ---------------------------------------------------------------------------
# on the card: the same model through the kernels
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_model_on_card_matches_cpu_and_uses_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _cfg()
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    gpu = api._build((k, v.cuda()) for k, v in api._leaves(params))
    kernels = (ssd_scan_kernel, rmsnorm_kernel, flash_attention_kernel,
               decode_attention_kernel)
    counts = [f.launches for f in kernels]
    T, steps = 33, 3
    _decode_vs_teacher_forcing(cfg, gpu, "cuda", T=T, steps=steps)
    after = [f.launches for f in kernels]
    L, G = cfg.n_layers, mamba2.n_shared_applications(cfg)
    norms = L + 2 * G + 1
    # logits + prefill: 2 scans per layer, 2 * norms, 2G flash; each decode
    # step: norms and G flash-decode, no scan
    want = [2 * L, (2 + steps) * norms, 2 * G, steps * G]
    assert [a - b for a, b in zip(after, counts)] == want
    toks = _tokens(cfg, T=T, seed=3)
    cpu = api.logits(cfg, params, {"tokens": toks}, tp=TP)
    card = api.logits(cfg, gpu, {"tokens": toks}, tp=TP).cpu()
    np.testing.assert_allclose(_np(card), _np(cpu), rtol=2e-4, atol=2e-4)
