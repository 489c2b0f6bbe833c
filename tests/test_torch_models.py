"""The port's dense model family against the reference package.

Reduced configs of the three dense architectures (SmolLM, Llama 3.2, Qwen2
with its QKV bias), with the reference's weights from
``repro.models.api.init(cfg, PRNGKey(0), tp=2)`` carried across by
``load_reference_params`` (norm scales and biases perturbed first, so every
parameter matters).  Teacher-forcing logits, prefill and one decode step
agree with the reference's: float32 at rtol 2e-4 / atol 2e-5, bfloat16
logits at 2e-2.  The port's own decode reproduces its teacher forcing
(``tests/test_models.py``'s 5e-3 contract), and greedy generation gives the
reference's tokens in float32.  On the CPU the attention cores and norms run
the kernels' plain versions; on the card (``gpu``) the kernels themselves.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.decode_attention import decode_attention_kernel
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.rmsnorm import rmsnorm_kernel
from repro_torch.launch.serve import greedy_generate
from repro_torch.models import api

TP = 2
DENSE = ["smollm-360m", "llama3.2-1b", "qwen2-1.5b"]
F32_TOL = dict(rtol=2e-4, atol=2e-5)


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(reduced_config(arch), compute_dtype=dtype)


def _reference_params(arch):
    """The reference's params as nested numpy dicts, perturbed so that norm
    scales and QKV biases are not their trivial ones and zeros."""
    import jax
    from repro.configs import reduced_config as jreduced
    from repro.models import api as japi

    tree = jax.tree_util.tree_map(
        np.asarray, japi.init(jreduced(arch), jax.random.PRNGKey(0), tp=TP))
    rng = np.random.default_rng(5)

    def perturb(path, a):
        name = path[-1]
        if name == "scale":
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name in ("bq", "bk", "bv"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.array(a)

    def walk(node, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else perturb(path + (k,), v)
                for k, v in node.items()}

    return walk(tree)


def _setup(arch, dtype):
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced

    tree = _reference_params(arch)
    jcfg = dataclasses.replace(jreduced(arch), compute_dtype=dtype)
    jparams = _map(tree, jnp.asarray)
    params = api.load_reference_params(_cfg(arch, dtype), tree, tp=TP, device="cpu")
    return jcfg, jparams, params


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.to(torch.float32).numpy()


def _tokens(cfg, B=2, T=17, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T), dtype=np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_logits_match_reference(arch, dtype):
    from repro.models import api as japi

    jcfg, jparams, params = _setup(arch, dtype)
    toks = _tokens(jcfg)
    want = japi.logits(jcfg, jparams, {"tokens": toks}, tp=TP, q_block=8)
    got = api.logits(_cfg(arch, dtype), params, {"tokens": toks}, tp=TP)
    assert got.shape == want.shape and str(got.dtype) == f"torch.{want.dtype}"
    tol = F32_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch, dtype):
    from repro.models import api as japi

    jcfg, jparams, params = _setup(arch, dtype)
    cfg = _cfg(arch, dtype)
    toks = _tokens(cfg, T=17)
    tol = F32_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    jcache = japi.init_cache(jcfg, 2, 24, tp=TP)
    jl, jcache = japi.prefill(jcfg, jparams, {"tokens": toks[:, :16]}, jcache, tp=TP, q_block=8)
    cache = api.init_cache(cfg, 2, 24, tp=TP, device="cpu")
    tl, cache = api.prefill(cfg, params, {"tokens": toks[:, :16]}, cache, tp=TP)
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    assert int(cache["pos"]) == int(jcache["pos"]) == 16
    if dtype == "float32":
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **F32_TOL)
    jl, jcache = japi.decode(jcfg, jparams, jcache, {"token": toks[:, 16:17]}, tp=TP)
    tl, cache = api.decode(cfg, params, cache, {"token": toks[:, 16:17]}, tp=TP)
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    assert int(cache["pos"]) == int(jcache["pos"]) == 17
    if dtype == "float32":
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), **F32_TOL)


def _decode_vs_teacher_forcing(cfg, params, device):
    toks = _tokens(cfg, T=17, seed=3)
    full = api.logits(cfg, params, {"tokens": toks}, tp=TP)
    cache = api.init_cache(cfg, 2, 20, tp=TP, device=device)
    _, cache = api.prefill(cfg, params, {"tokens": toks[:, :16]}, cache, tp=TP)
    got, _ = api.decode(cfg, params, cache, {"token": toks[:, 16:17]}, tp=TP)
    np.testing.assert_allclose(_np(got[:, 0].cpu()), _np(full[:, -1].cpu()),
                               rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_teacher_forcing(arch):
    """prefill(prompt) + decode(next) == logits(prompt + next)[:, -1]."""
    cfg = _cfg(arch)
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    _decode_vs_teacher_forcing(cfg, params, "cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_tokens_equal_reference(arch):
    from repro.launch.serve import greedy_generate as jgreedy

    jcfg, jparams, params = _setup(arch, "float32")
    prompt = _tokens(jcfg, B=3, T=8, seed=4)
    want = jgreedy(jcfg, jparams, prompt, steps=6, tp=TP)
    got = greedy_generate(_cfg(arch), params, prompt, steps=6, tp=TP)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_init_is_seeded_and_shaped_like_the_reference():
    cfg = _cfg("qwen2-1.5b")
    a = api.init(cfg, torch.Generator().manual_seed(7), tp=TP, device="cpu")
    b = api.init(cfg, torch.Generator().manual_seed(7), tp=TP, device="cpu")
    tree = _reference_params("qwen2-1.5b")
    flat_a, flat_b = dict(api._leaves(a)), dict(api._leaves(b))
    assert sorted(flat_a) == sorted(dict(api._leaves(tree)))
    for name, t in flat_a.items():
        assert torch.equal(t, flat_b[name]) and t.dtype == torch.float32
        assert tuple(t.shape) == dict(api._leaves(tree))[name].shape


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_load_reference_params_rejects_mismatches(fault):
    tree = _reference_params("smollm-360m")
    if fault == "missing":
        del tree["layers"]["attn"]["wq"]
        match = "missing.*layers/attn/wq"
    elif fault == "extra":
        tree["layers"]["attn"]["bq"] = np.zeros((2, 4, 16), np.float32)
        match = "unexpected.*layers/attn/bq"
    elif fault == "shape":
        tree["ln_f"]["scale"] = np.ones((63,), np.float32)
        match = "ln_f/scale: shape"
    else:
        tree["embed"]["table"] = tree["embed"]["table"].astype(np.float16)
        match = "embed/table: dtype"
    with pytest.raises(ValueError, match=match):
        api.load_reference_params(_cfg("smollm-360m"), tree, tp=TP, device="cpu")


def test_make_batch_equals_reference():
    from repro.configs import reduced_config as jreduced
    from repro.models import api as japi

    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("t", kind, 16, 3)
        want = japi.make_batch(jreduced("smollm-360m"), shape, seed=9)
        got = api.make_batch(_cfg("smollm-360m"), shape, seed=9)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = _cfg("smollm-360m")
    with pytest.raises(ValueError, match="CUDA"):
        api.init(cfg, torch.Generator(), tp=TP)
    with pytest.raises(ValueError, match="CUDA"):
        api.init_cache(cfg, 1, 8, tp=TP)


# ---------------------------------------------------------------------------
# on the card: the same model through the kernels
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", DENSE)
def test_model_on_card_matches_cpu_and_uses_the_kernels(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _cfg(arch)
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    gpu = api._build((k, v.cuda()) for k, v in api._leaves(params))
    toks = _tokens(cfg, T=17, seed=3)
    counts = [f.launches for f in (rmsnorm_kernel, flash_attention_kernel,
                                   decode_attention_kernel)]
    _decode_vs_teacher_forcing(cfg, gpu, "cuda")
    after = [f.launches for f in (rmsnorm_kernel, flash_attention_kernel,
                                  decode_attention_kernel)]
    L = cfg.n_layers
    # logits + prefill: 2 * (2L + 1) norms and 2L flash; decode: 2L + 1 norms, L decode
    assert [a - b for a, b in zip(after, counts)] == [3 * (2 * L + 1), 2 * L, L]
    cpu = api.logits(cfg, params, {"tokens": toks}, tp=TP)
    card = api.logits(cfg, gpu, {"tokens": toks}, tp=TP).cpu()
    np.testing.assert_allclose(_np(card), _np(cpu), rtol=2e-4, atol=2e-4)
