"""Training the other families in the port, against the reference package.

The SSD scan's backward first: ``ssd_scan_vjp`` against ``torch.autograd``
through the plain chunked form in float64 (chunks of T, a short last chunk,
T below one chunk), against autograd through a float64 sequential
recurrence where the decay is steep (dt*A from -6 to -216: the chunked
form's exp above the diagonal overflows, so autograd through it gives NaN),
and against ``jax.vjp`` of the reference's ``ssd_chunked`` in float32.
``SSDScanFn`` gives gradients in each input's dtype and calls the VJP once a
backward.

Then the six non-dense reduced archs at tp=2 (Zamba2, Granite MoE, DBRX,
SeamlessM4T with stubbed frames, Phi-3-vision with stubbed patches,
xLSTM), from the reference's weights (``load_reference_params``; norm
scales, LayerNorm biases and the SSD's ``A_log``, ``D`` and ``dt_bias``
perturbed first) and ``make_batch``'s batches, whose numbers equal the
reference's.  Float32: one batch's gradients within 1e-4 of each leaf's
largest magnitude against the reference's ``jax.grad`` (Granite MoE also at
capacity 1.0, where pairs drop); three ``make_train_step`` steps whose
losses and grad norms match the reference's jitted steps at rtol 1e-5.
bfloat16: the port's gradients at most twice as far from the reference's
float32 ones as the reference's bf16 ones are (``tests/test_torch_train.py``'s
rule); for MoE, whose bf16 router logits round apart in XLA and PyTorch so
that a near tie picks another expert, on the loss and on the leaves outside
the routed layers' router and experts.  xLSTM runs at 16 tokens: at the
reference's random init its sLSTM recurrence parts float32 roundings to
O(1) beyond about 48.  Remat gives the gradients of no remat, and
recomputes (Zamba2: each Mamba2 layer's scan runs twice).

Also: the port of ``tests/test_models.py::test_smoke_train_step`` over all
ten archs; a resumed ``train()`` equals the uninterrupted one for Zamba2,
Granite MoE and xLSTM (whose layers are a list); the ``train`` CLI for Zamba2; ``train()`` refusing the encdec
and vlm families, whose batches need frames or patches.  On the card
(``gpu``): ``SSDScanFn`` through the kernel against the CPU's VJP, and each
family's reduced float32 step against the CPU's at 1e-4.  The reference
package is imported inside the tests that use it, so the ``gpu`` cases also
run without JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan
from repro_torch.kernels.ssm_scan import ssd_scan_plain, ssd_scan_vjp
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import api
from repro_torch.optim import AdamWConfig, adamw_init

TP = 2
FAMILIES = ["zamba2-2.7b", "granite-moe-1b-a400m", "dbrx-132b", "seamless-m4t-large-v2",
            "phi-3-vision-4.2b", "xlstm-350m"]
MOE = ("granite-moe-1b-a400m", "dbrx-132b")
STEPS, BATCH = 3, 2
STEP_KW = dict(warmup=2, total_steps=10)
LR = 1e-3
Q_BLOCK = 8


def _seq(arch) -> int:
    """xLSTM at 16 tokens (its recurrence is chaotic at the reference's init)."""
    return 16 if arch == "xlstm-350m" else 32


def _cfg(arch, dtype="float32", **kw):
    return dataclasses.replace(reduced_config(arch), compute_dtype=dtype, **kw)


def _jcfg(arch, dtype="float32", **kw):
    from repro.configs import reduced_config as jreduced
    return dataclasses.replace(jreduced(arch), compute_dtype=dtype, **kw)


def _walk(node, fn, path=()):
    if isinstance(node, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in node.items()}
    if isinstance(node, list):
        return [_walk(v, fn, path + (str(i),)) for i, v in enumerate(node)]
    return fn(path, node)


def _reference_tree(arch):
    """The reference's params as nested numpy dicts (and xLSTM's list),
    perturbed so that norm scales, LayerNorm biases and the SSD's decay
    rates, skip weights and step biases are not their trivial values."""
    import jax
    from repro.models import api as japi

    tree = jax.tree_util.tree_map(np.asarray, japi.init(_jcfg(arch), jax.random.PRNGKey(0),
                                                        tp=TP))
    rng = np.random.default_rng(5)

    def perturb(path, a):
        if path[-1] in ("scale", "D"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if path[-1] in ("bias", "A_log", "dt_bias"):
            return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.array(a)

    return _walk(tree, perturb)


def _batch(arch, seed=3):
    """``make_batch``'s train batch: tokens, labels and the stubbed frames
    or patches."""
    return api.make_batch(_cfg(arch), ShapeConfig("t", "train", _seq(arch), BATCH), seed=seed)


def _flat(tree) -> dict:
    return {name: leaf.detach().float().cpu().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf, np.float32) for name, leaf in api._leaves(tree)}


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _nll_mean(xp, cfg, logits, labels, mask):
    """The cross entropy of the train step (padded vocab masked, the gold
    logit picked by an ``iota == label`` sum), averaged over the positions
    ``mask`` keeps; ``xp`` is ``jnp`` or ``torch``."""
    lgf = logits.astype(xp.float32) if xp is not torch else logits.to(torch.float32)
    ids = xp.arange(lgf.shape[-1])
    lgf = xp.where(ids < cfg.vocab, lgf, -1e30)
    m = xp.max(lgf, -1) if xp is not torch else lgf.amax(-1)
    lse = xp.log(xp.sum(xp.exp(lgf - m[..., None]), -1)) + m
    gold = xp.sum(xp.where(ids == labels[..., None], lgf, 0.0), -1)
    return xp.sum((lse - gold) * mask) / xp.sum(mask)


def _reference_grads(arch, dtype, tree, batch, *, mask=None, flash=False, **cfg_kw):
    """(loss, flat gradients) of the reference train step's loss (masters
    cast to the compute dtype, logits, cross entropy; over the positions
    ``mask`` keeps, if given) by ``jax.grad``.  ``flash``: the model's
    attention through the reference's own trainable flash kernels
    (``kernels/flash_attention_bwd.py``, in interpret mode)."""
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import cross_entropy as jce
    from repro.models import api as japi
    from repro.models import layers as jlayers

    jcfg = _jcfg(arch, dtype, **cfg_kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        p = jax.tree_util.tree_map(lambda x: x.astype(jnp.dtype(dtype)), p)
        logits = japi.logits(jcfg, p, jb, tp=TP, q_block=Q_BLOCK)
        if mask is None:
            return jce(jcfg, logits, jb["labels"])
        return _nll_mean(jnp, jcfg, logits, jb["labels"], jnp.asarray(mask))

    sdpa = jlayers._sdpa_blocked
    if flash:
        jlayers._sdpa_blocked = _reference_flash_sdpa
    try:
        value, grads = jax.jit(jax.value_and_grad(loss))(
            _walk(tree, lambda _, a: jnp.asarray(a)))
    finally:
        jlayers._sdpa_blocked = sdpa
    return float(value), _flat(_np_tree(grads))


def _reference_flash_sdpa(q, k, v, *, group, causal, q_block, q0=0):
    """The reference's ``_sdpa_blocked`` signature over its trainable flash
    kernels (forward with statistics, dQ, dK/dV; delta from o in q's
    dtype, ``kernels/flash_attention_bwd.py:200``), the kernels the port's
    training path replaces."""
    from repro.kernels.flash_attention_bwd import flash_attention_trainable

    T, S = q.shape[1], k.shape[1]
    o = flash_attention_trainable(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                                  v.transpose(0, 2, 1, 3), causal, min(16, T), min(16, S),
                                  True)
    return o.transpose(0, 2, 1, 3)


def _port_grads(cfg, params, batch, mask):
    """(loss, flat gradients) of the port's train-step loss over the
    positions ``mask`` keeps: ``loss_and_grads`` with the masked mean."""
    from repro_torch.optim.tree import tree_build, tree_map

    names, leaves = zip(*api._leaves(params))
    leaves = [t.detach().requires_grad_() for t in leaves]
    cast = tree_map(lambda x: x.to(getattr(torch, cfg.compute_dtype)),
                    tree_build(zip(names, leaves)))
    logits = api.logits(cfg, cast, batch, tp=TP)
    loss = _nll_mean(torch, cfg, logits, torch.as_tensor(batch["labels"]),
                     torch.as_tensor(mask, dtype=torch.float32))
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), _flat(tree_build(zip(names, grads)))


def _leaf_errors(got: dict, want: dict) -> dict:
    assert sorted(got) == sorted(want)
    return {k: float(np.abs(got[k] - want[k]).max()) for k in want}


# ---------------------------------------------------------------------------
# the SSD scan's backward
# ---------------------------------------------------------------------------

SSD_CASES = [
    # (B, T, H, P, N, chunk): T a multiple of the chunk, a short last chunk,
    # T below one chunk (tests/test_torch_ssm_scan.py's shapes)
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 32, 16, 32),
    (2, 100, 3, 16, 8, 32),
    (1, 300, 2, 64, 16, 256),
    (2, 11, 2, 16, 8, 16),
]
STEEP = (2, 64, 2, 12, 8, 16)
STEEP_A = 300.0       # steps of dt*A from -6 to -216


def _ssd_arrays(case, seed, a_scale=1.0):
    """x, dt, A, B, C and a cotangent dy as float32 numpy arrays, drawn as
    tests/test_torch_ssm_scan.py draws them."""
    B, T, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((B, T, H, P)).astype(f32),
            (rng.random((B, T, H)) * 0.5 + 0.1).astype(f32),
            ((-rng.random(H) - 0.2) * a_scale).astype(f32),
            (rng.standard_normal((B, T, N)) * 0.3).astype(f32),
            (rng.standard_normal((B, T, N)) * 0.3).astype(f32),
            rng.standard_normal((B, T, H, P)).astype(f32))


def _autograd(fn, inputs, dy):
    leaves = [t.clone().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, dy)


def _assert_grads(got, want, rel, names="x dt A B C".split()):
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, g.dtype)
        err = (g - w).abs().max().item()
        assert err <= rel * w.abs().max().item(), (name, err, w.abs().max().item())


def _sequential(x, dt, A, B, C):
    """The SSD recurrence step by step in the inputs' dtype (a test oracle:
    no exp of a difference of cumulative decays, so no overflow)."""
    S = torch.zeros((x.shape[0], x.shape[2], B.shape[-1], x.shape[3]), dtype=x.dtype)
    ys = []
    for t in range(x.shape[1]):
        S = S * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bn,bh,bhp->bhnp", B[:, t], dt[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], S))
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_vjp_matches_autograd_float64(case):
    *inputs, dy = (torch.from_numpy(a).double() for a in _ssd_arrays(case, 30))
    chunk = case[5]
    want = _autograd(lambda *a: ssd_scan_plain(*a, chunk=chunk), inputs, dy)
    got = ssd_scan_vjp(*inputs, dy, chunk=chunk)
    _assert_grads(got, want, 1e-12)


def test_ssd_vjp_is_finite_where_the_decay_overflows():
    """dt*A from -6 to -216: exp(cs_i - cs_j) overflows above the diagonal,
    which the VJP masks before the exp.  Against autograd through the
    float64 recurrence, and in float32 finite and close to it."""
    *inputs, dy = (torch.from_numpy(a).double()
                   for a in _ssd_arrays(STEEP, 31, a_scale=STEEP_A))
    want = _autograd(_sequential, inputs, dy)
    _assert_grads(ssd_scan_vjp(*inputs, dy, chunk=STEEP[5]), want, 1e-7)
    got32 = ssd_scan_vjp(*(t.float() for t in inputs), dy.float(), chunk=STEEP[5])
    for name, g, w in zip("x dt A B C".split(), got32, want):
        assert torch.isfinite(g).all(), name
    _assert_grads(got32[:2] + got32[3:], [w.float() for w in want[:2] + want[3:]], 1e-5,
                  names="x dt B C".split())
    # dA is the reversed cumsum of the cumulative decays' gradient, whose
    # terms at these decays dwarf their sum: float32 keeps two digits of it
    # (1.1e-2 of its largest magnitude here)
    assert (got32[2].double() - want[2]).abs().max() <= 3e-2 * want[2].abs().max()


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_vjp_matches_reference_jax_vjp(case):
    """Float32 against ``jax.vjp`` of the reference's ``ssd_chunked`` (its y;
    the final state's cotangent zero), each gradient within 1e-4 of its
    largest magnitude."""
    import jax
    import jax.numpy as jnp
    from repro.models.mamba2 import ssd_chunked

    arrays = _ssd_arrays(case, 32)
    chunk = case[5]
    @jax.jit
    def grads(x, dt, A, B, C, dy):
        return jax.vjp(lambda *a: ssd_chunked(*a, chunk=chunk)[0], x, dt, A, B, C)[1](dy)

    want = [torch.from_numpy(np.array(g)) for g in grads(*(jnp.asarray(a) for a in arrays))]
    got = ssd_scan_vjp(*(torch.from_numpy(a) for a in arrays), chunk=chunk)
    _assert_grads(got, want, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_fn_gradients_come_in_each_inputs_dtype(dtype):
    """x, B and C in ``dtype``, dt and A float32: the Function's forward is
    the plain version's y, and its backward one VJP call whose gradients
    keep those dtypes (bf16 ones are the float32 VJP's, rounded once)."""
    case = SSD_CASES[2]
    x, dt, A, B, C, dy = (torch.from_numpy(a) for a in _ssd_arrays(case, 33))
    x, B, C = (t.to(dtype) for t in (x, B, C))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    calls = ssd_scan_vjp.calls
    y = ops.ssd_scan_trainable(*leaves, chunk=case[5])
    assert torch.equal(y.detach(), ssd_scan_plain(x, dt, A, B, C, chunk=case[5]))
    grads = torch.autograd.grad(y, leaves, dy.to(dtype))
    assert ssd_scan_vjp.calls == calls + 1
    assert [g.dtype for g in grads] == [dtype, torch.float32, torch.float32, dtype, dtype]
    want = ssd_scan_vjp(x, dt, A, B, C, dy.to(dtype), chunk=case[5])
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_ssd_kernel_still_refuses_grad():
    x, dt, A, B, C, _ = (torch.from_numpy(a) for a in _ssd_arrays(SSD_CASES[0], 34))
    with pytest.raises(RuntimeError, match="SSDScanFn"):
        ssm_scan.ssd_scan_kernel(x.requires_grad_(), dt, A, B, C, chunk=16)


# ---------------------------------------------------------------------------
# the families against the reference
# ---------------------------------------------------------------------------

GRAD_CASES = [(arch, {}) for arch in FAMILIES] + [
    # capacity 1.0: (token, k) pairs drop, and their gradients are zero
    ("granite-moe-1b-a400m", {"capacity_factor": 1.0})]


def _moe_kw(arch, moe_kw):
    if not moe_kw:
        return {}
    return {"moe": dataclasses.replace(reduced_config(arch).moe, **moe_kw)}


@pytest.mark.parametrize("arch,moe_kw", GRAD_CASES,
                         ids=[a + ("-drops" if kw else "") for a, kw in GRAD_CASES])
def test_float32_gradients_match_reference(arch, moe_kw, monkeypatch):
    """One batch's loss and gradients before clipping and AdamW: each leaf
    within 1e-4 of its largest magnitude."""
    from repro_torch.models import moe

    kw = _moe_kw(arch, moe_kw)
    tree, batch = _reference_tree(arch), _batch(arch)
    want_loss, want = _reference_grads(arch, "float32", tree, batch, **kw)
    cfg = _cfg(arch, **kw)
    params = api.load_reference_params(cfg, tree, tp=TP, device="cpu")
    kept = []
    route = moe.route

    def spy(*args):
        out = route(*args)
        kept.append(out[3])
        return out

    monkeypatch.setattr(moe, "route", spy)
    loss, grads = loss_and_grads(cfg, params, batch, tp=TP)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = _flat(grads)
    assert all(g.dtype == torch.float32 for _, g in api._leaves(grads))
    for name, err in _leaf_errors(got, want).items():
        assert err <= 1e-4 * float(np.abs(want[name]).max()), (name, err)
    if moe_kw:     # the drops this case exists for happened
        assert len(kept) == cfg.n_layers and not all(bool(k.all()) for k in kept)


def _bf16_ulp(a) -> float:
    """The bf16 spacing at ``a``'s largest magnitude."""
    top = float(np.abs(a).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def _routes_agree_mask(arch, params16, params32, batch):
    """(B, T) float mask of the positions that no near tie reaches: a MoE
    layer whose bf16 gates pick another expert set than the float32 ones
    for token t of sequence b changes positions t.. of b (attention is
    causal, and no pair drops at the reduced capacity), so each sequence is
    kept up to its first such token."""
    from repro_torch.models import moe

    B, T = batch["tokens"].shape
    picks = {}
    route = moe.route
    for key, params, dtype in (("bf16", params16, "bfloat16"), ("f32", params32, "float32")):
        picks[key] = []

        def spy(*args, _into=picks[key]):
            out = route(*args)
            _into.append(torch.sort(out[1], dim=-1).values)
            return out

        moe.route = spy
        try:
            with torch.no_grad():
                api.logits(_cfg(arch, dtype), params, batch, tp=TP)
        finally:
            moe.route = route
    mask = np.ones((B, T), np.float32)
    for a, b in zip(picks["bf16"], picks["f32"]):
        for tok in torch.nonzero((a != b).any(dim=-1)).flatten().tolist():
            mask[tok // T, tok % T:] = 0.0
    return mask


@pytest.mark.parametrize("arch", FAMILIES)
def test_bfloat16_gradients_at_the_reference_distance(arch):
    """bf16: every leaf's gradient at most twice as far from the
    reference's float32 ones as the reference's own bf16 ones, plus two
    bf16 ulps of the leaf's largest magnitude (both packages hand the
    float32 master a gradient rounded to bf16, so a distance is known to
    its ulp); the loss at 2e-3 of the reference's bf16 loss.  MoE: over
    the positions its near ties do not reach (:func:`_routes_agree_mask`),
    the loss too at twice the reference's distance.  SeamlessM4T: the reference's distance is
    the larger of its XLA attention's and its own flash kernels' (whose
    backward forms delta from the bf16 o, as the port's does: in the
    unmasked cross-attention over 128 frames, where the softmax is near
    uniform, that sets the query and key gradients)."""
    tree, batch = _reference_tree(arch), _batch(arch)
    params = api.load_reference_params(_cfg(arch, "bfloat16"), tree, tp=TP, device="cpu")
    mask = None
    if arch in MOE:
        mask = _routes_agree_mask(arch, params, api.load_reference_params(
            _cfg(arch), tree, tp=TP, device="cpu"), batch)
        assert mask.sum() >= mask.size // 2, mask
    exact_loss, exact = _reference_grads(arch, "float32", tree, batch, mask=mask)
    ref_loss, ref16 = _reference_grads(arch, "bfloat16", tree, batch, mask=mask)
    ref_err = _leaf_errors(ref16, exact)
    ref_loss_err = abs(ref_loss - exact_loss)
    if arch == "seamless-m4t-large-v2":
        flash_loss, flash16 = _reference_grads(arch, "bfloat16", tree, batch, flash=True)
        ref_err = {k: max(e, f) for (k, e), f in
                   zip(ref_err.items(), _leaf_errors(flash16, exact).values())}
        ref_loss_err = max(ref_loss_err, abs(flash_loss - exact_loss))
    if mask is None:
        loss, grads = loss_and_grads(_cfg(arch, "bfloat16"), params, batch, tp=TP)
        loss, own = float(loss), _flat(grads)
    else:
        loss, own = _port_grads(_cfg(arch, "bfloat16"), params, batch, mask)
    np.testing.assert_allclose(loss, ref_loss, rtol=2e-3)
    if mask is not None:
        assert abs(loss - exact_loss) <= 2 * ref_loss_err + 1e-6, (loss, ref_loss, exact_loss)
    for name, err in _leaf_errors(own, exact).items():
        bound = 2 * ref_err[name] + 2 * _bf16_ulp(exact[name])
        assert err <= bound, (name, err, ref_err[name], bound)


def _reference_steps(arch, tree, batches):
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import make_train_step as jmake
    from repro.optim import AdamWConfig as JAdamW, adamw_init as jinit

    params = _walk(tree, lambda _, a: jnp.asarray(a))
    opt = jinit(params)
    step = jax.jit(jmake(_jcfg(arch), tp=TP, opt=JAdamW(lr=LR), q_block=Q_BLOCK, **STEP_KW))
    out = []
    for b in batches:
        params, opt, m = step(params, opt, {k: jnp.asarray(v) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_match_reference_float32(arch):
    tree = _reference_tree(arch)
    batches = [_batch(arch, seed=s) for s in range(STEPS)]
    want = _reference_steps(arch, tree, batches)
    cfg = _cfg(arch)
    params = api.load_reference_params(cfg, tree, tp=TP, device="cpu")
    opt_state = adamw_init(params)
    step = make_train_step(cfg, tp=TP, opt=AdamWConfig(lr=LR), **STEP_KW)
    got = []
    for b in batches:
        params, opt_state, m = step(params, opt_state, b)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5)
    assert int(opt_state["step"]) == STEPS
    assert all(t.dtype == torch.float32 and not t.requires_grad
               for _, t in api._leaves(params))


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gradients_equal_no_remat(arch, monkeypatch):
    """``cfg.remat`` recomputes each layer in the backward and leaves the
    loss and gradients as they were; Zamba2's scans run twice with it."""
    calls = []
    plain = ssm_scan.ssd_scan_plain

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(ssm_scan, "ssd_scan_plain", counted)
    cfg = _cfg(arch)
    params = api.init(cfg, torch.Generator().manual_seed(1), tp=TP, device="cpu")
    batch = _batch(arch)
    out = {}
    for remat in (False, True):
        calls.clear()
        loss, g = loss_and_grads(dataclasses.replace(cfg, remat=remat), params, batch, tp=TP)
        out[remat] = (float(loss), _flat(g))
        if cfg.family == "hybrid":
            assert len(calls) == cfg.n_layers * (2 if remat else 1)
    assert out[True][0] == out[False][0]
    for name, g in out[False][1].items():
        np.testing.assert_array_equal(out[True][1][name], g, err_msg=name)


# ---------------------------------------------------------------------------
# every arch trains; train() and its CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_train_step(arch):
    """The port of ``tests/test_models.py::test_smoke_train_step``: one step
    of the reduced config (bf16 compute) on ``make_batch``'s batch."""
    cfg = reduced_config(arch)
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    batch = api.make_batch(cfg, ShapeConfig("t", "train", 32, 2))
    p2, o2, metrics = make_train_step(cfg, tp=TP)(params, adamw_init(params), batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    assert int(o2["step"]) == 1
    (_, l0), (_, l1) = next(api._leaves(params)), next(api._leaves(p2))
    assert not torch.allclose(l0, l1)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "granite-moe-1b-a400m", "xlstm-350m"])
def test_resume_equals_uninterrupted_run(arch, tmp_path):
    kw = dict(reduced=True, batch=2, seq=32, ckpt_every=100, log_every=100, device="cpu")
    full = train_mod.train(arch, steps=4, ckpt_dir=str(tmp_path / "a"), **kw)
    d2 = str(tmp_path / "b")
    train_mod.train(arch, steps=2, ckpt_dir=d2, **kw)
    resumed = train_mod.train(arch, steps=4, ckpt_dir=d2, resume=True, **kw)
    assert [m["step"] for m in resumed["metrics"]] == [3, 4]
    assert [m["loss"] for m in resumed["metrics"]] == [m["loss"] for m in full["metrics"][2:]]
    for key in ("params", "opt_state"):
        for (name, a), (_, b) in zip(api._leaves(full[key]), api._leaves(resumed[key])):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_train_cli_trains_zamba2_on_cpu(capsys):
    assert train_mod.main(["--arch", "zamba2-2.7b", "--reduced", "--steps", "2",
                           "--batch", "2", "--seq", "16", "--device", "cpu"]) == 0
    assert "step     2 loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch,key", [("seamless-m4t-large-v2", "frames"),
                                      ("phi-3-vision-4.2b", "patches")])
def test_train_refuses_frontend_families(arch, key):
    with pytest.raises(ValueError, match=f"'{key}'"):
        train_mod.train(arch, steps=1, batch=1, seq=8, device="cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 300, 80, 64, 64, 256), (2, 304, 80, 64, 64, 256),
                                  (2, 100, 3, 16, 8, 32)])
def test_ssd_scan_fn_on_card_matches_cpu(case, dtype):
    """Through the kernel forward (its route's launch counted) and the VJP on
    the card, against the same Function on the CPU: y at the forward
    kernel's tolerance, the gradients within 1e-4 (float32) or 2e-2 (bf16)
    of each one's largest magnitude."""
    dev = _card()
    from repro_torch.kernels.ssm_scan import ssd_route, ssd_scan_kernel

    arrays = _ssd_arrays(case, 35)
    cpu = [torch.from_numpy(a) for a in arrays]
    for i in (0, 3, 4, 5):
        cpu[i] = cpu[i].to(dtype)
    out = {}
    for where in ("cpu", "cuda"):
        leaves = [t.to(where).requires_grad_() for t in cpu[:5]]
        before = dict(ssd_scan_kernel.launches_by_route)
        y = ops.ssd_scan_trainable(*leaves, chunk=case[5])
        grads = torch.autograd.grad(y, leaves, cpu[5].to(where))
        if where == "cuda":
            route = ssd_route(dtype, case[4], case[3], case[5])
            assert ssd_scan_kernel.launches_by_route[route] == before[route] + 1
        out[where] = [t.detach().cpu() for t in (y, *grads)]
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out["cuda"][0].float(), out["cpu"][0].float(), rtol=tol, atol=tol)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(out["cuda"][1:], out["cpu"][1:]):
        assert g.dtype == w.dtype and torch.isfinite(g.float()).all()
        assert (g.float() - w.float()).abs().max() <= rel * w.float().abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_step_on_card_matches_cpu(arch):
    """Each family's reduced config in float32, remat on: the card's loss
    equals the CPU's at 1e-4, and so do the gradients by their global
    relative error and a train step's grad norm, but for the hybrid at
    2e-4, the tolerance of its float32 logits on the card (its gradient at
    this init is ill-conditioned; chip_smoke phase 19's gate)."""
    dev = _card()
    cfg = _cfg(arch, remat=True)
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    on_card = api._build((k, v.to(dev)) for k, v in api._leaves(params))
    batch = _batch(arch)
    lc, gc = loss_and_grads(cfg, params, batch, tp=TP)
    lg, gg = loss_and_grads(cfg, on_card, batch, tp=TP)
    assert abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc))
    want = [a for _, a in api._leaves(gc)]
    got = [b.cpu() for _, b in api._leaves(gg)]
    tol = 2e-4 if cfg.family == "hybrid" else 1e-4
    err = sum(((g - w) ** 2).sum() for g, w in zip(got, want)) ** 0.5
    assert err <= tol * sum((w ** 2).sum() for w in want) ** 0.5
    step = make_train_step(cfg, tp=TP, opt=AdamWConfig(lr=LR), **STEP_KW)
    _, _, mc = step(params, adamw_init(params), batch)
    _, _, mg = step(on_card, adamw_init(on_card), batch)
    for key, t in (("loss", 1e-4), ("grad_norm", tol)):
        assert abs(float(mg[key]) - float(mc[key])) <= t * abs(float(mc[key])), key


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_bfloat16_step_on_card_runs_the_kernels(arch):
    """One bf16 train step of the reduced config with remat on the card: the
    forward with statistics, dQ and dK/dV (every family but xLSTM), RMSNorm
    (all but SeamlessM4T) and the SSD scan with its VJP (Zamba2) each run,
    no serving kernel does, and the loss is the CPU's bf16 loss at 2e-2."""
    dev = _card()
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.decode_attention import decode_attention_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.rmsnorm import rmsnorm_kernel

    cfg = _cfg(arch, "bfloat16", remat=True)
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    on_card = api._build((k, v.to(dev)) for k, v in api._leaves(params))
    batch = _batch(arch)
    fns = (fab.flash_attention_fwd_stats_kernel, fab.flash_attention_dq_kernel,
           fab.flash_attention_dkv_kernel, rmsnorm_kernel, ssm_scan.ssd_scan_kernel,
           flash_attention_kernel, decode_attention_kernel)
    before, vjp = [f.launches for f in fns], ssd_scan_vjp.calls
    step = make_train_step(cfg, tp=TP, opt=AdamWConfig(lr=LR), **STEP_KW)
    _, _, mg = step(on_card, adamw_init(on_card), batch)
    ran = [f.launches - b for f, b in zip(fns, before)]
    attn, norms, hybrid = cfg.family != "ssm", cfg.family != "encdec", cfg.family == "hybrid"
    assert [n > 0 for n in ran] == [attn, attn, attn, norms, hybrid, False, False], ran
    assert (ssd_scan_vjp.calls - vjp > 0) == hybrid
    _, _, mc = make_train_step(cfg, tp=TP, opt=AdamWConfig(lr=LR), **STEP_KW)(
        params, adamw_init(params), batch)
    assert np.isfinite(float(mg["grad_norm"]))
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]), rtol=2e-2)
