"""Sharded training of the port (``launch/steps.py`` under a mesh,
``launch/train.py`` in a world) on gloo worlds on the CPU.

On a (data 2, model 2) world, float32, from the JAX package's initial
weights: the reduced Granite MoE (tensor parallel attention, expert
parallel experts), the reduced SmolLM (its 4 q and 2 kv heads split by 2)
and Qwen2-1.5B (QKV biases, an untied head): the loss and every gradient leaf of one batch against the port's
one-rank ``loss_and_grads`` and against ``jax.grad`` of the reference's
unsharded loss (each leaf within 1e-4 of its largest magnitude, the
one-card tolerance of ``tests/test_torch_train.py``), also with two
microbatches; three train steps
against the port's one-rank steps (losses and grad norms 1e-5 relative,
parameters 1e-4 of each leaf's largest magnitude, plus 2% of the
learning-rate steps where a gradient near AdamW's eps set the step, as in
``tests/test_torch_train.py``); prefill and a decode
step against one rank (logits 1e-5); the hybrid family data-parallel on a
(4, 1) mesh.  The other four families (Zamba2, xLSTM, SeamlessM4T,
Phi-3-vision) tensor-parallel on the (2, 2) world, against one rank and the
reference's gradients, prefill and decode; the fsdp layouts (the fully
sharded strategy, ZeRO on tensor parallelism): three steps of SmolLM and
Granite MoE and a prefill against one rank with the layer gathers counted,
and the other families' gradients.  Elastic resume: ``train()`` takes 2 steps on 4
ranks and checkpoints, then restores on ``plan_elastic_mesh(2,
model_parallel=2)`` and takes 2 more; the result equals 4 uninterrupted
steps on 4 ranks within 1e-5.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import (
    cache_layout,
    loss_and_grads,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    param_layout,
)
from repro_torch.models import api
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import spmd
from repro_torch.runtime.fault_tolerance import build_mesh, plan_elastic_mesh

TP = 2
ARCHS = ["granite-moe-1b-a400m", "smollm-360m", "qwen2-1.5b"]
BATCH, SEQ, STEPS, LR = 4, 16, 3, 1e-3
STEP_KW = dict(warmup=2, total_steps=10)
PROMPT, CACHE = 8, 16


def _cfg(arch):
    return dataclasses.replace(reduced_config(arch), compute_dtype="float32")


def _batches(cfg, n=STEPS):
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH, seed=0))
    return [data.batch_at(i) for i in range(n)]


def _reference_init(arch):
    import jax
    from repro.configs import reduced_config as jreduced
    from repro.models import api as japi

    tree = japi.init(jreduced(arch), jax.random.PRNGKey(0), tp=TP)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _reference_grads(arch, tree, batch):
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced
    from repro.launch.steps import cross_entropy as jce
    from repro.models import api as japi

    jcfg = dataclasses.replace(jreduced(arch), compute_dtype="float32")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss = lambda p: jce(jcfg, japi.logits(jcfg, p, jb, tp=TP, q_block=16),  # noqa: E731
                         jb["labels"])
    grads = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, tree))
    return _flat(jax.tree_util.tree_map(np.asarray, grads))


def _flat(tree):
    return {name: (leaf.detach().float().cpu().numpy() if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf, np.float32)) for name, leaf in api._leaves(tree)}


def _assert_leaves_close(got, want, rel, near_eps=None):
    """Every leaf within ``rel`` of its largest magnitude; the elements that
    ``near_eps`` marks within 2% of the learning-rate steps more, the rule of
    ``tests/test_torch_train.py``: their AdamW step is set by a gradient near
    eps (the key biases' gradient is zero in exact arithmetic, so rounding
    alone sets it)."""
    assert sorted(got) == sorted(want)
    for name in want:
        err = np.abs(got[name] - want[name])
        bound = rel * float(np.abs(want[name]).max()) + 1e-30
        if near_eps is not None:
            bound = bound + 0.02 * LR * STEPS * near_eps[name]
        assert np.all(err <= bound), (name, float(err.max()))


def _gathered_logits(mesh, logits):
    """Every rank's logits (batch over data, vocab over model) as one array."""
    return shd.gather_tree(mesh, {"l": logits}, {"l": shd.P("data", None, "model")})["l"]


def _sharded_rank(arch, tree, batches):
    """One rank of the (2, 2) world: gradients, three steps, prefill and a
    decode step under the mesh; then the hybrid family data-parallel on a
    (4, 1) mesh."""
    cfg = _cfg(arch)
    moe_ep = cfg.family == "moe"
    mesh = spmd.Mesh((2, 2), ("data", "model"))
    full = api.load_reference_params(cfg, tree, tp=TP, device="cpu")
    specs = param_layout(cfg, full, moe_ep=moe_ep)
    params = shd.shard_tree(mesh, full, specs)
    out = {}
    loss, grads = loss_and_grads(cfg, params, batches[0], tp=TP, mesh=mesh, moe_ep=moe_ep)
    out["loss"], out["grads"] = float(loss), _flat(shd.gather_tree(mesh, grads, specs))
    loss, grads = loss_and_grads(cfg, params, batches[0], tp=TP, microbatch=2, mesh=mesh,
                                 moe_ep=moe_ep)
    out["micro"] = (float(loss), _flat(shd.gather_tree(mesh, grads, specs)))

    step = make_train_step(cfg, tp=TP, opt=AdamWConfig(lr=LR), mesh=mesh, moe_ep=moe_ep,
                           **STEP_KW)
    opt_state, metrics = adamw_init(params), []
    p = params
    for b in batches:
        p, opt_state, m = step(p, opt_state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out["metrics"], out["params"] = metrics, _flat(shd.gather_tree(mesh, p, specs))

    tokens = batches[0]["tokens"][:, :PROMPT]
    cache = api.init_cache(cfg, BATCH, CACHE, tp=TP, device="cpu")
    cspecs = shd.cache_pspecs(cfg, ShapeConfig("d", "decode", CACHE, BATCH), mesh, cache)
    cache = shd.shard_tree(mesh, cache, cspecs)
    prefill = make_prefill_step(cfg, tp=TP, mesh=mesh, moe_ep=moe_ep,
                                moe_seq_axis="model" if moe_ep else None)
    decode = make_decode_step(cfg, tp=TP, mesh=mesh, moe_ep=moe_ep)
    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": tokens}, cache)
        out["prefill"] = _gathered_logits(mesh, logits).numpy()
        logits, cache = decode(params, cache, {"token": batches[0]["tokens"][:, PROMPT:PROMPT + 1]})
        out["decode"] = _gathered_logits(mesh, logits).numpy()

    hcfg = _cfg("zamba2-2.7b")
    dp = spmd.Mesh((4, 1), ("data", "model"))
    hfull = api.init(hcfg, torch.Generator().manual_seed(0), tp=1, device="cpu")
    hspecs = param_layout(hcfg, hfull)
    hloss, hgrads = loss_and_grads(hcfg, shd.shard_tree(dp, hfull, hspecs), batches[0], tp=1,
                                   mesh=dp)
    out["hybrid"] = (float(hloss), _flat(shd.gather_tree(dp, hgrads, hspecs)))
    out["counts"] = {k: dict(v) for k, v in spmd.collectives_by_route.items()}
    return out


@pytest.fixture(scope="module", params=ARCHS)
def sharded(request):
    arch = request.param
    tree = _reference_init(arch)
    batches = _batches(_cfg(arch))
    ranks = spmd.run_spmd(_sharded_rank, 4, device="cpu", args=(arch, tree, batches),
                          timeout=300)
    return arch, tree, batches, ranks


def test_gradients_equal_one_rank_and_the_reference(sharded):
    arch, tree, batches, ranks = sharded
    cfg = _cfg(arch)
    params = api.load_reference_params(cfg, tree, tp=TP, device="cpu")
    loss, grads = loss_and_grads(cfg, params, batches[0], tp=TP)
    one, ref = _flat(grads), _reference_grads(arch, tree, batches[0])
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-6)
        _assert_leaves_close(r["grads"], one, 1e-4)
        _assert_leaves_close(r["grads"], ref, 1e-4)


def test_microbatched_gradients_equal_one_rank(sharded):
    """``microbatch=2`` under the mesh (one sequence a microbatch on each
    data rank) against the one-rank step's two microbatches of two: the
    data axes are reduced once, after the accumulation."""
    arch, tree, batches, ranks = sharded
    cfg = _cfg(arch)
    params = api.load_reference_params(cfg, tree, tp=TP, device="cpu")
    loss, grads = loss_and_grads(cfg, params, batches[0], tp=TP, microbatch=2)
    for r in ranks:
        np.testing.assert_allclose(r["micro"][0], float(loss), rtol=1e-6)
        _assert_leaves_close(r["micro"][1], _flat(grads), 1e-4)


def test_train_steps_equal_one_rank(sharded):
    arch, tree, batches, ranks = sharded
    cfg = _cfg(arch)
    params = api.load_reference_params(cfg, tree, tp=TP, device="cpu")
    step = make_train_step(cfg, tp=TP, opt=AdamWConfig(lr=LR), **STEP_KW)
    opt_state, metrics, near_eps = adamw_init(params), [], {}
    opt = AdamWConfig()
    for b in batches:
        params, opt_state, m = step(params, opt_state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        n = int(opt_state["step"])
        for name, v in _flat(opt_state["v"]).items():
            near = np.sqrt(v / (1.0 - opt.b2 ** n)) < 100 * opt.eps
            near_eps[name] = near_eps.get(name, False) | near
    for r in ranks:
        np.testing.assert_allclose(np.array(r["metrics"]), np.array(metrics), rtol=1e-5)
        _assert_leaves_close(r["params"], _flat(params), 1e-4, near_eps)


def test_prefill_and_decode_equal_one_rank(sharded):
    arch, tree, batches, ranks = sharded
    cfg = _cfg(arch)
    params = api.load_reference_params(cfg, tree, tp=TP, device="cpu")
    cache = api.init_cache(cfg, BATCH, CACHE, tp=TP, device="cpu")
    with torch.no_grad():
        prefill, cache = api.prefill(cfg, params, {"tokens": batches[0]["tokens"][:, :PROMPT]},
                                     cache, tp=TP)
        decode, _ = api.decode(cfg, params, cache,
                               {"token": batches[0]["tokens"][:, PROMPT:PROMPT + 1]}, tp=TP)
    for r in ranks:
        np.testing.assert_allclose(r["prefill"], prefill.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["decode"], decode.numpy(), rtol=1e-5, atol=1e-5)


def test_hybrid_trains_data_parallel(sharded):
    arch, _, batches, ranks = sharded
    cfg = _cfg("zamba2-2.7b")
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=1, device="cpu")
    loss, grads = loss_and_grads(cfg, params, batches[0], tp=1)
    for r in ranks:
        np.testing.assert_allclose(r["hybrid"][0], float(loss), rtol=1e-6)
        _assert_leaves_close(r["hybrid"][1], _flat(grads), 1e-4)
    counts = ranks[0]["counts"]["gloo"]
    assert counts["all_reduce"] > 0
    assert ("all_to_all" in counts) == (_cfg(arch).family == "moe")


# ---------------------------------------------------------------------------
# the other four families under tensor parallelism, and the fsdp layouts
# ---------------------------------------------------------------------------

FAMILIES = ["zamba2-2.7b", "xlstm-350m", "seamless-m4t-large-v2", "phi-3-vision-4.2b"]
# (arch, strategy, fsdp): the fully sharded strategy and ZeRO on tensor
# parallelism, three train steps each
FSDP_RUNS = [("smollm-360m", "fsdp", False), ("granite-moe-1b-a400m", "fsdp", False),
             ("smollm-360m", "tp", True), ("granite-moe-1b-a400m", "tp", True),
             ("zamba2-2.7b", "tp", True)]
# The runs whose parameters are held by the AdamW-propagated rule
# (_adamw_bounds) instead of the near-eps one.  Clipping Zamba2's large
# first gradient scales every gradient far down and leaves many embedding
# elements within a few eps of zero; AdamW divides each step by
# sqrt(v_hat) + eps, so there it turns a rounding difference of the
# gradient into a difference of the step.  One rank alone shows it: the
# same steps with the batch in two microbatches (a reduction order changed,
# nothing sharded) need the same rule
# (test_adamw_rule_covers_a_reduction_order_change_on_one_rank).
ADAMW_RULE_RUNS = {("zamba2-2.7b", "tp", True)}
# gradients under both layouts: the other families, and with a batch of 2
# (split over data alone, so the model ranks gather equal gradients)
FSDP_GRADS = [(arch, strategy, strategy == "tp", BATCH) for arch in FAMILIES
              for strategy in ("fsdp", "tp")] + [
    ("smollm-360m", "fsdp", False, 2), ("granite-moe-1b-a400m", "fsdp", False, 2)]


def _family_batch(cfg, batch, kind="train", seq=SEQ):
    """``batch`` with the stubbed frames or patches an encdec or vlm batch
    carries (``make_batch``'s, seed 1)."""
    extra = api.make_batch(cfg, ShapeConfig("x", kind, seq, BATCH), seed=1)
    return dict(batch) | {k: v for k, v in extra.items() if k in ("frames", "patches")}


def _family_rank(arch, tree, batch):
    """One rank of the (2, 2) world: the family's loss and gradients,
    prefill and a decode step under tensor parallelism."""
    cfg = _cfg(arch)
    mesh = spmd.Mesh((2, 2), ("data", "model"))
    full = api.load_reference_params(cfg, tree, tp=TP, device="cpu")
    specs = param_layout(cfg, full)
    params = shd.shard_tree(mesh, full, specs)
    loss, grads = loss_and_grads(cfg, params, batch, tp=TP, mesh=mesh)
    out = {"loss": float(loss), "grads": _flat(shd.gather_tree(mesh, grads, specs))}
    cache = api.init_cache(cfg, BATCH, CACHE, tp=TP, device="cpu")
    cspecs = shd.cache_pspecs(cfg, ShapeConfig("d", "decode", CACHE, BATCH), mesh, cache)
    cache = shd.shard_tree(mesh, cache, cspecs)
    prompt = _family_batch(cfg, {"tokens": batch["tokens"][:, :PROMPT]}, "prefill", PROMPT)
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg, tp=TP, mesh=mesh)(params, prompt, cache)
        out["prefill"] = _gathered_logits(mesh, logits).numpy()
        logits, cache = make_decode_step(cfg, tp=TP, mesh=mesh)(
            params, cache, {"token": batch["tokens"][:, PROMPT:PROMPT + 1]})
        out["decode"] = _gathered_logits(mesh, logits).numpy()
    return out


def _fsdp_rank(arch, strategy, fsdp, batches):
    """One rank of the (2, 2) world: three train steps held by the layout
    of ``strategy`` and ``fsdp``, and the layer gathers of one more loss."""
    cfg = _cfg(arch)
    moe_ep = cfg.family == "moe"
    mesh = spmd.Mesh((2, 2), ("data", "model"))
    full = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    specs = param_layout(cfg, full, moe_ep=moe_ep, strategy=strategy, fsdp=fsdp, mesh=mesh)
    params = shd.shard_tree(mesh, full, specs)
    step = make_train_step(cfg, tp=TP, opt=AdamWConfig(lr=LR), mesh=mesh, moe_ep=moe_ep,
                           strategy=strategy, fsdp=fsdp, **STEP_KW)
    opt_state, metrics = adamw_init(params), []
    for b in batches:
        params, opt_state, m = step(params, opt_state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    # a prefill under the same layout: each layer gathers its leaves once
    shape = ShapeConfig("p", "prefill", CACHE, BATCH)
    cache = api.init_cache(cfg, BATCH, CACHE, tp=TP, device="cpu")
    cache = shd.shard_tree(mesh, cache, cache_layout(cfg, shape, mesh, cache,
                                                     strategy=strategy))
    shd.layer_gathers.update(calls=0, leaves=0)
    prefill = make_prefill_step(cfg, tp=TP, mesh=mesh, moe_ep=moe_ep, strategy=strategy,
                                fsdp=fsdp)
    with torch.no_grad():
        logits, _ = prefill(params, {"tokens": batches[0]["tokens"][:, :PROMPT]}, cache)
    batch_axes = shd.batch_pspecs(cfg, shape, mesh, strategy=strategy)["tokens"][0]
    vocab = "model" if strategy == "tp" else None
    logits = shd.gather_tree(mesh, {"l": logits}, {"l": shd.P(batch_axes, None, vocab)})["l"]
    return {"metrics": metrics, "params": _flat(shd.gather_tree(mesh, params, specs)),
            "specs": dict(shd._spec_items(specs)), "gathers": dict(shd.layer_gathers),
            "prefill": logits.numpy()}


def _grads_batch(arch, batches, rows):
    cfg = _cfg(arch)
    batch = batches[arch] if arch in batches else _batches(cfg, n=1)[0]
    return {k: v[:rows] for k, v in batch.items()}


def _fsdp_grads_rank(arch, strategy, fsdp, batch):
    cfg = _cfg(arch)
    moe_ep = cfg.family == "moe"
    mesh = spmd.Mesh((2, 2), ("data", "model"))
    full = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    specs = param_layout(cfg, full, moe_ep=moe_ep, strategy=strategy, fsdp=fsdp, mesh=mesh)
    loss, grads = loss_and_grads(cfg, shd.shard_tree(mesh, full, specs), batch, tp=TP,
                                 mesh=mesh, moe_ep=moe_ep, strategy=strategy, fsdp=fsdp)
    return float(loss), _flat(shd.gather_tree(mesh, grads, specs))


def _other_ranks(trees, batches):
    out = {arch: _family_rank(arch, trees[arch], batches[arch]) for arch in FAMILIES}
    for arch, strategy, fsdp in FSDP_RUNS:
        out[(arch, strategy, fsdp)] = _fsdp_rank(arch, strategy, fsdp,
                                                 _batches(_cfg(arch)))
    for arch, strategy, fsdp, rows in FSDP_GRADS:
        out[("grads", arch, strategy, fsdp, rows)] = _fsdp_grads_rank(
            arch, strategy, fsdp, _grads_batch(arch, batches, rows))
    return out


@pytest.fixture(scope="module")
def other_families():
    trees = {arch: _reference_init(arch) for arch in FAMILIES}
    batches = {arch: _family_batch(_cfg(arch), _batches(_cfg(arch), n=1)[0])
               for arch in FAMILIES}
    ranks = spmd.run_spmd(_other_ranks, 4, device="cpu", args=(trees, batches), timeout=600)
    return trees, batches, ranks


@pytest.mark.parametrize("arch", FAMILIES)
def test_other_families_run_tensor_parallel(other_families, arch):
    """Zamba2 (heads of the SSD and of the shared block split), xLSTM (the
    mLSTM's dv and the sLSTM's heads split), SeamlessM4T (self- and
    cross-attention heads, the MLP's columns) and Phi-3-vision (the patch
    projection's columns gathered before the token stream) on ``model = 2``:
    the loss and every gradient leaf against the port's one rank and
    against ``jax.grad`` of the reference's unsharded loss (1e-4 of each
    leaf's largest magnitude), prefill and a decode step against one rank
    (1e-5)."""
    trees, batches, ranks = other_families
    cfg = _cfg(arch)
    params = api.load_reference_params(cfg, trees[arch], tp=TP, device="cpu")
    loss, grads = loss_and_grads(cfg, params, batches[arch], tp=TP)
    one, ref = _flat(grads), _reference_grads(arch, trees[arch], batches[arch])
    cache = api.init_cache(cfg, BATCH, CACHE, tp=TP, device="cpu")
    prompt = _family_batch(cfg, {"tokens": batches[arch]["tokens"][:, :PROMPT]}, "prefill",
                           PROMPT)
    with torch.no_grad():
        prefill, cache = api.prefill(cfg, params, prompt, cache, tp=TP)
        decode, _ = api.decode(cfg, params, cache,
                               {"token": batches[arch]["tokens"][:, PROMPT:PROMPT + 1]}, tp=TP)
    for r in ranks:
        got = r[arch]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
        _assert_leaves_close(got["grads"], one, 1e-4)
        _assert_leaves_close(got["grads"], ref, 1e-4)
        np.testing.assert_allclose(got["prefill"], prefill.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["decode"], decode.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("run", FSDP_GRADS,
                         ids=lambda r: f"{r[0]}-{r[1]}{'-zero' if r[2] else ''}-b{r[3]}")
def test_fsdp_gradients_equal_one_rank(other_families, run):
    """The loss and gradients held by the fully sharded layout and by ZeRO
    on tensor parallelism (xLSTM's list of layers, the hybrid's shared block
    and the encoder-decoder's two stacks each gathered in their loops), and
    under the fully sharded layout with a batch that splits over data alone
    (the dense and the moe family), against one rank, 1e-4 of each leaf's
    largest magnitude."""
    arch, strategy, fsdp, rows = run
    _, batches, ranks = other_families
    cfg = _cfg(arch)
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    loss, grads = loss_and_grads(cfg, params, _grads_batch(arch, batches, rows), tp=TP)
    for r in ranks:
        got_loss, got = r[("grads",) + run]
        np.testing.assert_allclose(got_loss, float(loss), rtol=1e-6)
        _assert_leaves_close(got, _flat(grads), 1e-4)


def test_xlstm_refuses_a_model_axis_that_splits_heads():
    """The sLSTM's recurrence stays local only where a rank's D shard holds
    whole heads; any other ``model`` axis is refused."""
    cfg = reduced_config("xlstm-350m")
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 3 * cfg.n_heads},
                                 axis_names=("data", "model"))
    with pytest.raises(ValueError, match="gathered every step"):
        make_train_step(cfg, tp=2, mesh=mesh)
    with pytest.raises(ValueError, match="moe_ep=True"):
        make_train_step(reduced_config("granite-moe-1b-a400m"), tp=2,
                        mesh=types.SimpleNamespace(shape={"data": 1, "model": 2},
                                                   axis_names=("data", "model")))


def _adamw_bounds(params, states, opt, lr_scales):
    """Per element, 1e-4 of each leaf's largest magnitude plus the gradient
    tolerance of these tests carried through each AdamW step: a gradient
    held within D_t = 1e-4 of its leaf's largest clipped gradient so far
    changes an element's step lr_t * m_hat / (sqrt(v_hat) + eps) by at most
    lr_t * D_t / (sqrt(v_hat) + eps) through m_hat (its weights sum to 1)
    and as much again through v_hat, to first order.  ``states`` are the
    one-rank AdamW states before the first step and after each; the
    gradients come from the moments, g_t = (m_t - b1 m_{t-1}) / (1 - b1)."""
    out = {name: 1e-4 * float(np.abs(p).max()) + np.zeros_like(p)
           for name, p in _flat(params).items()}
    gmax = {}
    for t in range(1, len(states)):
        m0, m1, v1 = (_flat(states[t - 1]["m"]), _flat(states[t]["m"]),
                      _flat(states[t]["v"]))
        for name in out:
            g = (m1[name] - opt.b1 * m0[name]) / (1 - opt.b1)
            gmax[name] = max(gmax.get(name, 0.0), float(np.abs(g).max()))
            vhat = v1[name] / (1.0 - opt.b2 ** t)
            out[name] = out[name] + 2 * LR * lr_scales[t - 1] * 1e-4 * gmax[name] / (
                np.sqrt(vhat) + opt.eps)
    return out


def test_adamw_rule_covers_a_reduction_order_change_on_one_rank():
    """The premise of ``_adamw_bounds``: Zamba2's three steps on one rank
    with the batch in two microbatches (only the order of the gradients'
    sums changes) stay within the rule of the same steps in one."""
    cfg = _cfg("zamba2-2.7b")
    first = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")

    def steps(microbatch):
        step = make_train_step(cfg, tp=TP, opt=AdamWConfig(lr=LR), microbatch=microbatch,
                               **STEP_KW)
        params, states, lr_scales = first, [adamw_init(first)], []
        for b in _batches(cfg):
            params, opt_state, m = step(params, states[-1], b)
            states.append(opt_state)
            lr_scales.append(float(m["lr_scale"]))
        return _flat(params), states, lr_scales

    want, states, lr_scales = steps(1)
    got, _, _ = steps(2)
    bounds = _adamw_bounds(first, states, AdamWConfig(), lr_scales)
    for name in want:
        assert np.all(np.abs(got[name] - want[name]) <= bounds[name]), name


@pytest.mark.parametrize("run", FSDP_RUNS, ids=lambda r: f"{r[0]}-{r[1]}{'-zero' if r[2] else ''}")
def test_fsdp_steps_equal_one_rank(other_families, run):
    """Three steps held by ``strategy="fsdp"`` (every leaf split over as
    many axes as divide it, the batch over data and model; Granite MoE's
    experts expert-parallel and split over data) or by ZeRO on tensor
    parallelism (``fsdp=True``) against the port's one-rank steps, at the
    tolerances of the tensor-parallel steps above; and in one more loss,
    each layer gathers its split leaves once, inside the layer.  The runs
    of ``ADAMW_RULE_RUNS`` hold their parameters by :func:`_adamw_bounds`
    (see there)."""
    arch, strategy, fsdp = run
    _, _, ranks = other_families
    cfg = _cfg(arch)
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    first = params
    step = make_train_step(cfg, tp=TP, opt=AdamWConfig(lr=LR), **STEP_KW)
    opt_state, metrics, near_eps = adamw_init(params), [], {}
    states, lr_scales = [opt_state], []
    opt = AdamWConfig()
    for b in _batches(cfg):
        params, opt_state, m = step(params, opt_state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        states.append(opt_state)
        lr_scales.append(float(m["lr_scale"]))
        n = int(opt_state["step"])
        for name, v in _flat(opt_state["v"]).items():
            near = np.sqrt(v / (1.0 - opt.b2 ** n)) < 100 * opt.eps
            near_eps[name] = near_eps.get(name, False) | near
    cache = api.init_cache(cfg, BATCH, CACHE, tp=TP, device="cpu")
    with torch.no_grad():
        prefill, _ = api.prefill(cfg, params, {"tokens": _batches(cfg)[0]["tokens"][:, :PROMPT]},
                                 cache, tp=TP)
    for r in ranks:
        got = r[run]
        np.testing.assert_allclose(np.array(got["metrics"]), np.array(metrics), rtol=1e-5)
        if run in ADAMW_RULE_RUNS:
            bounds, want = _adamw_bounds(first, states, opt, lr_scales), _flat(params)
            assert sorted(got["params"]) == sorted(want)
            for name in want:
                err = np.abs(got["params"][name] - want[name])
                assert np.all(err <= bounds[name]), (name, float(err.max()))
        else:
            _assert_leaves_close(got["params"], _flat(params), 1e-4, near_eps)
        np.testing.assert_allclose(got["prefill"], prefill.numpy(), rtol=1e-4, atol=1e-4)
        specs = got["specs"]
        assert any("data" in shd.spec_axes(s) for s in specs.values())
        # every split leaf is gathered once where it is used: the layers'
        # inside each layer (the hybrid's shared block at each of its
        # applications), the rest once a step; the experts by their
        # expert-parallel block
        def split(prefix):
            return sum(1 for name, s in specs.items() if name.startswith(prefix)
                       and not name.startswith("layers/experts/")
                       and [a for a in shd.gathered_axes(s, strategy) if a in ("data", "model")])
        groups = cfg.n_layers // cfg.ssm.shared_attn_every if cfg.family == "hybrid" else 0
        top = split("") - split("layers/") - split("shared/")
        assert got["gathers"]["calls"] == cfg.n_layers + groups
        assert got["gathers"]["leaves"] == (cfg.n_layers * split("layers/")
                                            + groups * split("shared/") + top)


def _float32_reduced(arch, **kw):
    return dataclasses.replace(reduced_config(arch, **kw), compute_dtype="float32")


def _elastic_rank(ckpt_dir, steps, resume, shape):
    """``train()`` on a world of ``shape``: the gathered final parameters and
    the losses (rank 0)."""
    train_mod.reduced_config = _float32_reduced
    mesh = build_mesh(plan_elastic_mesh(int(np.prod(shape)), model_parallel=shape[1]))
    out = train_mod.train("smollm-360m", steps=steps, batch=BATCH, seq=SEQ, ckpt_dir=ckpt_dir,
                          resume=resume, log_every=1, seed=0, mesh=mesh)
    params = shd.gather_tree(mesh, out["params"], out["specs"])
    return {"losses": [m["loss"] for m in out["metrics"]], "params": _flat(params),
            "mesh": dict(mesh.shape), "local_mesh": dict(train_mod.local_mesh().shape)}


def _two_runs(straight, interrupted):
    return (_elastic_rank(straight, 4, False, (2, 2)),
            _elastic_rank(interrupted, 2, False, (2, 2)))


def test_elastic_resume_equals_the_uninterrupted_run(tmp_path):
    straight, interrupted = str(tmp_path / "straight"), str(tmp_path / "interrupted")
    first = spmd.run_spmd(_two_runs, 4, device="cpu", args=(straight, interrupted),
                          timeout=300)
    resumed = spmd.run_spmd(_elastic_rank, 2, device="cpu",
                            args=(interrupted, 4, True, (1, 2)), timeout=300)
    whole, head = first[0]
    assert whole["mesh"] == head["mesh"] == {"data": 2, "model": 2}
    # the planned mesh reaches train() through its mesh argument: local_mesh's
    # rule would put 4 ranks on (1, 4)
    assert whole["local_mesh"] == {"data": 1, "model": 4}
    assert resumed[0]["mesh"] == {"data": 1, "model": 2}
    np.testing.assert_allclose(head["losses"] + resumed[0]["losses"], whole["losses"],
                               rtol=1e-5)
    for name, want in whole["params"].items():
        np.testing.assert_allclose(resumed[0]["params"][name], want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# on the card: two ranks of a world there (route "shared" on one card)
# ---------------------------------------------------------------------------

def _card_rank(arch, batch):
    """One rank on the card, mesh (1, 2): the reduced arch's float32 loss
    and gradients (gathered to the CPU), and its training kernels' launches
    by route."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.optim.tree import tree_map

    cfg = _cfg(arch)
    moe_ep = cfg.family == "moe"
    mesh = spmd.Mesh((1, 2), ("data", "model"))
    full = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    specs = param_layout(cfg, full, moe_ep=moe_ep)
    local = tree_map(lambda t: t.to(mesh.device), shd.shard_tree(mesh, full, specs))
    kernels = (fab.flash_attention_fwd_stats_kernel, fab.flash_attention_dq_kernel,
               fab.flash_attention_dkv_kernel)
    loss, grads = loss_and_grads(cfg, local, batch, tp=TP, mesh=mesh, moe_ep=moe_ep)
    torch.cuda.synchronize()
    return {"loss": float(loss), "grads": _flat(shd.gather_tree(mesh, grads, specs)),
            "launches": [dict(f.launches_by_route) for f in kernels],
            "backend": mesh.backend, "device": str(mesh.device)}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_gradients_on_the_card_equal_the_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _cfg(arch)
    batch = _batches(cfg, n=1)[0]
    ranks = spmd.run_spmd(_card_rank, 2, device="cuda", args=(arch, batch), timeout=300)
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    loss, grads = loss_and_grads(cfg, params, batch, tp=TP)
    want = _flat(grads)
    L = cfg.n_layers
    for r in ranks:
        assert r["backend"] == ("gloo" if torch.cuda.device_count() < 2 else "nccl")
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-4)
        num = sum(float(np.sum((r["grads"][k] - w) ** 2)) for k, w in want.items())
        den = sum(float(np.sum(w ** 2)) for w in want.values())
        assert np.sqrt(num / den) <= 1e-4
        # float32 at d = 16: the forward with statistics on the 3xTF32 body,
        # dQ and dK/dV on the CUDA cores, each layer once (no remat)
        assert r["launches"] == [{"wgmma": 0, "tf32x3": L, "simt": 0},
                                 {"wgmma": 0, "tf32x3": 0, "simt": L},
                                 {"wgmma": 0, "tf32x3": 0, "simt": L}]
