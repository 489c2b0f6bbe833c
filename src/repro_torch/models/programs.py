"""Model → Program IR lowering for the port: the model zoo's dense forward
and the decode-loop LMs.

The exported programs are framework-free IR; the port carries its own copy
of each exporter so it imports nothing of the JAX package.  Each exporter
draws the same numpy random stream in the same order as its counterpart in
the reference package, so the same ``seed`` gives bitwise-equal constants,
and :func:`export_dense_forward` names its weights as the reference does;
:func:`load_reference_constants` carries another program's weights across.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.program import Program, ProgramBuilder
from .attention_plan import plan_heads


def export_dense_forward(
    cfg: ModelConfig,
    params,
    batch: int,
    seq: int,
    *,
    with_host_check: bool = True,
    tp: int = 2,
) -> tuple[Program, list[np.ndarray]]:
    """Export a dense-family forward (the port's params) as a Program.

    Returns (program, [tokens]) with all weights as program constants, named
    as the reference's export names them (``embed/table``,
    ``layers/{i}/attn/wq``, ``ln_f/scale``, ...).  The functions are the
    natural offload units: ``embed``, per layer ``layer{i}.attn`` and
    ``layer{i}.mlp`` under ``block{i}``, and ``lm_head``; ``main`` chains
    them.  ``with_host_check=True`` inserts the paper's printf case, a
    host-side ``host_assert_finite`` between the backbone and the head,
    which makes complete cross-compilation (``native``) infeasible until
    PFO splits around it.

    The program is **batch-agnostic** (wildcard leading dim in every
    reshape).  The head is the tied embedding table, as in the reference.
    ``tp`` must give a head plan the config admits (``tp=1`` on one card).
    """
    if cfg.family != "dense":
        raise ValueError(f"export_dense_forward exports the dense family, got {cfg.family!r}")
    B = -1                                   # batch-agnostic reshapes
    pb = ProgramBuilder(f"{cfg.name}-forward")

    # stage weights as program constants
    for k, v in _flatten(params).items():
        pb.constant(k, v)

    plan = plan_heads(cfg.n_heads, cfg.n_kv_heads, tp)
    hd = cfg.head_dim_
    D = cfg.d_model

    # ---- embed ---------------------------------------------------------
    f = pb.function("embed", ["tokens"])
    f.use_global("embed/table")
    h = f.emit("embed", "embed/table", "tokens")
    f.build([h])

    # ---- per-layer functions --------------------------------------------
    for i in range(cfg.n_layers):
        at = pb.function(f"layer{i}.attn", ["x"])
        for w in ("ln1/scale", "attn/wq", "attn/wk", "attn/wv", "attn/wo"):
            at.use_global(_lname(i, w))
        n = at.emit("rmsnorm", "x", _lname(i, "ln1/scale"))

        # q/k/v: (B,T,D) @ (D, H*hd) -> (B,T,H,hd) -> (B,H,T,hd)
        def proj(fn, wname, heads):
            w2 = fn.emit("reshape", _lname(i, wname), shape=(D, heads * hd))
            y = fn.emit("matmul", n, w2)
            y = fn.emit("reshape", y, shape=(B, seq, heads, hd))
            return fn.emit("transpose", y, perm=(0, 2, 1, 3))
        q = proj(at, "attn/wq", plan.n_q_pad)
        k = proj(at, "attn/wk", plan.n_kv_phys)
        v = proj(at, "attn/wv", plan.n_kv_phys)
        q = at.emit("rope", q, theta=cfg.rope_theta)
        k = at.emit("rope", k, theta=cfg.rope_theta)
        o = at.emit("sdpa", q, k, v, causal=True)       # T == S: the flash kernel's mask
        o = at.emit("transpose", o, perm=(0, 2, 1, 3))
        o = at.emit("reshape", o, shape=(B, seq, plan.n_q_pad * hd))
        wo = at.emit("reshape", _lname(i, "attn/wo"), shape=(plan.n_q_pad * hd, D))
        o = at.emit("matmul", o, wo)
        out = at.emit("add", "x", o)
        at.build([out])

        ml = pb.function(f"layer{i}.mlp", ["x"])
        for w in ("ln2/scale", "mlp/wg", "mlp/wu", "mlp/wd"):
            ml.use_global(_lname(i, w))
        n = ml.emit("rmsnorm", "x", _lname(i, "ln2/scale"))
        g = ml.emit("matmul", n, _lname(i, "mlp/wg"))
        g = ml.emit("silu", g)
        u = ml.emit("matmul", n, _lname(i, "mlp/wu"))
        gu = ml.emit("mul", g, u)
        dn = ml.emit("matmul", gu, _lname(i, "mlp/wd"))
        out = ml.emit("add", "x", dn)
        ml.build([out])

        blk = pb.function(f"block{i}", ["x"])
        a = blk.call(f"layer{i}.attn", "x")
        b = blk.call(f"layer{i}.mlp", a)
        blk.build([b])

    # ---- head -----------------------------------------------------------
    hd_fn = pb.function("lm_head", ["x"])
    hd_fn.use_global("ln_f/scale")
    hd_fn.use_global("embed/table")
    n = hd_fn.emit("rmsnorm", "x", "ln_f/scale")
    wt = hd_fn.emit("transpose", "embed/table", perm=(1, 0))
    lg = hd_fn.emit("matmul", n, wt)
    hd_fn.build([lg])

    # ---- main -----------------------------------------------------------
    m = pb.function("main", ["tokens"])
    x = m.call("embed", "tokens")
    for i in range(cfg.n_layers):
        x = m.call(f"block{i}", x)
    if with_host_check:
        # the paper's printf case: host-side sanity check in the hot path
        x = m.emit("host_assert_finite", x, tag=f"{cfg.name}.backbone")
    lg = m.call("lm_head", x)
    mx = m.emit("reduce_max", lg, axis=(2,))
    m.build([lg, mx])

    prog = pb.build("main")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32)
    return prog, [tokens]


def _lname(i: int, w: str) -> str:
    return f"layers/{i}/{w}"


def _flatten(params) -> dict[str, np.ndarray]:
    """Flatten the stacked-layer params into per-layer float32 numpy arrays,
    named by their key paths and ordered as the reference orders them
    (dict keys sorted at every level; each stacked leaf split into layers
    ``0..L-1`` before the next leaf)."""
    flat: dict[str, np.ndarray] = {}

    def visit(parts, node):
        if isinstance(node, Mapping):
            for key in sorted(node):
                visit(parts + [str(key)], node[key])
            return
        arr = node.detach().to("cpu", torch.float32).numpy()
        if parts[0] == "layers":
            for i in range(arr.shape[0]):      # stacked on axis 0: split per layer
                flat[_lname(i, "/".join(parts[1:]))] = arr[i]
        else:
            flat["/".join(parts)] = arr

    visit([], params)
    return flat


def export_decode_lm(
    vocab: int = 64,
    d_model: int = 32,
    *,
    with_host_check: bool = True,
    seed: int = 0,
) -> Program:
    """Export a tiny recurrent LM as a **decode-loop program**.

    The program has two roots, the shape
    :class:`~repro_torch.serve.DecodeScheduler` consumes:

    * entry ``prefill(tokens)`` — tokens ``(B, T)`` int32 →
      ``(logits (B, V), h (B, D))``: encode the whole prompt into a
      fixed-size recurrent state plus the logits for the first generated
      token.
    * ``decode_step(h, token)`` — state ``(B, D)`` + last token ``(B,)``
      int32 → ``(logits (B, V), h' (B, D))``: one autoregressive step.

    Both roots route through the same ``head`` function, so planning the
    step via ``planned.for_entry("decode_step")`` shares its offload unit
    with the prefill plan (one head compile serves both).

    Every op is row-independent on axis 0 (batch-parallel), which is what
    makes token-level re-batching bit-exact: a sequence decoded inside any
    padded batch produces exactly the tokens it would produce alone.

    ``with_host_check`` keeps the paper's printf case in both roots — a
    host-only finiteness assertion between backbone and head — so neither
    root can be offloaded whole and every prefill/step call really pays
    guest→host crossings (the fixed cost the scheduler amortizes).
    """
    rng = np.random.default_rng(seed)
    W = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)

    pb = ProgramBuilder("decode-lm")
    pb.constant("E", W(vocab, d_model))       # embedding table
    pb.constant("Wp", W(d_model, d_model))    # prompt encoder mix
    pb.constant("Wh", W(d_model, d_model))    # state recurrence
    pb.constant("Wi", W(d_model, d_model))    # token input mix
    pb.constant("Wo", W(d_model, vocab))      # LM head

    # head(h) -> logits: shared by prefill and decode_step (one offload unit)
    head = pb.function("head", ["h"])
    head.use_global("Wo")
    lg = head.emit("matmul", "h", "Wo")
    head.build([lg])

    # backbone(h, e) -> h': the per-step recurrent cell
    cell = pb.function("backbone", ["h", "e"])
    for w in ("Wh", "Wi"):
        cell.use_global(w)
    a = cell.emit("matmul", "h", "Wh")
    b = cell.emit("matmul", "e", "Wi")
    s = cell.emit("add", a, b)
    hn = cell.emit("tanh", s)
    cell.build([hn])

    # encode(tokens) -> h0: whole-prompt encoder (the prefill backbone)
    enc = pb.function("encode", ["tokens"])
    for w in ("E", "Wp"):
        enc.use_global(w)
    e = enc.emit("embed", "E", "tokens")              # (B, T, D)
    x = enc.emit("matmul", e, "Wp")
    x = enc.emit("tanh", x)
    h0 = enc.emit("reduce_mean", x, axis=(1,))        # (B, D)
    enc.build([h0])

    # prefill(tokens) -> (logits, h): program entry
    pf = pb.function("prefill", ["tokens"])
    h = pf.call("encode", "tokens")
    if with_host_check:
        h = pf.emit("host_assert_finite", h, tag="decode-lm.prefill")
    lg = pf.call("head", h)
    pf.build([lg, h])

    # decode_step(h, token) -> (logits, h'): the per-token root
    st = pb.function("decode_step", ["h", "token"])
    st.use_global("E")
    e = st.emit("embed", "E", "token")                # (B, D)
    hn = st.call("backbone", "h", e)
    if with_host_check:
        hn = st.emit("host_assert_finite", hn, tag="decode-lm.step")
    lg = st.call("head", hn)
    st.build([lg, hn])

    # decode_step is unreachable from the prefill entry by design;
    # Program.validate still checks every function, reachable or not
    return pb.build("prefill")


def export_attn_decode_lm(
    vocab: int = 32,
    d_model: int = 16,
    max_context: int = 32,
    *,
    with_host_check: bool = True,
    seed: int = 0,
) -> Program:
    """Export a single-head causal-attention LM as a **decode-loop program**
    whose per-stream KV state *grows with context* — the paged-state workload
    of :class:`~repro_torch.serve.DecodeScheduler` (see
    :class:`~repro_torch.serve.StateSpec`).

    Two roots, padded to the program's fixed ``max_context`` (``S``) so every
    step call keeps one entry signature:

    * entry ``prefill(tokens)`` — tokens ``(B, T)`` int32 →
      ``(logits (B, V), K (B, S, D), V (B, S, D), len (B,))``: causal
      self-attention over the whole prompt; K/V are zero-padded from ``T``
      up to ``S`` and ``len`` records the filled prefix (= ``T``).
    * ``decode_step(K, V, len, token)`` — writes the new token's k/v row at
      position ``len`` (a ``where`` select, so every already-written row
      passes through **bitwise unchanged** — what makes paged storage of
      old rows exact), attends over positions ``< len + 1``, and returns
      ``(logits, K', V', len + 1)``.
    * ``prefill_suffix(K, V, len, tokens)`` — the **prefix-sharing prefill**
      (see :class:`~repro_torch.serve.DecodeScheduler`'s ``prefill_suffix``):
      consumes K/V whose first ``len`` positions are already cached (mapped
      from shared pages) plus the full token row, and merges with a
      ``where`` select over ``pos < len`` — cached rows pass through
      **bitwise unchanged** (shared pages stay bitwise-stable), while
      positions ``>= len`` take freshly computed rows.  The recomputation
      routes through the *same* ``encode`` function as ``prefill`` — the
      same offload unit at the same signature — so a prefix-shared stream's
      logits and suffix K/V rows are bit-identical to the ones its own solo
      prefill would have produced.  (In this fixed-shape IR nothing gets
      cheaper by skipping positions — every call runs at padded shapes —
      so what sharing buys is *page storage*: the prefix rows are never
      re-stored, and the serving layer maps them read-only.)
    * ``paged_decode_step(Kp, Vp, tables, len, token)`` — the
      **block-sparse** step root: consumes the page-pool backing buffers
      ``(P, page_size, D)`` and per-stream block tables directly (no dense
      padded K/V at the crossing), attends via the ``paged_attention`` op —
      the CUDA paged kernel on the card — over live pages plus the fresh
      token's k/v row, and returns ``(logits, k_row, v_row)`` for the
      scheduler to append host-side.  Per-step attention FLOPs scale with
      live pages instead of ``max_context``.

    All roots route through the shared ``head`` function (one offload unit
    via ``planned.for_entry``), every op is row-independent on axis 0, and
    ``with_host_check`` keeps the paper's printf case in every root so each
    prefill/step genuinely pays guest→host crossings.

    Masked cache positions (``>= len``) contribute exactly nothing: both
    the prefill's ``pad_to`` and the step's select keep them at 0.0, and
    the attention mask sends their scores to -1e30 before the softmax — so
    a scheduler that reconstructs K/V from pages plus a zero template feeds
    the step bit-identical inputs to solo decoding.
    """
    rng = np.random.default_rng(seed)
    D, S = d_model, int(max_context)
    W = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)

    pb = ProgramBuilder("attn-decode-lm")
    pb.constant("E", W(vocab, D))             # embedding table
    pb.constant("Wq", W(D, D))
    pb.constant("Wk", W(D, D))
    pb.constant("Wv", W(D, D))
    pb.constant("Wp", W(D, D))                # attention output projection
    pb.constant("Wo", W(D, vocab))            # LM head
    pb.constant("pos", np.arange(S, dtype=np.int32))
    pb.constant("one_i", np.array(1, np.int32))
    pb.constant("scale", np.array(1.0 / np.sqrt(D), np.float32))
    pb.constant("neg_inf", np.array(-1e30, np.float32))

    # head(h) -> logits: shared by prefill and decode_step (one offload unit)
    head = pb.function("head", ["h"])
    head.use_global("Wo")
    lg = head.emit("matmul", "h", "Wo")
    head.build([lg])

    # encode(tokens) -> (h_last, K, V, len): the prefill backbone
    enc = pb.function("encode", ["tokens"])
    for w in ("E", "Wq", "Wk", "Wv", "Wp", "pos", "one_i"):
        enc.use_global(w)
    e = enc.emit("embed", "E", "tokens")                      # (B, T, D)
    q = enc.emit("matmul", e, "Wq")
    k = enc.emit("matmul", e, "Wk")
    v = enc.emit("matmul", e, "Wv")
    a = enc.emit("sdpa",
                 enc.emit("expand_dims", q, axis=1),
                 enc.emit("expand_dims", k, axis=1),
                 enc.emit("expand_dims", v, axis=1), causal=True)
    a = enc.emit("squeeze", a, axis=1)                        # (B, T, D)
    h = enc.emit("tanh", enc.emit("add", enc.emit("matmul", a, "Wp"), e))
    # len = T for every row, derived in-program so the entry stays unary
    ones = enc.emit("cast", enc.emit("eq", "tokens", "tokens"), dtype="int32")
    ln = enc.emit("reduce_sum", ones, axis=(1,))              # (B,) = T
    # select the last prompt position via a one-hot matmul over the padded
    # context axis (slice starts are static; T is not)
    last = enc.emit("expand_dims", enc.emit("sub", ln, "one_i"), axis=1)
    oh = enc.emit("cast", enc.emit("eq", "pos", last), dtype="float32")
    hp = enc.emit("pad_to", h, axis=1, target=S)              # (B, S, D)
    h_last = enc.emit("squeeze",
                      enc.emit("matmul", enc.emit("expand_dims", oh, axis=1), hp),
                      axis=1)                                 # (B, D)
    kp = enc.emit("pad_to", k, axis=1, target=S)
    vp = enc.emit("pad_to", v, axis=1, target=S)
    enc.build([h_last, kp, vp, ln])

    # attend(K, V, len, token) -> (h, K', V', len'): one decode step
    at = pb.function("attend", ["K", "V", "len", "token"])
    for w in ("E", "Wq", "Wk", "Wv", "Wp", "pos", "one_i", "scale", "neg_inf"):
        at.use_global(w)
    e = at.emit("embed", "E", "token")                        # (B, D)
    q = at.emit("matmul", e, "Wq")
    kn = at.emit("matmul", e, "Wk")
    vn = at.emit("matmul", e, "Wv")
    # write k/v at position `len` with a select: rows != len pass through
    # bitwise untouched (no *1 + 0 arithmetic), so old cache rows never
    # change after they are written — the paged-state exactness hook
    wcol = at.emit("expand_dims",
                   at.emit("eq", "pos", at.emit("expand_dims", "len", axis=1)),
                   axis=2)                                    # (B, S, 1) bool
    K2 = at.emit("where", wcol, at.emit("expand_dims", kn, axis=1), "K")
    V2 = at.emit("where", wcol, at.emit("expand_dims", vn, axis=1), "V")
    ln2 = at.emit("add", "len", "one_i")                      # (B,)
    # causal mask: attend to the filled prefix incl. the new row (< len')
    mask = at.emit("expand_dims",
                   at.emit("lt", "pos", at.emit("expand_dims", ln2, axis=1)),
                   axis=1)                                    # (B, 1, S) bool
    s = at.emit("mul",
                at.emit("matmul",
                        at.emit("expand_dims", q, axis=1),
                        at.emit("transpose", K2, perm=(0, 2, 1))),
                "scale")                                      # (B, 1, S)
    s = at.emit("where", mask, s, "neg_inf")
    p = at.emit("softmax", s, axis=-1)
    a = at.emit("squeeze", at.emit("matmul", p, V2), axis=1)  # (B, D)
    h = at.emit("tanh", at.emit("add", at.emit("matmul", a, "Wp"), e))
    at.build([h, K2, V2, ln2])

    # prefill(tokens) -> (logits, K, V, len): program entry
    pf = pb.function("prefill", ["tokens"])
    h, kp, vp, ln = pf.call("encode", "tokens")
    if with_host_check:
        h = pf.emit("host_assert_finite", h, tag="attn-lm.prefill")
    lg = pf.call("head", h)
    pf.build([lg, kp, vp, ln])

    # decode_step(K, V, len, token) -> (logits, K', V', len'): per-token root
    st = pb.function("decode_step", ["K", "V", "len", "token"])
    h, K2, V2, ln2 = st.call("attend", "K", "V", "len", "token")
    if with_host_check:
        h = st.emit("host_assert_finite", h, tag="attn-lm.step")
    lg = st.call("head", h)
    st.build([lg, K2, V2, ln2])

    # prefill_suffix(K, V, len, tokens) -> (logits, K', V', len'): the
    # prefix-sharing prefill root.  Same encode/head calls as `prefill` (one
    # offload unit each, shared through the plan's unit cache), then a select
    # that keeps the first `len` cached positions bitwise and takes the
    # recomputed rows elsewhere — `where` is pure selection, so the merge is
    # exact however the engine routes it (offloaded or emulated).
    sf = pb.function("prefill_suffix", ["K", "V", "len", "tokens"])
    sf.use_global("pos")
    h, kn, vn, ln = sf.call("encode", "tokens")
    if with_host_check:
        h = sf.emit("host_assert_finite", h, tag="attn-lm.suffix")
    lg = sf.call("head", h)
    keep = sf.emit("expand_dims",
                   sf.emit("lt", "pos", sf.emit("expand_dims", "len", axis=1)),
                   axis=2)                                    # (B, S, 1) bool
    K2 = sf.emit("where", keep, "K", kn)
    V2 = sf.emit("where", keep, "V", vn)
    sf.build([lg, K2, V2, ln])

    # paged_attend(Kp, Vp, tables, len, token) -> (h, kn, vn): the
    # block-sparse decode backbone.  Kp/Vp are the scheduler's page-pool
    # backing buffers (P, page_size, D) — NOT per-stream dense state —
    # tables (B, NP) int32 maps each stream's logical pages to physical
    # ones, and the `paged_attention` op (the CUDA kernel on the card)
    # attends over live pages plus the fresh kn/vn row at position `len`.
    # The fresh rows are *returned* instead of written: the scheduler
    # appends them into the paged store host-side, so no dense K/V is ever
    # re-materialized at the crossing.
    pa = pb.function("paged_attend", ["Kp", "Vp", "tables", "len", "token"])
    for w in ("E", "Wq", "Wk", "Wv", "Wp"):
        pa.use_global(w)
    e = pa.emit("embed", "E", "token")                        # (B, D)
    q = pa.emit("matmul", e, "Wq")
    kn = pa.emit("matmul", e, "Wk")
    vn = pa.emit("matmul", e, "Wv")
    a = pa.emit("paged_attention", q, kn, vn, "Kp", "Vp", "tables", "len")
    h = pa.emit("tanh", pa.emit("add", pa.emit("matmul", a, "Wp"), e))
    pa.build([h, kn, vn])

    # paged_decode_step(Kp, Vp, tables, len, token) -> (logits, kn, vn):
    # the per-token root of the paged-kernel scheduler mode
    pg = pb.function("paged_decode_step", ["Kp", "Vp", "tables", "len",
                                           "token"])
    h, kn, vn = pg.call("paged_attend", "Kp", "Vp", "tables", "len", "token")
    if with_host_check:
        h = pg.emit("host_assert_finite", h, tag="attn-lm.paged-step")
    lg = pg.call("head", h)
    pg.build([lg, kn, vn])

    return pb.build("prefill")


def export_mamba2_decode_lm(
    vocab: int = 32,
    d_model: int = 16,
    state_dim: int = 4,
    head_dim: int = 4,
    *,
    with_host_check: bool = True,
    seed: int = 0,
) -> Program:
    """Export a single-head SSD (mamba2-style) LM as a **decode-loop program**
    whose per-stream state is **fixed-size** — the degenerate
    ``StateSpec(growing={})`` workload of
    :class:`~repro_torch.serve.DecodeScheduler`:
    no paging, no per-token growth, a constant ``N*P`` floats per stream.

    Two roots:

    * entry ``prefill(tokens)`` — tokens ``(B, T)`` int32 →
      ``(logits (B, V), S (B, N*P))``: the SSD recurrence
      ``S_t = exp(dt_t·A)·S_{t-1} + dt_t·(B_t ⊗ x_t)`` over the whole
      prompt in closed form (cumulative-sum decays, one weighted
      reduction — no sequential scan op), with the *last* prompt token
      routed through the same ``cell`` function the step uses.
    * ``decode_step(S, token)`` — state ``(B, N*P)`` + last token ``(B,)``
      int32 → ``(logits, S')``: one recurrence step.

    The state is carried **rank-2** ``(B, N*P)`` on purpose: the SSD update
    is arithmetic (decay-and-add), so rows are *recomputed*, not
    pass-through — the recurrent-state exactness contract (see
    ``docs/analysis.md``), not the rank-≥3 cache contract that demands
    bitwise row preservation.  The ``N × P`` outer products and
    contractions are phrased as matmuls against constant 0/1
    Khatri-Rao matrices (``Kn``/``Kp``/``Cp``) so no root ever reshapes
    activations (decode roots must stay wildcard-reshape-free).

    Every op is row-independent on axis 0, so token-level re-batching is
    bit-exact, and ``with_host_check`` keeps the paper's printf case in
    both roots (every prefill/step pays real guest→host crossings).
    """
    rng = np.random.default_rng(seed)
    D, N, P = d_model, int(state_dim), int(head_dim)
    W = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)

    # Khatri-Rao helpers: slot n*P+p of the flat (N*P,) state holds S[n, p]
    Kn = np.zeros((N, N * P), np.float32)   # broadcast over p: Kn[n, n*P+p]=1
    Kp = np.zeros((P, N * P), np.float32)   # broadcast over n: Kp[p, n*P+p]=1
    for n in range(N):
        for p in range(P):
            Kn[n, n * P + p] = 1.0
            Kp[p, n * P + p] = 1.0

    pb = ProgramBuilder("mamba2-decode-lm")
    pb.constant("E", W(vocab, D))             # embedding table
    pb.constant("W_dt", W(D, 1))              # step-size projection
    pb.constant("W_B", W(D, N))               # input projection (B_t)
    pb.constant("W_C", W(D, N))               # output projection (C_t)
    pb.constant("W_x", W(D, P))               # head-input projection
    pb.constant("W_z", W(D, P))               # gate projection
    pb.constant("W_out", W(P, D))             # head-output projection
    pb.constant("Wo", W(D, vocab))            # LM head
    pb.constant("Kn", Kn)
    pb.constant("Kp", Kp)
    pb.constant("Cp", Kp.T.copy())            # contract slots back to (P,)
    pb.constant("A", np.array(-1.0, np.float32))  # decay rate (A_log = 0)

    # head(h) -> logits: shared by prefill and decode_step (one offload unit)
    head = pb.function("head", ["h"])
    head.use_global("Wo")
    lg = head.emit("matmul", "h", "Wo")
    head.build([lg])

    # cell(S, e) -> (h, S'): one SSD recurrence step on embedded input e.
    # Shared by decode_step and prefill's last position, so the prefill's
    # final update is the *same unit at the same signature* as a step.
    cell = pb.function("cell", ["S", "e"])
    for w in ("W_dt", "W_B", "W_C", "W_x", "W_z", "W_out", "Kn", "Kp", "Cp", "A"):
        cell.use_global(w)
    dt = cell.emit("sigmoid", cell.emit("matmul", "e", "W_dt"))   # (B, 1)
    dec = cell.emit("exp", cell.emit("mul", dt, "A"))             # (B, 1)
    b1 = cell.emit("matmul", "e", "W_B")                          # (B, N)
    xdt = cell.emit("mul", cell.emit("matmul", "e", "W_x"), dt)   # (B, P)
    # outer product B_t ⊗ (dt·x_t), flattened: slot n*P+p = b1[n] * xdt[p]
    u = cell.emit("mul",
                  cell.emit("matmul", b1, "Kn"),
                  cell.emit("matmul", xdt, "Kp"))                 # (B, N*P)
    S2 = cell.emit("add", cell.emit("mul", "S", dec), u)          # (B, N*P)
    # y[p] = Σ_n C_t[n] · S'[n, p] — contraction via the same slot layout
    c1 = cell.emit("matmul", "e", "W_C")                          # (B, N)
    y = cell.emit("matmul",
                  cell.emit("mul", cell.emit("matmul", c1, "Kn"), S2),
                  "Cp")                                           # (B, P)
    g = cell.emit("mul", y, cell.emit("silu", cell.emit("matmul", "e", "W_z")))
    h = cell.emit("tanh", cell.emit("add", cell.emit("matmul", g, "W_out"), "e"))
    cell.build([h, S2])

    # encode(tokens) -> (h, S'): whole-prompt SSD in closed form.  The scan
    #   S_t = dec_t · S_{t-1} + u_t  with S_0 = 0
    # has solution  S_{T-1} = Σ_{t<T-1} u_t · exp(Σ_{t<s≤T-1} dA_s), computed
    # with cumsum weights; the final token then routes through `cell`.
    enc = pb.function("encode", ["tokens"])
    for w in ("E", "W_dt", "W_B", "W_x", "Kn", "Kp", "A"):
        enc.use_global(w)
    e = enc.emit("embed", "E", "tokens")                          # (B, T, D)
    dt = enc.emit("sigmoid", enc.emit("matmul", e, "W_dt"))       # (B, T, 1)
    dA = enc.emit("mul", dt, "A")                                 # (B, T, 1)
    # position index 1..T, derived in-program so the entry stays unary
    ones = enc.emit("cast", enc.emit("eq", "tokens", "tokens"), dtype="float32")
    idx = enc.emit("cumsum", ones, axis=1)                        # (B, T) = 1..T
    mx = enc.emit("reduce_max", idx, axis=(1,), keepdims=True)    # (B, 1) = T
    # prefix mask: positions strictly before the last one
    fm = enc.emit("expand_dims",
                  enc.emit("cast", enc.emit("lt", idx, mx), dtype="float32"),
                  axis=2)                                         # (B, T, 1)
    dAm = enc.emit("mul", dA, fm)
    cs = enc.emit("cumsum", dAm, axis=1)                          # (B, T, 1)
    tot = enc.emit("reduce_sum", dAm, axis=(1,), keepdims=True)   # (B, 1, 1)
    wts = enc.emit("exp", enc.emit("sub", tot, cs))               # (B, T, 1)
    b1 = enc.emit("matmul", e, "W_B")                             # (B, T, N)
    xdt = enc.emit("mul", enc.emit("matmul", e, "W_x"), dt)       # (B, T, P)
    u = enc.emit("mul",
                 enc.emit("matmul", b1, "Kn"),
                 enc.emit("matmul", xdt, "Kp"))                   # (B, T, N*P)
    up = enc.emit("mul", u, enc.emit("mul", wts, fm))
    S_prev = enc.emit("reduce_sum", up, axis=(1,))                # (B, N*P)
    # select the last prompt embedding with a one-hot matmul (T is dynamic)
    oh = enc.emit("cast", enc.emit("eq", idx, mx), dtype="float32")
    e_last = enc.emit("squeeze",
                      enc.emit("matmul", enc.emit("expand_dims", oh, axis=1), e),
                      axis=1)                                     # (B, D)
    h, S2 = enc.call("cell", S_prev, e_last)
    enc.build([h, S2])

    # prefill(tokens) -> (logits, S): program entry
    pf = pb.function("prefill", ["tokens"])
    h, S2 = pf.call("encode", "tokens")
    if with_host_check:
        h = pf.emit("host_assert_finite", h, tag="mamba2-lm.prefill")
    lg = pf.call("head", h)
    pf.build([lg, S2])

    # decode_step(S, token) -> (logits, S'): the per-token root
    st = pb.function("decode_step", ["S", "token"])
    st.use_global("E")
    e = st.emit("embed", "E", "token")                            # (B, D)
    h, S2 = st.call("cell", "S", e)
    if with_host_check:
        h = st.emit("host_assert_finite", h, tag="mamba2-lm.step")
    lg = st.call("head", h)
    st.build([lg, S2])

    return pb.build("prefill")


def export_moe_decode_lm(
    vocab: int = 32,
    d_model: int = 16,
    max_context: int = 32,
    n_experts: int = 4,
    d_ff: int = 16,
    *,
    with_host_check: bool = True,
    seed: int = 0,
) -> Program:
    """Export a single-head attention + top-1 mixture-of-experts LM as a
    **decode-loop program** — the growing-KV workload of
    :func:`export_attn_decode_lm` plus per-token expert routing.

    The state contract is identical to the attention LM (and obeys the same
    exactness discipline): ``prefill(tokens)`` → ``(logits, K (B,S,D),
    V (B,S,D), len (B,))`` with K/V zero-``pad_to``-ed to ``max_context``,
    ``decode_step(K, V, len, token)`` writes the fresh k/v row with a
    ``where`` select (old rows pass through **bitwise unchanged**, so the
    cache pages exactly), and ``prefill_suffix`` merges cached prefix rows
    with a ``where`` over ``pos < len`` for prefix sharing.  There is no
    ``paged_decode_step`` — the paged-kernel mode stays attention-only.

    What MoE adds is the routed FFN after the attention mix: a router
    softmax picks the arg-max expert per token (top-1, selected with an
    ``eq``-against-``reduce_max`` one-hot — pure selection, no ``top_k``
    op), every expert's gated MLP runs at padded shape, and the one-hot
    times the gate weight combines them.  Routing is row-independent on
    axis 0, so a stream's expert choices — and therefore its logits — are
    bit-identical however it is batched.
    """
    rng = np.random.default_rng(seed)
    D, S, E, F = d_model, int(max_context), int(n_experts), int(d_ff)
    W = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)

    pb = ProgramBuilder("moe-decode-lm")
    pb.constant("E", W(vocab, D))             # embedding table
    pb.constant("Wq", W(D, D))
    pb.constant("Wk", W(D, D))
    pb.constant("Wv", W(D, D))
    pb.constant("Wp", W(D, D))                # attention output projection
    pb.constant("Wr", W(D, E))                # router
    pb.constant("Wg", (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32))
    pb.constant("Wu", (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32))
    pb.constant("Wd", (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32))
    pb.constant("Wo", W(D, vocab))            # LM head
    pb.constant("pos", np.arange(S, dtype=np.int32))
    pb.constant("one_i", np.array(1, np.int32))
    pb.constant("scale", np.array(1.0 / np.sqrt(D), np.float32))
    pb.constant("neg_inf", np.array(-1e30, np.float32))

    # head(h) -> logits: shared by all roots (one offload unit)
    head = pb.function("head", ["h"])
    head.use_global("Wo")
    lg = head.emit("matmul", "h", "Wo")
    head.build([lg])

    # moe_ffn(x) -> y: top-1 routed expert MLP, rank-agnostic — called at
    # (B, T, D) from encode and (B, D) from attend (negative axes keep one
    # function body valid at both ranks; each call site is its own entry
    # signature / offload unit).
    ffn = pb.function("moe_ffn", ["x"])
    for w in ("Wr", "Wg", "Wu", "Wd"):
        ffn.use_global(w)
    gates = ffn.emit("softmax", ffn.emit("matmul", "x", "Wr"), axis=-1)  # (..., E)
    mx = ffn.emit("reduce_max", gates, axis=(-1,), keepdims=True)
    # top-1 one-hot via eq-against-max (pure selection; ties are
    # deterministic and row-independent, so still bit-stable)
    sel = ffn.emit("cast", ffn.emit("eq", gates, mx), dtype="float32")
    gw = ffn.emit("mul", sel, gates)                                     # (..., E)
    # run every expert at padded shape: (..., 1, 1, D) @ (E, D, F)
    xb = ffn.emit("expand_dims", ffn.emit("expand_dims", "x", axis=-2), axis=-2)
    hg = ffn.emit("silu", ffn.emit("matmul", xb, "Wg"))                  # (..., E, 1, F)
    hu = ffn.emit("matmul", xb, "Wu")
    hd = ffn.emit("squeeze",
                  ffn.emit("matmul", ffn.emit("mul", hg, hu), "Wd"),
                  axis=-2)                                               # (..., E, D)
    y = ffn.emit("reduce_sum",
                 ffn.emit("mul", hd, ffn.emit("expand_dims", gw, axis=-1)),
                 axis=(-2,))                                             # (..., D)
    ffn.build([y])

    # encode(tokens) -> (h_last, K, V, len): the prefill backbone — same
    # attention shape as attn-decode-lm, with the routed FFN after the mix
    enc = pb.function("encode", ["tokens"])
    for w in ("E", "Wq", "Wk", "Wv", "Wp", "pos", "one_i"):
        enc.use_global(w)
    e = enc.emit("embed", "E", "tokens")                      # (B, T, D)
    q = enc.emit("matmul", e, "Wq")
    k = enc.emit("matmul", e, "Wk")
    v = enc.emit("matmul", e, "Wv")
    a = enc.emit("sdpa",
                 enc.emit("expand_dims", q, axis=1),
                 enc.emit("expand_dims", k, axis=1),
                 enc.emit("expand_dims", v, axis=1), causal=True)
    a = enc.emit("squeeze", a, axis=1)                        # (B, T, D)
    r = enc.emit("tanh", enc.emit("add", enc.emit("matmul", a, "Wp"), e))
    m = enc.call("moe_ffn", r)
    h = enc.emit("tanh", enc.emit("add", m, r))
    ones = enc.emit("cast", enc.emit("eq", "tokens", "tokens"), dtype="int32")
    ln = enc.emit("reduce_sum", ones, axis=(1,))              # (B,) = T
    last = enc.emit("expand_dims", enc.emit("sub", ln, "one_i"), axis=1)
    oh = enc.emit("cast", enc.emit("eq", "pos", last), dtype="float32")
    hp = enc.emit("pad_to", h, axis=1, target=S)              # (B, S, D)
    h_last = enc.emit("squeeze",
                      enc.emit("matmul", enc.emit("expand_dims", oh, axis=1), hp),
                      axis=1)                                 # (B, D)
    kp = enc.emit("pad_to", k, axis=1, target=S)
    vp = enc.emit("pad_to", v, axis=1, target=S)
    enc.build([h_last, kp, vp, ln])

    # attend(K, V, len, token) -> (h, K', V', len'): one decode step; the
    # k/v write is a where-select so old cache rows never change (the
    # paged-state exactness hook, same as attn-decode-lm)
    at = pb.function("attend", ["K", "V", "len", "token"])
    for w in ("E", "Wq", "Wk", "Wv", "Wp", "pos", "one_i", "scale", "neg_inf"):
        at.use_global(w)
    e = at.emit("embed", "E", "token")                        # (B, D)
    q = at.emit("matmul", e, "Wq")
    kn = at.emit("matmul", e, "Wk")
    vn = at.emit("matmul", e, "Wv")
    wcol = at.emit("expand_dims",
                   at.emit("eq", "pos", at.emit("expand_dims", "len", axis=1)),
                   axis=2)                                    # (B, S, 1) bool
    K2 = at.emit("where", wcol, at.emit("expand_dims", kn, axis=1), "K")
    V2 = at.emit("where", wcol, at.emit("expand_dims", vn, axis=1), "V")
    ln2 = at.emit("add", "len", "one_i")                      # (B,)
    mask = at.emit("expand_dims",
                   at.emit("lt", "pos", at.emit("expand_dims", ln2, axis=1)),
                   axis=1)                                    # (B, 1, S) bool
    s = at.emit("mul",
                at.emit("matmul",
                        at.emit("expand_dims", q, axis=1),
                        at.emit("transpose", K2, perm=(0, 2, 1))),
                "scale")                                      # (B, 1, S)
    s = at.emit("where", mask, s, "neg_inf")
    p = at.emit("softmax", s, axis=-1)
    a = at.emit("squeeze", at.emit("matmul", p, V2), axis=1)  # (B, D)
    r = at.emit("tanh", at.emit("add", at.emit("matmul", a, "Wp"), e))
    m = at.call("moe_ffn", r)
    h = at.emit("tanh", at.emit("add", m, r))
    at.build([h, K2, V2, ln2])

    # prefill(tokens) -> (logits, K, V, len): program entry
    pf = pb.function("prefill", ["tokens"])
    h, kp, vp, ln = pf.call("encode", "tokens")
    if with_host_check:
        h = pf.emit("host_assert_finite", h, tag="moe-lm.prefill")
    lg = pf.call("head", h)
    pf.build([lg, kp, vp, ln])

    # decode_step(K, V, len, token) -> (logits, K', V', len')
    st = pb.function("decode_step", ["K", "V", "len", "token"])
    h, K2, V2, ln2 = st.call("attend", "K", "V", "len", "token")
    if with_host_check:
        h = st.emit("host_assert_finite", h, tag="moe-lm.step")
    lg = st.call("head", h)
    st.build([lg, K2, V2, ln2])

    # prefill_suffix(K, V, len, tokens): prefix-sharing prefill — cached
    # rows pass through the where bitwise, recomputed rows elsewhere
    sf = pb.function("prefill_suffix", ["K", "V", "len", "tokens"])
    sf.use_global("pos")
    h, kn, vn, ln = sf.call("encode", "tokens")
    if with_host_check:
        h = sf.emit("host_assert_finite", h, tag="moe-lm.suffix")
    lg = sf.call("head", h)
    keep = sf.emit("expand_dims",
                   sf.emit("lt", "pos", sf.emit("expand_dims", "len", axis=1)),
                   axis=2)                                    # (B, S, 1) bool
    K2 = sf.emit("where", keep, "K", kn)
    V2 = sf.emit("where", keep, "V", vn)
    sf.build([lg, K2, V2, ln])

    return pb.build("prefill")


def load_reference_constants(program: Program,
                             constants: Mapping[str, np.ndarray]) -> Program:
    """Install ``constants`` (e.g. the reference program's
    ``Program.constants``) as ``program``'s weights, in place.

    Names, shapes and dtypes must match ``program``'s own constants exactly,
    so a program exported with other widths (or another exporter) is refused
    rather than silently mixed.  Returns ``program``.
    """
    mine = program.constants
    if set(constants) != set(mine):
        missing = sorted(set(mine) - set(constants))
        extra = sorted(set(constants) - set(mine))
        raise ValueError(
            f"constant names differ: missing {missing}, unexpected {extra}")
    staged = {}
    for name, value in constants.items():
        value = np.asarray(value)
        if value.shape != mine[name].shape or value.dtype != mine[name].dtype:
            raise ValueError(
                f"constant {name!r}: got {value.dtype}{list(value.shape)}, "
                f"program has {mine[name].dtype}{list(mine[name].shape)}")
        staged[name] = np.array(value)
    mine.update(staged)
    return program
