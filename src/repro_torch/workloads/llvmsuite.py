"""LLVM test-suite workload analogues (paper Table 2).

Each program reproduces the *structural* property that drives the paper's
per-workload result:

* ``cjson``   — a storm of tiny parser functions that call back into un-
  offloadable "libc" helpers (``py_call``): offloading saves less than the
  callbacks cost, so TECH-* stays slower than qemu (paper §4.3.1).
* ``lua``     — an interpreter dispatch loop over many short functions with a
  host-only C-API hook in the hot path: the second negative case.
* ``obsequi`` — game search with a heavy board evaluation blocked only by a
  host-side statistics print: the PFO showcase (crossings 16M → 1).
* ``oggenc``  — frame-based signal pipeline (window → FFT → quantize →
  IFFT): clean native win, no host ops.
* ``sgefa``   — blocked factorization whose pivot selection is a host-only
  ``py_call`` (data-dependent control), updates are matmul-heavy.
* ``viterbi`` — max-plus dynamic programming over time steps.
"""
from __future__ import annotations

import numpy as np

from ..core import opset
from ..core.program import Program, ProgramBuilder


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


# --------------------------------------------------------------------------
# cjson — tiny functions + libc callbacks (negative case #1)
# --------------------------------------------------------------------------

def _cjson_strtod(x):
    # "libc strtod" stand-in: trivial host-side scalar-ish transform
    return (x * np.float32(1.0000001) + np.float32(1e-7)).astype(np.float32)


opset.PY_FUNCS.setdefault("cjson_strtod", _cjson_strtod)


def build_cjson(scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    n, tokens = (32, 20) if scale == "test" else (64, 1500)
    pb = ProgramBuilder("cjson")

    f = pb.function("tok_skip", ["x"])
    a = f.emit("abs", "x")
    b = f.emit("add", a, "x")
    f.build([b])

    g = pb.function("tok_number", ["x"])
    v = g.emit(
        "py_call", "x", fn="cjson_strtod", out_avals=[((n,), "float32")]
    )
    w = g.emit("mul", v, v)
    g.build([w])

    h = pb.function("node_alloc", ["x"])
    y = h.emit("relu", "x")
    z = h.emit("add", y, "x")
    h.build([z])

    p = pb.function("parse_value", ["x"])
    s = p.call("tok_skip", "x")
    t = p.call("tok_number", s)
    u = p.call("node_alloc", t)
    v2 = p.emit("tanh", u)
    p.build([v2])

    m = pb.function("main", ["x0"])
    out = m.repeat("parse_value", tokens, "x0")
    red = m.emit("reduce_sum", out, axis=(0,))
    m.build([red])

    prog = pb.build("main")
    x0 = _rng(10).standard_normal(n).astype(np.float32) * 0.1
    return prog, [x0]


# --------------------------------------------------------------------------
# lua — dispatch loop with a host-only C-API hook (negative case #2)
# --------------------------------------------------------------------------

def _lua_api_hook(x):
    return np.asarray(x, dtype=np.float32)  # identity "C API" boundary


opset.PY_FUNCS.setdefault("lua_api_hook", _lua_api_hook)


def build_lua(scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    n, steps = (48, 20) if scale == "test" else (96, 1200)
    pb = ProgramBuilder("lua")

    arith = pb.function("op_arith", ["x"])
    a = arith.emit("mul", "x", "x")
    b = arith.emit("sub", a, "x")
    arith.build([b])

    cmpf = pb.function("op_cmp", ["x"])
    c = cmpf.emit("abs", "x")
    d = cmpf.emit("minimum", c, "x")
    cmpf.build([d])

    step = pb.function("vm_step", ["x"])
    e = step.call("op_arith", "x")
    f2 = step.call("op_cmp", e)
    g2 = step.emit(
        "py_call", f2, fn="lua_api_hook", out_avals=[((n,), "float32")]
    )
    h2 = step.emit("sigmoid", g2)
    step.build([h2])

    m = pb.function("main", ["x0"])
    out = m.repeat("vm_step", steps, "x0")
    red = m.emit("reduce_sum", out, axis=(0,))
    m.build([red])

    prog = pb.build("main")
    x0 = _rng(11).standard_normal(n).astype(np.float32) * 0.1
    return prog, [x0]


# --------------------------------------------------------------------------
# obsequi — heavy eval blocked by a host print; the PFO showcase
# --------------------------------------------------------------------------

def build_obsequi(scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    n, steps = (48, 6) if scale == "test" else (160, 250)
    pb = ProgramBuilder("obsequi")
    W1 = (_rng(12).standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    W2 = (_rng(13).standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    pb.constant("W1", W1)
    pb.constant("W2", W2)

    mg = pb.function("movegen", ["b"])
    r1 = mg.emit("roll", "b", shift=1, axis=0)
    r2 = mg.emit("add", r1, "b")
    mg.build([r2])

    ev = pb.function("eval_board", ["b"])
    ev.use_global("W1")
    ev.use_global("W2")
    h1 = ev.emit("matmul", "b", "W1")
    h2 = ev.emit("relu", h1)
    h3 = ev.emit("matmul", h2, "W2")
    h4 = ev.emit("tanh", h3)
    ev.build([h4])

    st = pb.function("search_step", ["b"])
    mv = st.call("movegen", "b")
    sc = st.call("eval_board", mv)
    nb = st.emit("add", sc, "b")
    sq = st.emit("square", nb)
    ss = st.emit("reduce_sum", sq, axis=(0, 1), keepdims=True)
    pb.constant("ob_eps", np.float32(1.0))
    st.use_global("ob_eps")
    den = st.emit("add", ss, "ob_eps")
    nrm = st.emit("rsqrt", den)
    out = st.emit("mul", nb, nrm)
    st.build([out])

    # The paper's printf case: cold safety checks around the hot search loop
    # ("usually not triggered at runtime") block whole-program offloading;
    # PFO outlines the loop itself so crossings collapse to ~1 (Fig. 5).
    m = pb.function("main", ["b0"])
    b0c = m.emit("host_print", "b0", threshold=1e8, fmt="obsequi init {}")
    b = m.repeat("search_step", steps, b0c)
    ck = m.emit("host_print", b, threshold=1e8, fmt="obsequi bound {}")
    s = m.emit("reduce_sum", ck, axis=(0, 1))
    m.build([s])

    prog = pb.build("main")
    b0 = _rng(14).standard_normal((n, n)).astype(np.float32) * 0.1
    return prog, [b0]


# --------------------------------------------------------------------------
# oggenc — FFT frame pipeline, fully offloadable
# --------------------------------------------------------------------------

def build_oggenc(scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    frame, frames = (256, 6) if scale == "test" else (2048, 120)
    pb = ProgramBuilder("oggenc")
    window = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame) / frame)).astype(np.float32)
    pb.constant("window", window)
    pb.constant("qstep", np.float32(64.0))
    pb.constant("iqstep", np.float32(1.0 / 64.0))

    enc = pb.function("encode_frame", ["x"])
    enc.use_global("window")
    enc.use_global("qstep")
    enc.use_global("iqstep")
    w = enc.emit("mul", "x", "window")
    fq = enc.emit("fft", w)
    re = enc.emit("real", fq)
    q1 = enc.emit("mul", re, "iqstep")
    q2 = enc.emit("floor", q1)
    q3 = enc.emit("mul", q2, "qstep")
    # spectral envelope feedback so the loop carry stays float32 (frame,)
    sm = enc.emit("tanh", q3)
    y = enc.emit("mul", sm, "window")
    enc.build([y])

    m = pb.function("main", ["x0"])
    y = m.repeat("encode_frame", frames, "x0")
    s = m.emit("reduce_sum", y, axis=(0,))
    m.build([s])

    prog = pb.build("main")
    x0 = _rng(15).standard_normal(frame).astype(np.float32)
    return prog, [x0]


# --------------------------------------------------------------------------
# sgefa — blocked factorization with host-side pivoting
# --------------------------------------------------------------------------

def _sgefa_pivot(x):
    # data-dependent pivot scaling (host-only decision, like ipiv search)
    m = np.max(np.abs(x))
    return (x / np.float32(m if m > 0 else 1.0)).astype(np.float32)


opset.PY_FUNCS.setdefault("sgefa_pivot", _sgefa_pivot)


def build_sgefa(scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    n, sweeps = (48, 4) if scale == "test" else (192, 40)
    pb = ProgramBuilder("sgefa")
    L = np.tril(_rng(16).standard_normal((n, n)).astype(np.float32) / np.sqrt(n), -1)
    pb.constant("L", L)

    upd = pb.function("update", ["A"])
    upd.use_global("L")
    la = upd.emit("matmul", "L", "A")
    a2 = upd.emit("sub", "A", la)
    upd.build([a2])

    sw = pb.function("sweep", ["A"])
    p = sw.emit("py_call", "A", fn="sgefa_pivot", out_avals=[((n, n), "float32")])
    u = sw.call("update", p)
    u2 = sw.call("update", u)
    sw.build([u2])

    m = pb.function("main", ["A0"])
    a = m.repeat("sweep", sweeps, "A0")
    s = m.emit("reduce_sum", a, axis=(0, 1))
    m.build([s])

    prog = pb.build("main")
    A0 = _rng(17).standard_normal((n, n)).astype(np.float32)
    return prog, [A0]


# --------------------------------------------------------------------------
# viterbi — max-plus DP
# --------------------------------------------------------------------------

def build_viterbi(scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    S, steps = (32, 8) if scale == "test" else (128, 400)
    pb = ProgramBuilder("viterbi")
    T = (_rng(18).standard_normal((S, S)) * 0.1).astype(np.float32)
    pb.constant("T", T)

    st = pb.function("dp_step", ["scores", "emis"])
    st.use_global("T")
    tot = st.emit("add", "scores", "T")              # (S,1)+(S,S) -> (S,S)
    best = st.emit("reduce_max", tot, axis=(0,), keepdims=True)  # (1,S)
    e0 = st.emit("slice", "emis", starts=(0, 0), sizes=(1, S))   # (1,S)
    ns_row = st.emit("add", best, e0)                # (1,S)
    ns = st.emit("transpose", ns_row, perm=(1, 0))   # (S,1)
    # center to keep magnitudes bounded over long horizons
    mx = st.emit("reduce_max", ns, axis=(0,), keepdims=True)
    ns2 = st.emit("sub", ns, mx)
    em2 = st.emit("roll", "emis", shift=-1, axis=0)
    st.build([ns2, em2])

    m = pb.function("main", ["s0", "emis0"])
    sc, _em = m.repeat("dp_step", steps, "s0", "emis0")
    out = m.emit("reduce_max", sc, axis=(0, 1))
    m.build([out])

    prog = pb.build("main")
    s0 = np.zeros((S, 1), dtype=np.float32)
    emis0 = (_rng(19).standard_normal((steps, S)) * 0.1).astype(np.float32)
    return prog, [s0, emis0]
