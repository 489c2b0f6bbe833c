"""NAS Parallel Benchmark analogues (paper Table 2, complete set).

Structural stand-ins capturing each benchmark's compute character:

* ``npbep`` — embarrassingly parallel pseudo-random transform + reductions,
  with a rare host-side range check (the printf case).
* ``npbcg`` — conjugate-gradient iterations (matvec + dots + axpys).
* ``npbft`` — FFT evolve loop (fft → spectral multiply → ifft).
* ``npbmg`` — multigrid V-cycle (smooth, restrict, coarse solve, prolong).
* ``npbbt``/``npbsp``/``npblu`` — block-structured implicit solvers:
  directional sweeps of batched small-block matmuls + relaxation (npbsp
  carries a host-side stability check).
* ``npbis`` — integer-sort analogue (key generation, sort, prefix sums).
"""
from __future__ import annotations

import numpy as np

from ..core.program import Program, ProgramBuilder


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def build_npbep(scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    n, steps = (4096, 6) if scale == "test" else (262144, 60)
    pb = ProgramBuilder("npbep")
    pb.constant("a", np.float32(1220703125.0 % 1.0 + 0.61803))
    pb.constant("c", np.float32(0.31830988))
    pb.constant("one", np.float32(1.0))

    g = pb.function("gen_block", ["x"])
    for name in ("a", "c", "one"):
        g.use_global(name)
    t1 = g.emit("mul", "x", "a")
    t2 = g.emit("add", t1, "c")
    fl = g.emit("floor", t2)
    x2 = g.emit("sub", t2, fl)              # fract: uniform (0,1)
    # Box-Muller-ish magnitude (no trig op needed: use sqrt(-2 ln u))
    sm = g.emit("maximum", x2, "c")          # avoid log(0)
    lg = g.emit("log", sm)
    ng = g.emit("neg", lg)
    mag = g.emit("sqrt", ng)
    g.build([x2, mag])

    m = pb.function("main", ["x0"])
    x, mag = m.repeat("gen_block", steps, "x0", carry=1)
    chk = m.emit("host_print", mag, threshold=1e4, fmt="npbep tail {}")
    s1 = m.emit("reduce_sum", chk, axis=(0,))
    m.build([s1])

    prog = pb.build("main")
    x0 = _rng(20).random(n).astype(np.float32)
    return prog, [x0]


def build_npbcg(scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    n, iters = (64, 5) if scale == "test" else (512, 60)
    pb = ProgramBuilder("npbcg")
    A = _rng(21).standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
    A = (A @ A.T + np.eye(n, dtype=np.float32) * n).astype(np.float32)  # SPD
    pb.constant("A", A)
    pb.constant("tiny", np.float32(1e-20))

    it = pb.function("cg_iter", ["x", "r", "p"])
    it.use_global("A")
    it.use_global("tiny")
    ap = it.emit("matmul", "A", "p")                       # (n,1)
    rr = it.emit("matmul", it.emit("transpose", "r", perm=(1, 0)), "r")   # (1,1)
    pap = it.emit("matmul", it.emit("transpose", "p", perm=(1, 0)), ap)
    pap2 = it.emit("add", pap, "tiny")
    alpha = it.emit("div", rr, pap2)                       # (1,1)
    ax = it.emit("mul", "p", alpha)
    x2 = it.emit("add", "x", ax)
    ar = it.emit("mul", ap, alpha)
    r2 = it.emit("sub", "r", ar)
    rr2 = it.emit("matmul", it.emit("transpose", r2, perm=(1, 0)), r2)
    rr0 = it.emit("add", rr, "tiny")
    beta = it.emit("div", rr2, rr0)
    bp = it.emit("mul", "p", beta)
    p2 = it.emit("add", r2, bp)
    it.build([x2, r2, p2])

    m = pb.function("main", ["b"])
    # x0 = 0, r0 = b, p0 = b
    z = m.emit("sub", "b", "b")
    x, r, p = m.repeat("cg_iter", iters, z, "b", "b")
    res = m.emit("square", r)
    out = m.emit("reduce_sum", res, axis=(0, 1))
    m.build([out])

    prog = pb.build("main")
    b = _rng(22).standard_normal((n, 1)).astype(np.float32)
    return prog, [b]


def build_npbft(scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    n, steps = (64, 4) if scale == "test" else (512, 40)
    pb = ProgramBuilder("npbft")
    k = np.fft.fftfreq(n).astype(np.float32)
    damp = np.exp(-4.0 * np.pi**2 * (k[:, None] ** 2 + k[None, :] ** 2) * 0.05)
    pb.constant("damp", damp.astype(np.complex64))

    ev = pb.function("evolve", ["u"])
    ev.use_global("damp")
    uf = ev.emit("fft", "u")
    ud = ev.emit("mul", uf, "damp")
    ui = ev.emit("ifft", ud)
    ur = ev.emit("real", ui)
    ev.build([ur])

    m = pb.function("main", ["u0"])
    u = m.repeat("evolve", steps, "u0")
    s = m.emit("reduce_sum", u, axis=(0, 1))
    m.build([s])

    prog = pb.build("main")
    u0 = _rng(23).standard_normal((n, n)).astype(np.float32)
    return prog, [u0]


def build_npbmg(scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    n, cycles = (64, 3) if scale == "test" else (256, 30)
    pb = ProgramBuilder("npbmg")
    nc = n // 2
    R = np.zeros((nc, n), dtype=np.float32)
    for i in range(nc):
        R[i, 2 * i] = 0.5
        R[i, 2 * i + 1] = 0.5
    P = (2 * R.T).astype(np.float32)
    pb.constant("R", R)
    pb.constant("P", P)
    pb.constant("w", np.float32(0.25))

    sm = pb.function("smooth", ["u"])
    sm.use_global("w")
    a = sm.emit("roll", "u", shift=1, axis=0)
    b = sm.emit("roll", "u", shift=-1, axis=0)
    c = sm.emit("roll", "u", shift=1, axis=1)
    d = sm.emit("roll", "u", shift=-1, axis=1)
    s1 = sm.emit("add", a, b)
    s2 = sm.emit("add", c, d)
    s3 = sm.emit("add", s1, s2)
    out = sm.emit("mul", s3, "w")
    sm.build([out])

    vc = pb.function("vcycle", ["u"])
    vc.use_global("R")
    vc.use_global("P")
    u1 = vc.call("smooth", "u")
    rt = vc.emit("transpose", "R", perm=(1, 0))
    c1 = vc.emit("matmul", "R", u1)
    c2 = vc.emit("matmul", c1, rt)                  # restrict
    c3 = vc.call("smooth_c", c2)
    pt = vc.emit("transpose", "P", perm=(1, 0))
    f1 = vc.emit("matmul", "P", c3)
    f2 = vc.emit("matmul", f1, pt)                  # prolong
    u2 = vc.emit("add", u1, f2)
    u3 = vc.call("smooth", u2)
    vc.build([u3])

    smc = pb.function("smooth_c", ["u"])
    smc.use_global("w")
    a = smc.emit("roll", "u", shift=1, axis=0)
    b = smc.emit("roll", "u", shift=-1, axis=0)
    c = smc.emit("roll", "u", shift=1, axis=1)
    d = smc.emit("roll", "u", shift=-1, axis=1)
    s1 = smc.emit("add", a, b)
    s2 = smc.emit("add", c, d)
    s3 = smc.emit("add", s1, s2)
    out = smc.emit("mul", s3, "w")
    smc.build([out])

    m = pb.function("main", ["u0"])
    u = m.repeat("vcycle", cycles, "u0")
    s = m.emit("reduce_sum", u, axis=(0, 1))
    m.build([s])

    prog = pb.build("main")
    u0 = _rng(24).standard_normal((n, n)).astype(np.float32)
    return prog, [u0]


def _block_solver(name: str, seed: int, *, blocks, bs, sweeps_per_step, steps, host_check):
    pb = ProgramBuilder(name)
    Ms = []
    rng = _rng(seed)
    for d in range(3):
        M = (rng.standard_normal((blocks, bs, bs)) * (0.3 / np.sqrt(bs))).astype(np.float32)
        pb.constant(f"M{d}", M)
        Ms.append(f"M{d}")

    swp = pb.function("sweep", ["U"])
    for mn in Ms:
        swp.use_global(mn)
    u = "U"
    for d in range(3):
        sh = swp.emit("roll", u, shift=1, axis=0)
        mu = swp.emit("matmul", Ms[d], sh)          # (B,bs,bs)@(B,bs,1)
        u2 = swp.emit("sub", u, mu)
        u = swp.emit("tanh", u2)                    # relaxation keeps it bounded
    swp.build([u])

    st = pb.function("adi_step", ["U"])
    u = "U"
    for _ in range(sweeps_per_step):
        u = st.call("sweep", u)
    if host_check:
        u = st.emit("host_assert_finite", u, tag=name)
    st.build([u])

    m = pb.function("main", ["U0"])
    u = m.repeat("adi_step", steps, "U0")
    s = m.emit("reduce_sum", u, axis=(0, 1, 2))
    m.build([s])

    prog = pb.build("main")
    U0 = _rng(seed + 1).standard_normal((blocks, bs, 1)).astype(np.float32)
    return prog, [U0]


def build_npbbt(scale: str = "bench"):
    if scale == "test":
        return _block_solver("npbbt", 25, blocks=16, bs=5, sweeps_per_step=2, steps=4, host_check=False)
    return _block_solver("npbbt", 25, blocks=512, bs=5, sweeps_per_step=3, steps=120, host_check=False)


def build_npbsp(scale: str = "bench"):
    if scale == "test":
        return _block_solver("npbsp", 27, blocks=16, bs=5, sweeps_per_step=2, steps=4, host_check=True)
    return _block_solver("npbsp", 27, blocks=512, bs=5, sweeps_per_step=2, steps=150, host_check=True)


def build_npblu(scale: str = "bench"):
    if scale == "test":
        return _block_solver("npblu", 29, blocks=16, bs=5, sweeps_per_step=1, steps=6, host_check=False)
    return _block_solver("npblu", 29, blocks=512, bs=5, sweeps_per_step=1, steps=400, host_check=False)


def build_npbis(scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    n, steps = (4096, 4) if scale == "test" else (131072, 40)
    pb = ProgramBuilder("npbis")
    pb.constant("ka", np.float32(0.6180339887))
    pb.constant("kc", np.float32(0.2360679775))

    st = pb.function("rank_step", ["keys"])
    st.use_global("ka")
    st.use_global("kc")
    t1 = st.emit("mul", "keys", "ka")
    t2 = st.emit("add", t1, "kc")
    fl = st.emit("floor", t2)
    k2 = st.emit("sub", t2, fl)
    srt = st.emit("sort", k2)
    csm = st.emit("cumsum", srt)
    mx = st.emit("reduce_max", csm, axis=(0,), keepdims=True)
    nrm = st.emit("div", csm, mx)
    # feed normalized ranks back as the next key set
    st.build([nrm])

    m = pb.function("main", ["k0"])
    k = m.repeat("rank_step", steps, "k0")
    s = m.emit("reduce_sum", k, axis=(0,))
    m.build([s])

    prog = pb.build("main")
    k0 = _rng(30).random(n).astype(np.float32)
    return prog, [k0]
