"""Customized micro-benchmarks (paper Table 2, "Customized").

* ``matpowsum`` — hot matmul-accumulate loop with a rarely-triggered
  ``host_print`` overflow check in ``main`` (the paper's motivating printf
  case: the check blocks whole-program offloading until PFO).
* ``chainexp``  — long element-wise chains inside a hot loop: maximal
  fusion advantage for native execution over op-at-a-time emulation.
* ``stencil2d`` — Jacobi-style 5-point stencil iterations (roll + adds).
"""
from __future__ import annotations

import numpy as np

from ..core.program import Program, ProgramBuilder


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def build_matpowsum(scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    n, steps = (48, 6) if scale == "test" else (192, 60)
    pb = ProgramBuilder("matpowsum")
    A = (_rng(0).standard_normal((n, n)).astype(np.float32) / np.sqrt(n)).astype(np.float32)
    pb.constant("A", A)

    # step(P, S) = (A @ P normalized, S + P)
    f = pb.function("step", ["P", "S"])
    f.use_global("A")
    ap = f.emit("matmul", "A", "P")
    # normalize to keep values bounded across steps
    sq = f.emit("square", ap)
    ss = f.emit("reduce_sum", sq, axis=(0, 1), keepdims=True)
    nrm = f.emit("rsqrt", ss)
    p2 = f.emit("mul", ap, nrm)
    s2 = f.emit("add", "S", p2)
    f.build([p2, s2])

    m = pb.function("main", ["P0", "S0"])
    p, s = m.repeat("step", steps, "P0", "S0")
    chk = m.emit("host_print", s, threshold=1e9, fmt="matpowsum overflow {}")
    tot = m.emit("reduce_sum", chk, axis=(0, 1))
    m.build([tot])

    prog = pb.build("main")
    P0 = np.eye(n, dtype=np.float32)
    S0 = np.zeros((n, n), dtype=np.float32)
    return prog, [P0, S0]


def build_chainexp(scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    n, steps, depth = (4096, 4, 8) if scale == "test" else (65536, 40, 16)
    pb = ProgramBuilder("chainexp")

    f = pb.function("chain", ["x"])
    v = "x"
    for i in range(depth):
        v = f.emit(["exp", "tanh", "sigmoid", "silu"][i % 4], v)
        v = f.emit("mul", v, v)
    # keep bounded
    mx = f.emit("reduce_max", v, axis=(0,), keepdims=True)
    pb.constant("eps", np.float32(1.0))
    f.use_global("eps")
    den = f.emit("add", mx, "eps")
    out = f.emit("div", v, den)
    f.build([out])

    m = pb.function("main", ["x0"])
    y = m.repeat("chain", steps, "x0")
    s = m.emit("reduce_sum", y, axis=(0,))
    m.build([s])

    prog = pb.build("main")
    x0 = _rng(1).standard_normal(n).astype(np.float32) * 0.1
    return prog, [x0]


def build_stencil2d(scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    n, steps = (64, 6) if scale == "test" else (384, 80)
    pb = ProgramBuilder("stencil2d")
    pb.constant("c", np.float32(0.2))

    f = pb.function("jacobi", ["u"])
    f.use_global("c")
    up = f.emit("roll", "u", shift=1, axis=0)
    dn = f.emit("roll", "u", shift=-1, axis=0)
    lf = f.emit("roll", "u", shift=1, axis=1)
    rt = f.emit("roll", "u", shift=-1, axis=1)
    s1 = f.emit("add", up, dn)
    s2 = f.emit("add", lf, rt)
    s3 = f.emit("add", s1, s2)
    s4 = f.emit("add", s3, "u")
    out = f.emit("mul", s4, "c")
    f.build([out])

    m = pb.function("main", ["u0"])
    u = m.repeat("jacobi", steps, "u0")
    s = m.emit("reduce_sum", u, axis=(0, 1))
    m.build([s])

    prog = pb.build("main")
    u0 = _rng(2).standard_normal((n, n)).astype(np.float32)
    return prog, [u0]
