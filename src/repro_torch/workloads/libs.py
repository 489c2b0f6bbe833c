"""Shared-library offloading workloads (paper §4.4.2, Table 3).

The paper accelerates *unmodified, pre-built* applications by replacing only
the shared libraries they link against (libpng / zlib).  Our analogue:

* library functions (``zlib.*`` / ``libpng.*``) are Program functions whose
  "source is available" — they may be offloaded;
* application functions (``app.*``) are "closed-source binaries" — a
  ``unit_filter`` excludes them from offloading (and from FCP inlining), so
  they always execute in the emulator, exactly like a pre-built guest binary
  under QEMU;
* each downstream app calls into the libraries from its interpreted main
  loop, so every library call is a guest→host crossing.

Apps (mirroring Table 3): ``apng2gif`` (light libpng use), ``optipng``
(libpng-heavy), ``imagemagick`` (libpng + zlib + heavy own logic),
``zlibflate`` (zlib-dominated).
"""
from __future__ import annotations

import numpy as np

from ..core.program import Program, ProgramBuilder

LIBRARY_FUNCTIONS = ("zlib.", "libpng.")


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _add_zlib(pb: ProgramBuilder, n: int, sweeps: int) -> None:
    """zlib analogue, *instruction-granular* like the real thing.

    Real zlib's hot loops are byte-level match searches — under DBT every
    iteration pays per-instruction emulation cost.  The analogue: the
    deflate window sweep is a ``repeat`` over a small per-window step
    (match-score + code-assign on a rolling window), so the interpreter
    pays Python dispatch per step while the host side fuses the entire
    sweep into one compiled region (via FCP the repeat becomes a scan).
    """
    D1 = (_rng(40).standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    pb.constant("zdict1", D1)
    pb.constant("zeps", np.float32(1.0))

    st = pb.function("zlib.window_step", ["w"])
    st.use_global("zeps")
    # byte-level match search: rolling compares + running best — all small
    # elementwise/shift ops (the per-instruction loops DBT chokes on; one
    # fused pass for the host side)
    d1 = st.emit("roll", "w", shift=1, axis=1)
    d2 = st.emit("roll", "w", shift=3, axis=1)
    m1 = st.emit("sub", "w", d1)
    m2 = st.emit("sub", "w", d2)
    a1 = st.emit("abs", m1)
    a2 = st.emit("abs", m2)
    best = st.emit("minimum", a1, a2)                # best match distance
    sc = st.emit("sigmoid", best)
    hi = st.emit("maximum", sc, m1)
    lo = st.emit("mul", hi, sc)
    out = st.emit("tanh", lo)
    st.build([out])

    f = pb.function("zlib.deflate_block", ["x"])
    y = f.repeat("zlib.window_step", sweeps, "x")
    f.build([y])

    g = pb.function("zlib.crc32", ["x"])
    g.use_global("zeps")
    sq = g.emit("square", "x")
    s = g.emit("reduce_sum", sq, axis=(0, 1), keepdims=True)
    s2 = g.emit("add", s, "zeps")
    r = g.emit("sqrt", s2)
    g.build([r])


def _add_libpng(pb: ProgramBuilder, n: int, sweeps: int) -> None:
    """libpng analogue: scanline filter sweeps (per-scanline loop under DBT)
    + palette quantization."""
    pal = (_rng(42).standard_normal((n, n)) * 0.1).astype(np.float32)
    pb.constant("png_pal", pal)
    pb.constant("png_half", np.float32(0.5))

    st = pb.function("libpng.scanline_step", ["img"])
    st.use_global("png_half")
    up = st.emit("roll", "img", shift=1, axis=0)
    lf = st.emit("roll", "img", shift=1, axis=1)
    avg = st.emit("add", up, lf)
    av2 = st.emit("mul", avg, "png_half")
    res = st.emit("sub", "img", av2)                 # Paeth-ish residual
    out = st.emit("tanh", res)
    st.build([out])

    f = pb.function("libpng.filter_rows", ["img"])
    y = f.repeat("libpng.scanline_step", max(2, sweeps // 2), "img")
    f.build([y])

    g = pb.function("libpng.quantize", ["img"])
    g.use_global("png_pal")
    m = g.emit("matmul", "img", "png_pal")
    t = g.emit("tanh", m)
    g.build([t])


def build_library_app(app: str, scale: str = "bench") -> tuple[Program, list[np.ndarray]]:
    n = 48 if scale == "test" else 96
    blocks = {"test": 4, "bench": 40}[scale]
    sweeps = {"test": 4, "bench": 24}[scale]
    pb = ProgramBuilder(app)
    _add_zlib(pb, n, sweeps)
    _add_libpng(pb, n, sweeps)

    # app-side "closed-source" work: small interpreted ops between lib calls
    own = pb.function("app.own_logic", ["x"])
    a = own.emit("abs", "x")
    b = own.emit("add", a, "x")
    c = own.emit("tanh", b)
    own.build([c])

    st = pb.function("app.process_block", ["x"])
    if app == "zlibflate":
        y = st.call("zlib.deflate_block", "x")
        y = st.call("zlib.deflate_block", y)
        y = st.call("zlib.deflate_block", y)
        out = y
    elif app == "apng2gif":
        y = st.call("libpng.filter_rows", "x")
        y = st.call("app.own_logic", y)
        y = st.call("app.own_logic", y)
        y = st.call("app.own_logic", y)
        out = y
    elif app == "optipng":
        y = st.call("libpng.filter_rows", "x")
        y = st.call("libpng.quantize", y)
        y = st.call("app.own_logic", y)
        out = y
    elif app == "imagemagick":
        y = st.call("libpng.filter_rows", "x")
        y = st.call("libpng.quantize", y)
        y = st.call("zlib.deflate_block", y)
        y = st.call("app.own_logic", y)
        out = y
    else:
        raise ValueError(app)
    st.build([out])

    m = pb.function("app.main", ["x0"])
    y = m.repeat("app.process_block", blocks, "x0")
    s = m.emit("reduce_sum", y, axis=(0, 1))
    m.build([s])

    prog = pb.build("app.main")
    x0 = _rng(43).standard_normal((n, n)).astype(np.float32) * 0.1
    return prog, [x0]


def library_unit_filter(libs: tuple[str, ...]):
    """unit_filter offloading only functions from the named libraries."""

    def accept(fname: str) -> bool:
        return any(fname.startswith(p) for p in libs)

    return accept
