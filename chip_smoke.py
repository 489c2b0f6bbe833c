#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs end to end on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failure exits non-zero; the result lines print only at the end):

1. Device and build: torch version, the card's name and power limit
   (``nvidia-smi``), and an ``nvcc`` build of every kernel source of the
   path (one compiler per source, all started together), with the build time
   and the compiler's register/shared-memory report.
2. Kernel against its plain PyTorch version on the card: page sizes
   {1, 2, 8, 16} x five tail states x contiguous/gapped/permuted tables x
   with and without a fresh row, at d=16 and d=960, to 2e-5 (the
   reference's float32 kernel tolerance); empty streams give exact zeros, a
   length-0 stream with a fresh row gives exactly its v row, and row b of a
   batched launch is bitwise equal to a solo launch of row b.
3. The main path at real width: ``export_attn_decode_lm`` at SmolLM-360M's
   widths (d_model 960, vocab 49152; one layer, one head), planned
   ``tech-gfp``, served by ``DecodeScheduler`` in ``paged_step`` mode on
   the card (capacity 8, page size 16, max_context 2048, a 1024-page pool):
   8 streams of 128-token prompts decoding 16..64 tokens.  Gates: the
   shortest and longest stream equal ``paged_decode_reference`` bitwise,
   every step went through the kernel (the launch count covers it), the
   page-visit accounting covers the table walk, the pool drains leak-free.
   The longest stream's solo reference run is profiled (device time by
   operation per step, and the device's idle share).  Then the kernel's time
   at the step shape against its bound, the plain version's time, and the
   per-step host-to-device copy of the page pools.
4. A small input checked by the repo's own means: the 4-stream
   ``decode_paged_kernel`` workload on the card gives the tokens of the same
   run on the CPU and the counters recorded in ``BENCH_serve.json``.

The last lines are a ``kernels`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  The script needs the repo's
``src/`` beside it and a CUDA device; without either it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = 2e-5          # float32 kernel tolerance of the reference tests

# the main path's shape: SmolLM-360M widths (src/repro/configs/smollm_360m.py)
D_MODEL, VOCAB, MAX_CTX, PAGE = 960, 49152, 2048, 16
CAPACITY, PROMPT = 8, 128
MAX_NEW = tuple(int(n) for n in np.linspace(16, 64, CAPACITY))

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12          # float32 outside the tensor cores

KERNEL_SOURCES = ("paged_decode_attention",)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """Fail the run (a check that ``python -O`` cannot strip)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------

def phase_build(torch) -> None:
    from repro_torch.kernels import build

    log(f"# torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"# card: {card_line()}")
    t0 = time.perf_counter()
    seconds = build.build(KERNEL_SOURCES)
    log(f"# build: {time.perf_counter() - t0:.2f} s wall for "
        f"{len(KERNEL_SOURCES)} source(s): {seconds}")
    for name in KERNEL_SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"#   {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def pool_case(ps, lengths, d, layout, npages, seed):
    """(q, kn, vn, k_pages, v_pages, tables, lengths) numpy arrays, with the
    logical pages of all streams mapped onto physical ids by ``layout``."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    need = sum(-(-n // ps) for n in lengths)
    P = max(need * 3, 4)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kn, vn = f(B, d), f(B, d), f(B, d)
    kp, vp = f(P, ps, d), f(P, ps, d)
    if layout == "contig":
        ids = list(range(P))
    elif layout == "gaps":
        ids = list(range(0, P, 3)) + [i for i in range(P) if i % 3]
    else:
        ids = list(rng.permutation(P))
    tables = np.zeros((B, npages), np.int32)
    k = 0
    for b, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            tables[b, j] = ids[k]
            k += 1
    return q, kn, vn, kp, vp, tables, np.asarray(lengths, np.int32)


def phase_kernel(torch) -> float:
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention_kernel as kernel,
        paged_decode_attention_plain as plain,
    )

    dev = torch.device("cuda")
    worst = 0.0
    cases = 0
    npages = 6
    for d in (16, 960):
        for ps in (1, 2, 8, 16):
            # empty, single token, partial tail, full tail, max_context-full
            lengths = (0, 1, 2 * ps + max(ps // 2, 1) if ps > 1 else 3,
                       3 * ps, npages * ps)
            for layout in ("contig", "gaps", "permuted"):
                arrays = pool_case(ps, lengths, d, layout, npages, seed=cases)
                q, kn, vn, kp, vp, tables, lens = (
                    torch.from_numpy(a).to(dev) for a in arrays)
                for fresh in (False, True):
                    extra = (kn, vn) if fresh else ()
                    got = kernel(q, kp, vp, tables, lens, *extra)
                    want = plain(q, kp, vp, tables, lens, *extra)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    worst = max(worst, err)
                    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
                    if fresh:
                        # length 0: the softmax has one entry, out == vn
                        check(torch.equal(got[0], vn[0]), "fresh-only row != vn")
                    else:
                        check(torch.all(got[0] == 0.0), "empty stream not exact zeros")
                    for b in range(len(lengths)):
                        solo = kernel(q[b:b + 1], kp, vp, tables[b:b + 1],
                                      lens[b:b + 1],
                                      *(t[b:b + 1] for t in extra))
                        check(torch.equal(solo[0], got[b]), (
                            f"batched row {b} != solo (d={d} ps={ps} "
                            f"{layout} fresh={fresh})"))
                    cases += 1
    torch.cuda.synchronize()
    log(f"# kernel vs plain: {cases} cases, max |err| {worst:.3e} "
        f"(tol {TOL}), exact zeros and batched==solo bitwise: ok")
    return worst


# ---------------------------------------------------------------------------
# phase 3: the main path at real width
# ---------------------------------------------------------------------------

def phase_main(torch) -> dict:
    from repro_torch import mixed, obs
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention_kernel as kernel,
    )
    from repro_torch.models.programs import export_attn_decode_lm
    from repro_torch.serve import (
        DecodeScheduler,
        StateSpec,
        paged_decode_reference,
    )

    t0 = time.perf_counter()
    program = export_attn_decode_lm(vocab=VOCAB, d_model=D_MODEL,
                                    max_context=MAX_CTX, seed=SEED)
    planned = mixed.trace(program).plan("tech-gfp")
    spec = StateSpec(growing={0: 1, 1: 1}, max_context=MAX_CTX, page_size=PAGE)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, VOCAB, (PROMPT,), dtype=np.int32)
               for _ in range(CAPACITY)]
    tracer = obs.Tracer()
    log(f"# main path: export+plan {time.perf_counter() - t0:.2f} s; pool "
        f"{spec.pool_pages(CAPACITY)} pages of {PAGE} x {D_MODEL} f32, "
        f"{2 * spec.pool_pages(CAPACITY) * PAGE * D_MODEL * 4 / 1e6:.1f} MB "
        f"for K+V")

    sched = DecodeScheduler(planned, step="decode_step",
                            paged_step="paged_decode_step",
                            capacity=CAPACITY, state=spec, start=False,
                            tracer=tracer)
    with sched:
        t0 = time.perf_counter()
        sched.warm(PROMPT)
        torch.cuda.synchronize()
        log(f"# warm: {time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        streams = [sched.submit(p, n) for p, n in zip(prompts, MAX_NEW)]
        kernel.launches = 0                        # counts of this run only
        t0 = time.perf_counter()
        sched.start()
        outs = [s.result(timeout=900) for s in streams]
        wall = time.perf_counter() - t0
        launches = kernel.launches
    rep = sched.report()
    peak = torch.cuda.max_memory_allocated()

    for out, n in zip(outs, MAX_NEW):
        check(out.shape == (n,) and out.dtype == np.int32, (out.shape, out.dtype))
        check(np.all((0 <= out) & (out < VOCAB)), "token out of range")
    pstep = sched.paged_step_planned.compile()
    shortest, longest = int(np.argmin(MAX_NEW)), int(np.argmax(MAX_NEW))
    ref = paged_decode_reference(sched.prefill, pstep, prompts[shortest],
                                 MAX_NEW[shortest], capacity=CAPACITY, state=spec)
    check(np.array_equal(ref, outs[shortest]),
          f"shortest stream differs from its solo paged reference:\n"
          f"{outs[shortest]}\n{ref}")
    # the longest stream's solo run doubles as the profiled window: the same
    # padded step shape as serving, one stream live
    ref = profile_steps(torch, lambda: paged_decode_reference(
        sched.prefill, pstep, prompts[longest], MAX_NEW[longest],
        capacity=CAPACITY, state=spec), MAX_NEW[longest] - 1)
    check(np.array_equal(ref, outs[longest]),
          f"longest stream differs from its solo paged reference:\n"
          f"{outs[longest]}\n{ref}")
    check(rep.kernel_steps == rep.steps > 0, (rep.kernel_steps, rep.steps))
    check(launches >= rep.kernel_steps, (launches, rep.kernel_steps))
    walk = rep.kernel_steps * CAPACITY * spec.pages_per_stream
    check(rep.pages_visited + rep.pages_skipped == walk, rep.table())
    check(0 < rep.pages_visited, rep.table())
    check(rep.pages_in_use == 0 and rep.page_allocs == rep.page_frees > 0, rep.table())
    check(sched._paged.pool.refs_outstanding == 0, "leaked page refcounts")

    steps = [s.dur_ns for s in tracer.snapshot() if s.kind == obs.STEP]
    step_p50 = float(np.median(steps)) / 1e6
    log(f"# main path: {rep.tokens} tokens in {wall:.3f} s = "
        f"{rep.tokens / wall:.1f} tokens/s; {rep.steps} steps, step p50 "
        f"{step_p50:.3f} ms; crossings {rep.crossings}, tokens/crossing "
        f"{rep.tokens_per_crossing:.4f}; kernel launches {launches} "
        f"(kernel_steps {rep.kernel_steps}); pages visited "
        f"{rep.pages_visited} of {walk}; max_memory_allocated "
        f"{peak / 2**20:.1f} MiB")
    pools = [sched._paged.backing(k) for k in sorted(spec.growing)]
    return {"launches": launches, "pools": pools,
            "lengths": [PROMPT + n // 2 for n in MAX_NEW]}


def profile_steps(torch, fn, steps: int):
    """Run ``fn`` under the torch profiler and print where the device time
    of its ``steps`` decode steps goes: device busy time by operation, per
    step, and the device's idle share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side events only: a host op's device total repeats the
        # time of the kernels and copies it launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        log("# profile: the profiler recorded no device time (not measured)")
        return out
    log(f"# profile of {steps} solo steps + prefill at the serving shape: "
        f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}; per step, by device time:")
    for ms, count, name in rows[:8]:
        log(f"#   {ms / steps:9.4f} ms/step  {count:5d} calls  {name[:70]}")
    return out


def time_ms(torch, fn, reps: int, flush) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, L2 flushed before
    each one (the serving step finds the cache cold: the pools were just
    copied in), measured with CUDA events around each call."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def phase_timing(torch, main: dict) -> dict:
    """The kernel at the serving step's shape: pools (1024, 16, 960), tables
    (8, 128), each stream at the midpoint of its decode."""
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention_kernel as kernel,
        paged_decode_attention_plain as plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    P = CAPACITY * (MAX_CTX // PAGE)
    npages = MAX_CTX // PAGE
    lengths = np.asarray(main["lengths"], np.int32)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    q, kn, vn = f(CAPACITY, D_MODEL), f(CAPACITY, D_MODEL), f(CAPACITY, D_MODEL)
    kp, vp = f(P, PAGE, D_MODEL), f(P, PAGE, D_MODEL)
    tables = np.zeros((CAPACITY, npages), np.int32)
    perm = rng.permutation(P)
    for b in range(CAPACITY):
        tables[b] = perm[b * npages:(b + 1) * npages]
    tables = torch.from_numpy(tables).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    args = (q, kp, vp, tables, lens, kn, vn)

    got, want = kernel(*args), plain(*args)
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)

    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    before = kernel.launches
    kernel_ms = time_ms(torch, lambda: kernel(*args), 200, flush)
    plain_ms = time_ms(torch, lambda: plain(*args), 20, flush)
    kernel.launches = before            # timing launches are not the path's

    live_rows = int(lengths.sum())
    live_pages = int(sum(-(-int(n) // PAGE) for n in lengths))
    nbytes = (2 * live_rows * D_MODEL * 4            # live K and V rows
              + 4 * CAPACITY * D_MODEL * 4           # q, kn, vn, out
              + CAPACITY * 4 + live_pages * 4)       # lengths, live table slots
    flops = 4 * (live_rows + CAPACITY) * D_MODEL     # q.k and p.v, fresh row too
    bound_bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    bound_ops_ms = flops / H100_FP32_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"

    # the per-step host-to-device copy of the two numpy page pools
    pools = main["pools"]
    for p in pools:
        torch.from_numpy(p).to(dev)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        for p in pools:
            torch.from_numpy(p).to(dev)
        torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) / reps * 1e3
    pool_mb = sum(p.nbytes for p in pools) / 1e6

    log(f"# kernel at the step shape (B={CAPACITY}, d={D_MODEL}, ps={PAGE}, "
        f"npages={npages}, lengths={lengths.tolist()}): {kernel_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.3f} MB, "
        f"{flops / 1e6:.2f} MFLOP), plain version {plain_ms:.4f} ms, "
        f"|err| {err:.3e}; no single PyTorch call computes paged decode "
        f"attention over a block table, so library_ms is null")
    log(f"# per-step host-to-device copy of the numpy page pools "
        f"({pool_mb:.1f} MB): {h2d_ms:.3f} ms")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 4: small input against the CPU run and BENCH_serve.json
# ---------------------------------------------------------------------------

def phase_small(torch) -> None:
    from repro_torch import mixed
    from repro_torch.models.programs import export_attn_decode_lm
    from repro_torch.serve import DecodeScheduler, StateSpec

    vocab, dm, max_ctx, ps, prompt_len = 32, 16, 24, 4, 6
    lens = (6, 8, 10, 12)
    planned = mixed.trace(export_attn_decode_lm(
        vocab=vocab, d_model=dm, max_context=max_ctx)).plan("tech-gfp")
    spec = StateSpec(growing={0: 1, 1: 1}, max_context=max_ctx, page_size=ps)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, (prompt_len,), dtype=np.int32)
               for _ in range(len(lens))]

    def run(backend):
        with DecodeScheduler(planned, step="decode_step",
                             paged_step="paged_decode_step",
                             capacity=len(lens), state=spec, start=False,
                             backend=backend) as sched:
            sched.warm(prompt_len)
            streams = [sched.submit(p, n) for p, n in zip(prompts, lens)]
            sched.start()
            outs = [s.result(timeout=120) for s in streams]
        return outs, sched.report()

    gpu, rep = run(None)
    cpu, _ = run("cpu")
    for a, b in zip(gpu, cpu):
        check(np.array_equal(a, b), f"card tokens {a} != CPU tokens {b}")
    want = json.loads((ROOT / "BENCH_serve.json").read_text())["decode_paged_kernel"]
    got = {"pages_visited": rep.pages_visited, "pages_skipped": rep.pages_skipped,
           "kernel_steps": rep.kernel_steps, "tokens": rep.tokens,
           "tokens_per_crossing": rep.tokens_per_crossing}
    for k, v in got.items():
        check(v == want[k], f"{k}: {v} on the card, {want[k]} recorded")
    check(rep.pages_in_use == 0 and rep.page_allocs == rep.page_frees,
          "pages leaked by the small run")
    log(f"# small input: card tokens == CPU tokens; counters == "
        f"BENCH_serve.json decode_paged_kernel {got}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repo (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    t_all = time.perf_counter()
    phase_build(torch)
    err = phase_kernel(torch)
    main_run = phase_main(torch)
    timing = phase_timing(torch, main_run)
    phase_small(torch)
    log(f"# all phases passed in {time.perf_counter() - t_all:.1f} s")

    kernels = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:114",
        "launches": main_run["launches"],
        "max_abs_err": max(err, timing["max_abs_err"]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        "ok": True,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
