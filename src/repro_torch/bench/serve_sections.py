"""The serving sections of ``BENCH_serve.json`` on the port.

Port-side copies of the reference's section workloads: request-level
batching (``request_level``), continuous batching over paged, prefix-shared
KV state (``decode_continuous``), the process cluster booted from an AOT
cache (``decode_cluster``), and the traced cluster run (``observability``).
Each function takes ``backend`` — ``None`` runs the offload units on the
CUDA card, ``"cpu"`` on the CPU — so the same workload runs in the CPU
tests and on the card.  Every section holds counters only (no wall-clock
field), so a run equals the committed file field by field.

    PYTHONPATH=src python -m repro_torch.bench.serve_sections --device cpu
    PYTHONPATH=src python -m repro_torch.bench.serve_sections --device cpu --record-full
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from .. import mixed, obs
from ..core import ProgramBuilder
from ..models.programs import export_attn_decode_lm
from ..serve import (
    BucketLadder,
    ClusterRouter,
    DecodeScheduler,
    MixedServer,
    StateSpec,
    WorkerSpec,
    decode_reference,
    prefix_affinity,
)

REPO = Path(__file__).resolve().parents[3]
BENCH_SERVE = REPO / "BENCH_serve.json"
SECTIONS = ("request_level", "decode_continuous", "decode_cluster", "observability")


# ---------------------------------------------------------------------------
# request_level: MixedServer over the quickstart-shaped program
# ---------------------------------------------------------------------------


def build_program():
    """The serving smoke program: an offloadable dense block in a hot loop,
    then a host-only check (the printf case); batch-preserving output."""
    pb = ProgramBuilder("smoke-serve")
    W = (np.random.default_rng(0).standard_normal((64, 64)) / 10).astype(np.float32)
    pb.constant("W", W)

    dense = pb.function("dense", ["x"])      # offloadable library function
    dense.use_global("W")
    h = dense.emit("matmul", "x", "W")
    h = dense.emit("tanh", h)
    dense.build([h])

    step = pb.function("step", ["x"])        # hot-loop body
    y = step.call("dense", "x")
    z = step.emit("mul", y, y)
    step.build([z])

    main = pb.function("main", ["x0"])
    out = main.repeat("step", 10, "x0")      # hot loop
    out = main.emit("host_print", out, threshold=1e6,
                    fmt="overflow {}")       # host-only check (printf case)
    main.build([out])
    return pb.build("main")


def serve_metrics(backend: str | None = None) -> dict:
    """Request-level batching: crossings per row against unbatched calls.

    ONE 24-row request is split by the server into warm top-bucket chunks,
    so every counter is fixed by the ladder, not by thread timing."""
    planned = mixed.trace(build_program()).plan("tech-gfp")
    direct = planned.compile(backend=backend)
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((24, 64)).astype(np.float32)

    with mixed.instrument() as rec:
        for i in range(rows.shape[0]):
            direct(rows[i:i + 1])
    unbatched = rec.merged()

    with MixedServer(planned, ladder=BucketLadder(batch_sizes=(1, 2, 4, 8)),
                     backend=backend) as server:
        server.warm(rows[:1])              # every bucket incl. the 8-chunk
        before = server.report()
        server.request(rows)               # 24 rows -> 3 top-bucket chunks
        after = server.report()
    crossings = after.crossings - before.crossings
    return {
        "rows": int(rows.shape[0]),
        "crossings_per_row": crossings / rows.shape[0],
        "unbatched_crossings_per_row": unbatched.guest_to_host / unbatched.calls,
        "batch_occupancy": after.batch_occupancy,
        "oversize_splits": after.oversize_splits,
    }


# ---------------------------------------------------------------------------
# decode_continuous: the prefix-sharing burst on one scheduler
# ---------------------------------------------------------------------------


def prefix_workload(backend: str | None = None):
    """The 4-stream common-prefix burst (attention LM, seed 17, page 4,
    max_context 32).  Returns ``(decode_all, prompts, lens, n_streams)``;
    ``decode_all(share)`` decodes the burst with prefix sharing on or off
    and returns ``(outs, report, sched)``, the report taken after close."""
    vocab, dm, max_ctx = 32, 16, 32
    page_size, prompt_len, prefix_len = 4, 12, 8
    n_streams, lens = 4, (5, 6, 7, 8)
    planned = mixed.trace(
        export_attn_decode_lm(vocab=vocab, d_model=dm, max_context=max_ctx)
    ).plan("tech-gfp")
    rng = np.random.default_rng(17)
    prefix = rng.integers(0, vocab, (prefix_len,), dtype=np.int32)
    prompts = [np.concatenate(
        [prefix, rng.integers(0, vocab, (prompt_len - prefix_len,), np.int32)])
        for _ in range(n_streams)]

    def decode_all(share: bool):
        spec = StateSpec(growing={0: 1, 1: 1}, max_context=max_ctx,
                         page_size=page_size, share_prefixes=share)
        kw = {"prefill_suffix": "prefill_suffix"} if share else {}
        with DecodeScheduler(planned, step="decode_step", capacity=n_streams,
                             state=spec, start=False, backend=backend,
                             **kw) as sched:
            sched.warm(prompt_len)
            streams = [sched.submit(p, n) for p, n in zip(prompts, lens)]
            sched.start()
            outs = [s.result(timeout=120) for s in streams]
        return outs, sched.report(), sched

    return decode_all, prompts, lens, n_streams


def decode_metrics(backend: str | None = None) -> dict:
    """Continuous batching over paged KV state, prefix sharing on and off."""
    decode_all, _prompts, _lens, _n = prefix_workload(backend)
    _, rep, _ = decode_all(share=True)
    _, rep_off, _ = decode_all(share=False)
    return {
        "streams": rep.streams,
        "tokens": rep.tokens,
        "tokens_per_crossing": rep.tokens_per_crossing,
        "crossings_per_request": rep.crossings / rep.streams,
        "step_occupancy": rep.step_occupancy,
        "pages_in_use_peak": rep.pages_peak,
        "pages_in_use_peak_unshared": rep_off.pages_peak,
        "prefix_hits": rep.prefix_hits,
        "prefix_tokens_reused": rep.prefix_tokens_reused,
        "pages_shared": rep.pages_shared,
        "pages_cow_copied": rep.pages_cow_copied,
        "state_bytes_per_crossing": rep.state_bytes_per_crossing,
        "unique_state_bytes_per_crossing": rep.unique_state_bytes_per_crossing,
        "state_bytes_saved": rep.state_bytes_saved,
        "cache_occupancy": rep.cache_occupancy,
    }


# ---------------------------------------------------------------------------
# decode_cluster: one worker, save_aot, then two workers booted from it
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClusterGeometry:
    """The attention LM and its two prefix bursts (``n_streams`` prompts
    each, sharing ``prefix_len`` tokens, decoding ``lens`` new tokens)."""

    vocab: int = 32
    d_model: int = 16
    max_context: int = 32
    page: int = 4
    prompt_len: int = 12
    prefix_len: int = 8
    lens: tuple[int, ...] = (5, 6, 7, 8)
    workers: int = 2

    @property
    def n_streams(self) -> int:
        return len(self.lens)


SMALL = ClusterGeometry()
# configuration 9: the attention LM at SmolLM-360M's widths (d_model 960,
# vocab 49152), two bursts of 8 prompts of 128 tokens sharing a 64-token
# (4-page) prefix, decoding 16..32 new tokens
FULL = ClusterGeometry(vocab=49152, d_model=960, max_context=256, page=16,
                       prompt_len=128, prefix_len=64,
                       lens=tuple(int(n) for n in np.linspace(16, 32, 8)))
# the counters of FULL's workload with the units on the CPU (written by
# ``--record-full``; the counters do not depend on the device)
FULL_COUNTERS = Path(__file__).resolve().parent / "cluster_full_counters.json"


def cluster_spec(geo: ClusterGeometry = SMALL, backend: str | None = None,
                 **overrides) -> WorkerSpec:
    base = dict(
        program="repro_torch.models.programs:export_attn_decode_lm",
        program_kwargs={"vocab": geo.vocab, "d_model": geo.d_model,
                        "max_context": geo.max_context},
        capacity=geo.n_streams,
        state=StateSpec(growing={0: 1, 1: 1}, max_context=geo.max_context,
                        page_size=geo.page, share_prefixes=True),
        prefill_suffix="prefill_suffix",
        hold_admission=True,            # burst admission, not timing
        backend=backend,
    )
    base.update(overrides)
    return WorkerSpec(**base)


def _burst(geo: ClusterGeometry, rng: np.random.Generator):
    """``n_streams`` prompts sharing one page-aligned prefix."""
    prefix = rng.integers(0, geo.vocab, (geo.prefix_len,), dtype=np.int32)
    return [np.concatenate(
        [prefix, rng.integers(0, geo.vocab, (geo.prompt_len - geo.prefix_len,),
                              np.int32)])
        for _ in range(geo.n_streams)]


def bursts(geo: ClusterGeometry = SMALL):
    """Two bursts whose prefix pages hash to different workers (seeded,
    content-addressed placement: the search always lands on the same pair)."""
    rng = np.random.default_rng(17)
    burst_a = _burst(geo, rng)
    slot_a = prefix_affinity(burst_a[0], geo.page) % geo.workers
    for seed in range(100, 200):
        burst_b = _burst(geo, np.random.default_rng(seed))
        if prefix_affinity(burst_b[0], geo.page) % geo.workers != slot_a:
            return burst_a, burst_b
    raise RuntimeError("no opposing prefix page in 100 seeds")


def cluster_workload(backend: str | None = None, geo: ClusterGeometry = SMALL,
                     oracle: bool = True, aot_dir: str | None = None) -> tuple:
    """Baseline (one worker, burst A, then ``save_aot``) and cluster (two
    workers booted from that cache, bursts A + B).

    The cache goes to ``aot_dir``, which the caller owns; without one it
    goes to a temporary directory removed before the function returns.
    Returns ``(metrics, problems, base_report, cluster_report, extra)``:
    ``problems`` lists bit-identity violations against the in-process
    ``decode_reference`` at the same capacity (when ``oracle``) and of the
    cluster's burst A against the baseline's; ``extra`` holds the outputs,
    the AOT summary, the host-clock walls and each run's kernel launches
    per route, summed over its workers (``launches``) and per worker in the
    order of the report's ``worker_reports`` (``worker_launches``)."""
    if aot_dir is None:
        with tempfile.TemporaryDirectory(prefix="repro-torch-aot-") as tmp:
            return cluster_workload(backend, geo, oracle, f"{tmp}/cache")
    burst_a, burst_b = bursts(geo)
    lens = geo.lens
    walls = {}

    t0 = time.perf_counter()
    with ClusterRouter(cluster_spec(geo, backend), workers=1) as router:
        walls["baseline_boot_s"] = time.perf_counter() - t0
        futs = [router.submit(p, n) for p, n in zip(burst_a, lens)]
        t1 = time.perf_counter()
        router.start()
        outs_a = [f.result(600) for f in futs]
        walls["baseline_decode_s"] = time.perf_counter() - t1
        base = router.report()
        base_launches = router.launches_by_route()
        base_workers = [w.launches_by_route for w in router.workers]
        t1 = time.perf_counter()
        aot = router.save_aot(aot_dir)
        walls["save_aot_s"] = time.perf_counter() - t1

    t0 = time.perf_counter()
    with ClusterRouter(cluster_spec(geo, backend, aot_path=aot_dir),
                       workers=geo.workers) as router:
        walls["cluster_boot_s"] = time.perf_counter() - t0
        both = list(zip(burst_a, lens)) + list(zip(burst_b, lens))
        futs = [router.submit(p, n) for p, n in both]
        t1 = time.perf_counter()
        router.start()
        outs = [f.result(600) for f in futs]
        walls["cluster_decode_s"] = time.perf_counter() - t1
        clus = router.report()
        clus_launches = router.launches_by_route()
        clus_workers = [w.launches_by_route for w in router.workers]

    problems = []
    if oracle:
        planned = mixed.trace(export_attn_decode_lm(
            vocab=geo.vocab, d_model=geo.d_model,
            max_context=geo.max_context)).plan("tech-gfp")
        prefill = planned.compile(backend=backend)
        step = planned.for_entry("decode_step").compile(backend=backend)
        for i, ((p, n), out) in enumerate(zip(both, outs)):
            ref = decode_reference(prefill, step, p, n, capacity=geo.n_streams)
            if not np.array_equal(ref, out):
                problems.append(f"stream {i}: got {out} expected {ref}")
    for i, (out, base_out) in enumerate(zip(outs[:geo.n_streams], outs_a)):
        if not np.array_equal(out, base_out):
            problems.append(f"stream {i}: cluster != baseline run")

    metrics = {
        "workers": clus.workers,
        "streams": clus.streams,
        "tokens": clus.tokens,
        "tokens_per_crossing": clus.tokens_per_crossing,
        "baseline_tokens_per_crossing": base.tokens_per_crossing,
        "routed_affinity": clus.routed_affinity,
        "routed_spill": clus.routed_spill,
        "streams_per_worker": sorted(r.streams for r in clus.worker_reports),
        "prefix_hits": clus.prefix_hits,
        "prefix_tokens_reused": clus.prefix_tokens_reused,
        "first_boot_compiles": base.compiles,
        "second_boot_compiles": clus.compiles,
        "aot_exported_units": aot["exported_units"],
        "aot_signatures": aot["signatures"],
    }
    extra = {"outs": outs, "outs_a": outs_a, "aot": aot, "walls": walls,
             "both": both,
             "launches": {"baseline": base_launches, "cluster": clus_launches},
             "worker_launches": {"baseline": base_workers, "cluster": clus_workers}}
    return metrics, problems, base, clus, extra


def cluster_metrics(backend: str | None = None) -> dict:
    metrics, problems, *_ = cluster_workload(backend)
    metrics = dict(metrics)
    metrics["bit_identity_violations"] = len(problems)
    return metrics


# ---------------------------------------------------------------------------
# observability: the cluster burst untraced, then traced
# ---------------------------------------------------------------------------


def _run_traced_workload(backend):
    """One 2-worker, 8-stream cluster burst; ``(outputs, report, the
    workers' kernel launches per route, their final reports)``: the final
    reports come from the drain at close, whose release of the retained
    prefixes counts as evictions."""
    geo = SMALL
    burst_a, burst_b = bursts(geo)
    both = list(zip(burst_a, geo.lens)) + list(zip(burst_b, geo.lens))
    with ClusterRouter(cluster_spec(geo, backend), workers=geo.workers) as router:
        futs = [router.submit(p, n) for p, n in both]
        router.start()
        outs = [f.result(300) for f in futs]
        rep = router.report()
        launches = router.launches_by_route()
    finals = [w.final_report for w in router.workers]
    return outs, rep, launches, finals


def _conservation_problems(hist_set) -> list[str]:
    """Histogram invariant: bucket counts sum to the sample count."""
    return [f"histogram {key}: sum(counts)={sum(h.counts)} != count={h.count}"
            for key, h in hist_set.items() if sum(h.counts) != h.count]


def trace_workload(backend: str | None = None,
                   launches: dict | None = None) -> tuple[dict, list[str]]:
    """The untraced/traced duel over the cluster burst; returns
    ``(metrics, problems)`` with deterministic counters only.  A
    ``launches`` dict receives the workers' kernel launches per route of
    each run (``"untraced"``, ``"traced"``)."""
    outs_plain, _, plain_launches, _ = _run_traced_workload(backend)

    tracer = obs.Tracer(label="router")
    with obs.session(tracer):
        outs_traced, rep, traced_launches, finals = _run_traced_workload(backend)
    if launches is not None:
        launches.update(untraced=plain_launches, traced=traced_launches)
    with tempfile.TemporaryDirectory(prefix="repro-torch-trace-") as out_dir:
        path = Path(out_dir) / "trace.json"
        payload = tracer.export_chrome_trace(path)
        parsed = json.loads(path.read_text())

    problems = []
    for i, (a, b) in enumerate(zip(outs_plain, outs_traced)):
        if not np.array_equal(a, b):
            problems.append(f"stream {i}: traced != untraced (got {b} expected {a})")
    problems += _conservation_problems(rep.latency)
    problems += _conservation_problems(tracer.hist)
    for wr in rep.worker_reports:
        problems += _conservation_problems(wr.execution.latency)

    root = tracer.trace_id
    real = [e for e in parsed["traceEvents"] if e.get("ph") != "M"]
    worker_pids = sorted({e["pid"] for e in real} - {os.getpid()})
    off_root = sum(1 for e in real
                   if not str(e["args"].get("trace_id", "")).startswith(root))

    kinds = tracer.counts_by_kind()
    prefill_h = rep.latency.get(("prefill", ""))
    step_h = rep.latency.get(("step", ""))
    metrics = {
        "spans_by_kind": {k: kinds[k] for k in sorted(kinds)},
        "worker_spans": rep.worker_spans,
        "worker_processes": len(worker_pids),
        "spans_dropped": rep.spans_dropped + tracer.spans_dropped,
        "events_off_root": off_root,
        "prefill_groups": prefill_h.count if prefill_h else 0,
        "decode_steps": step_h.count if step_h else 0,
        "crossing_samples": sum(
            wr.execution.latency.total_count for wr in rep.worker_reports),
        "dropped_reported_by_export": payload["otherData"]["spans_dropped"],
        # the reference's page events, as the workers' final reports count them
        "page_allocs": sum(r.page_allocs for r in finals),
        "pages_cow_copied": sum(r.pages_cow_copied for r in finals),
        "prefix_evictions": sum(r.prefix_evictions for r in finals),
    }
    return metrics, problems


def obs_metrics(backend: str | None = None) -> dict:
    metrics, problems = trace_workload(backend)
    metrics = dict(metrics)
    metrics["trace_identity_violations"] = len(problems)
    return metrics


# ---------------------------------------------------------------------------
# all four, against the committed file
# ---------------------------------------------------------------------------

_BUILDERS = {
    "request_level": serve_metrics,
    "decode_continuous": decode_metrics,
    "decode_cluster": cluster_metrics,
    "observability": obs_metrics,
}


def sections(backend: str | None = None, names=SECTIONS) -> dict:
    """Run the named sections; ``{name: metrics}``."""
    return {name: _BUILDERS[name](backend) for name in names}


#: the reference's page instant events -> the DecodeReport fields that count them
PAGE_EVENTS = {"page_alloc": "page_allocs", "page_cow": "pages_cow_copied",
               "page_evict": "prefix_evictions"}


def port_observability(ref: dict, backend: str | None = None) -> dict:
    """The reference's ``observability`` section as the port records it on
    ``backend``: its page instant events as the workers' final reports'
    counters (``PAGE_EVENTS``, a kind it never recorded reads 0); a
    ``place`` and a ``fetch`` span in every crossing, and a ``drain`` on
    the card; an ``emit`` span after every prefill group and step.  Of the
    reference's page events only the allocations and copies come before
    the report that counts ``worker_spans``: its evictions here all come
    when the workers drain at close."""
    kinds = {k: v for k, v in ref["spans_by_kind"].items() if k not in PAGE_EVENTS}
    pages = {field: ref["spans_by_kind"].get(k, 0) for k, field in PAGE_EVENTS.items()}
    n = kinds["crossing"]
    added = {"place": n, "fetch": n, "emit": ref["prefill_groups"] + ref["decode_steps"]}
    if backend is None or str(backend).startswith("cuda"):
        added["drain"] = n
    kinds.update(added)
    before_report = pages["page_allocs"] + pages["pages_cow_copied"]
    return dict(ref, **pages, spans_by_kind=dict(sorted(kinds.items())),
                worker_spans=ref["worker_spans"] - before_report + sum(added.values()))


def mismatches(got: dict, backend: str | None = None) -> list[str]:
    """Every field of ``got``'s sections (run on ``backend``) that differs
    from ``BENCH_serve.json`` (its ``observability`` as the port records it)."""
    want = json.loads(BENCH_SERVE.read_text())
    out = []
    for name, fields in got.items():
        ref = want[name]
        if name == "observability":
            ref = port_observability(ref, backend)
        if set(fields) != set(ref):
            out.append(f"{name}: fields {sorted(fields)} != {sorted(ref)}")
        for k in sorted(set(fields) & set(ref)):
            if fields[k] != ref[k]:
                out.append(f"{name}.{k}: {fields[k]!r} != {ref[k]!r}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="unit device: omit for the CUDA card, 'cpu' for the CPU")
    ap.add_argument("--record-full", action="store_true",
                    help="run configuration 9's cluster workload (FULL) and "
                         "write its counters to cluster_full_counters.json")
    args = ap.parse_args(argv)
    if args.record_full:
        metrics, problems, *_ = cluster_workload(args.device, FULL, oracle=False)
        metrics = dict(metrics, device=args.device or "cuda")
        print(json.dumps(metrics, indent=2, sort_keys=True))
        FULL_COUNTERS.write_text(json.dumps(metrics, indent=2, sort_keys=True) + "\n")
        for line in problems:
            print(f"PROBLEM {line}", file=sys.stderr)
        return 1 if problems else 0
    got = sections(args.device)
    print(json.dumps(got, indent=2, sort_keys=True))
    bad = mismatches(got, args.device)
    for line in bad:
        print(f"MISMATCH {line}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
