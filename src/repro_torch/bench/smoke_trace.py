"""CI smoke gate for the observability tier: bounded, assertion-driven.

The same 2-worker, 8-stream prefix-affinity workload ``smoke_cluster``
validates, run twice (:func:`repro_torch.bench.serve_sections.trace_workload`):

* **untraced** — no tracer installed anywhere; the zero-cost-off baseline;
* **traced** — the parent installs a :class:`repro_torch.obs.Tracer` via
  ``obs.session``; the router roots every worker tracer at its trace id,
  harvests worker spans over the channel, and exports one Chrome
  trace-event JSON for the whole cluster.

Gated:

* **tracing is passive** — every traced stream is bit-identical to its
  untraced twin (observability must never change program outputs);
* **the export is a valid flight record** — parseable Chrome JSON whose
  non-metadata events carry spans from BOTH worker processes (pids other
  than the parent's), every one stamped with a trace id under the
  parent's root;
* **nothing was silently lost** — ``spans_dropped == 0`` parent and
  workers, and every latency histogram conserves its samples
  (``sum(bucket counts) == count``);
* **the span counts are the workload's** — deterministic kinds (routed
  submissions, results, prefill groups, decode steps, admission waits)
  match the known workload shape exactly.

The workers' units run on the CUDA card unless ``--device cpu`` is given;
their flash launches (the prefill's ``sdpa``) come back over the channel.
Failures print the report tables before exiting non-zero.  Exit status is
the verdict:

    PYTHONPATH=src python -m repro_torch.bench.smoke_trace [--device cpu]
"""
from __future__ import annotations

from ..core.api import resolve_device
from .common import check, finish_gate, gate_main
from .serve_sections import trace_workload
from .smoke_cluster import KERNELS, LENS, N_STREAMS, WORKERS


def run(device=None, *, rows: list | None = None) -> list[str]:
    resolve_device(device)
    rows = [] if rows is None else rows
    launches: dict = {}
    metrics, problems = trace_workload(device, launches)
    check(not problems, "tracing changed outputs or histograms leak samples",
          *problems[:6])
    kinds = metrics["spans_by_kind"]
    check(metrics["worker_processes"] == WORKERS,
          f"expected spans from {WORKERS} worker processes, "
          f"got {metrics['worker_processes']}", metrics)
    check(metrics["events_off_root"] == 0,
          f"{metrics['events_off_root']} events not under the root trace id",
          metrics)
    check(metrics["spans_dropped"] == 0
          and metrics["dropped_reported_by_export"] == 0,
          "spans were dropped on a workload far below ring capacity", metrics)
    # workload shape: 8 routed submissions seen on BOTH sides of the channel,
    # one result per stream, one burst-admission prefill group per worker,
    # lockstep steps to the longest stream (max(LENS) - 1 per worker)
    check(kinds.get("submit") == 2 * WORKERS * N_STREAMS,
          f"expected {2 * WORKERS * N_STREAMS} submit spans "
          f"(parent route + worker admit), got {kinds.get('submit')}", metrics)
    check(kinds.get("result") == WORKERS * N_STREAMS,
          f"expected {WORKERS * N_STREAMS} result events, "
          f"got {kinds.get('result')}", metrics)
    check(metrics["prefill_groups"] == WORKERS,
          f"expected {WORKERS} prefill groups, "
          f"got {metrics['prefill_groups']}", metrics)
    check(metrics["decode_steps"] == WORKERS * (max(LENS) - 1),
          f"expected {WORKERS * (max(LENS) - 1)} decode steps, "
          f"got {metrics['decode_steps']}", metrics)
    check(kinds.get("admit_wait") == WORKERS * N_STREAMS,
          f"expected {WORKERS * N_STREAMS} admission waits, "
          f"got {kinds.get('admit_wait')}", metrics)
    check(kinds.get("crossing", 0) > 0 and kinds.get("frame", 0) > 0,
          "crossing/frame spans missing from the merged timeline", metrics)
    check(metrics["crossing_samples"] > 0,
          "per-(unit, signature) crossing histograms are empty", metrics)
    rows += [
        f"smoke_trace/bit_identity,nan,streams={WORKERS * N_STREAMS};ok",
        f"smoke_trace/flight_record,nan,"
        f"worker_processes={metrics['worker_processes']};"
        f"worker_spans={metrics['worker_spans']};"
        f"spans_dropped={metrics['spans_dropped']}",
        f"smoke_trace/workload_shape,nan,"
        f"submits={kinds.get('submit')};results={kinds.get('result')};"
        f"prefill_groups={metrics['prefill_groups']};"
        f"steps={metrics['decode_steps']}",
    ]
    finish_gate(rows, "smoke_trace", device, KERNELS,
                launches["untraced"], launches["traced"])
    return rows


def main(argv=None) -> int:
    return gate_main("SMOKE-TRACE", "smoke_trace", run, 240, argv)


if __name__ == "__main__":
    raise SystemExit(main())
