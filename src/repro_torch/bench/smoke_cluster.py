"""CI smoke gate for the cross-process cluster tier: bounded, assertion-driven.

A weak-scaling duel over the paged, prefix-shared attention-decode workload
(:func:`repro_torch.bench.serve_sections.cluster_workload`, geometry
``SMALL``):

* **baseline** — ONE spawned worker serves a 4-stream common-prefix burst
  (the same shape ``smoke_decode``'s prefix gate validates) and then
  persists its warm plan with ``save_aot`` over the cluster channel;
* **cluster** — TWO workers boot **cold from that AOT cache** and serve
  twice the workload: the baseline burst plus a second burst whose prefix
  page hashes to the *other* worker, so prefix affinity splits the traffic
  into one burst per worker.

Gated:

* every cluster stream is **bit-identical** to ``decode_reference`` solo
  decoding at the same fixed capacity;
* **weak scaling** — aggregate tokens per crossing across the cluster is
  ≥ the single-worker baseline;
* **second boot compiles 0** — the cluster workers' aggregate compile
  count is 0: everything the workload needs came from the AOT cache;
* **prefix affinity works** — every prompt routed by affinity (no spill),
  one burst per worker, and each worker's prefix index actually shares
  (aggregate ``prefix_hits`` ≥ 6: 3 followers per 4-stream burst × 2).

On the card each spawned worker opens its own CUDA context and counts its
own kernel launches since boot; the gate sums them with this process's
(the in-process oracle's).  The workers step with ``decode_step``, whose
attention is plain torch ops, so the kernel this path launches is the
prefill's flash attention.  Failures print the offending report tables
before exiting non-zero.  Exit status is the verdict:

    PYTHONPATH=src python -m repro_torch.bench.smoke_cluster [--device cpu]
"""
from __future__ import annotations

from ..core.api import resolve_device
from .common import check, finish_gate, gate_main
from .serve_sections import SMALL, cluster_workload

# the workload's one definition is serve_sections.SMALL (the reference's
# smoke_cluster constants); smoke_trace checks its span counts against these
N_STREAMS, LENS = SMALL.n_streams, SMALL.lens      # per burst; staggered retirement
WORKERS = SMALL.workers
# the prefill's ``sdpa``: one flash launch per prefill group in each worker
KERNELS = ("flash_attention",)


def run(device=None, *, rows: list | None = None) -> list[str]:
    resolve_device(device)
    rows = [] if rows is None else rows
    metrics, problems, base, clus, extra = cluster_workload(device, SMALL)
    tables = (base.table(), clus.table())
    check(not problems, "cluster streams not bit-identical",
          *problems[:4], *tables)
    check(metrics["first_boot_compiles"] > 0,
          "baseline worker compiled nothing — the AOT save was not warm",
          *tables)
    check(metrics["second_boot_compiles"] == 0,
          f"cluster workers compiled {metrics['second_boot_compiles']} times "
          f"despite booting from the AOT cache", *tables)
    check(metrics["tokens_per_crossing"] >=
          metrics["baseline_tokens_per_crossing"],
          f"weak scaling broke the crossing economics: "
          f"{metrics['tokens_per_crossing']:.3f} < "
          f"{metrics['baseline_tokens_per_crossing']:.3f}", *tables)
    check(metrics["routed_affinity"] == 2 * N_STREAMS
          and metrics["routed_spill"] == 0,
          "every full-page prompt must route by affinity", *tables)
    check(metrics["streams_per_worker"] == [N_STREAMS, N_STREAMS],
          f"affinity should land one burst per worker, got "
          f"{metrics['streams_per_worker']}", *tables)
    check(metrics["prefix_hits"] >= 2 * (N_STREAMS - 1),
          f"expected >= {2 * (N_STREAMS - 1)} cross-worker prefix hits, "
          f"got {metrics['prefix_hits']}", *tables)
    check(clus.failures == 0, "cluster reported failed streams", *tables)
    check(metrics["aot_exported_units"] >= 1 and metrics["aot_signatures"] >= 1,
          f"AOT save exported nothing: {metrics}")
    rows += [
        f"smoke_cluster/bitident,nan,streams={metrics['streams']};ok",
        f"smoke_cluster/weak_scaling,nan,"
        f"workers={metrics['workers']};"
        f"cluster_tpc={metrics['tokens_per_crossing']:.3f};"
        f"baseline_tpc={metrics['baseline_tokens_per_crossing']:.3f}",
        f"smoke_cluster/affinity,nan,"
        f"affinity={metrics['routed_affinity']};spill={metrics['routed_spill']};"
        f"prefix_hits={metrics['prefix_hits']};"
        f"tokens_reused={metrics['prefix_tokens_reused']}",
        f"smoke_cluster/aot_boot,nan,"
        f"first_boot_compiles={metrics['first_boot_compiles']};"
        f"second_boot_compiles={metrics['second_boot_compiles']};"
        f"exported_units={metrics['aot_exported_units']};"
        f"signatures={metrics['aot_signatures']}",
    ]
    finish_gate(rows, "smoke_cluster", device, KERNELS,
                extra["launches"]["baseline"], extra["launches"]["cluster"])
    return rows


def main(argv=None) -> int:
    return gate_main("SMOKE-CLUSTER", "smoke_cluster", run, 240, argv)


if __name__ == "__main__":
    raise SystemExit(main())
