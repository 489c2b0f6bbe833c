"""The port's cluster smoke gates on the CPU (spawned CPU workers).

``repro_torch.bench.smoke_cluster`` and ``smoke_trace`` are ports of
``benchmarks/smoke_cluster.py`` and ``smoke_trace.py``.  The JAX workers
are not spawned here: each port gate runs as its program would
(``main(["--device", "cpu"])``, exit status 0, so every one of the
reference's literal checks held: bit-identity, compiles 0 at the second
boot, every prompt routed by affinity, ``prefix_hits >= 6``, the span
counts of the workload) and its rows equal those the reference's code
prints from ``BENCH_serve.json``'s ``decode_cluster`` and
``observability`` sections.
"""
import contextlib
import io
import json
from pathlib import Path

import pytest

from repro_torch.bench import smoke_cluster, smoke_trace

BENCH = json.loads((Path(__file__).resolve().parents[1] / "BENCH_serve.json").read_text())


def run_main(module):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(["--device", "cpu"])
    return rc, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def cluster_rows():
    rc, lines = run_main(smoke_cluster)
    assert rc == 0, lines
    return lines


@pytest.fixture(scope="module")
def trace_rows():
    rc, lines = run_main(smoke_trace)
    assert rc == 0, lines
    return lines


def test_cluster_rows_are_bench_serves(cluster_rows):
    m = BENCH["decode_cluster"]
    assert m["second_boot_compiles"] == 0 and m["prefix_hits"] >= 6
    assert cluster_rows == [
        f"smoke_cluster/bitident,nan,streams={m['streams']};ok",
        f"smoke_cluster/weak_scaling,nan,workers={m['workers']};"
        f"cluster_tpc={m['tokens_per_crossing']:.3f};"
        f"baseline_tpc={m['baseline_tokens_per_crossing']:.3f}",
        f"smoke_cluster/affinity,nan,affinity={m['routed_affinity']};"
        f"spill={m['routed_spill']};prefix_hits={m['prefix_hits']};"
        f"tokens_reused={m['prefix_tokens_reused']}",
        f"smoke_cluster/aot_boot,nan,first_boot_compiles={m['first_boot_compiles']};"
        f"second_boot_compiles={m['second_boot_compiles']};"
        f"exported_units={m['aot_exported_units']};signatures={m['aot_signatures']}",
        # the workers' CPU units run the plain versions, which count nothing
        "smoke_cluster/launches,nan,none",
    ]


def test_trace_rows_are_bench_serves(trace_rows):
    from repro_torch.bench import serve_sections

    m = serve_sections.port_observability(BENCH["observability"], "cpu")
    kinds = m["spans_by_kind"]
    W, N, lens = smoke_cluster.WORKERS, smoke_cluster.N_STREAMS, smoke_cluster.LENS
    # the reference's literal expectations (benchmarks/smoke_trace.py:127-174)
    assert kinds["submit"] == 2 * W * N and kinds["result"] == W * N
    assert m["prefill_groups"] == W and m["decode_steps"] == W * (max(lens) - 1)
    assert kinds["admit_wait"] == W * N and m["spans_dropped"] == 0
    assert trace_rows == [
        f"smoke_trace/bit_identity,nan,streams={W * N};ok",
        f"smoke_trace/flight_record,nan,worker_processes={m['worker_processes']};"
        f"worker_spans={m['worker_spans']};spans_dropped={m['spans_dropped']}",
        f"smoke_trace/workload_shape,nan,submits={kinds['submit']};"
        f"results={kinds['result']};prefill_groups={m['prefill_groups']};"
        f"steps={m['decode_steps']}",
        "smoke_trace/launches,nan,none",
    ]


def test_gates_run_the_reference_cluster_workload():
    """One definition of the workload, ``serve_sections.SMALL``, holds the
    reference's ``smoke_cluster`` constants, and the trace gate checks its
    span counts against the cluster gate's."""
    from repro_torch.bench import serve_sections as ss

    g = ss.SMALL
    assert (g.vocab, g.d_model, g.max_context, g.page, g.prompt_len, g.prefix_len,
            g.lens, g.workers) == (32, 16, 32, 4, 12, 8, (5, 6, 7, 8), 2)
    assert (smoke_trace.LENS, smoke_trace.N_STREAMS, smoke_trace.WORKERS) == (
        g.lens, g.n_streams, g.workers)
