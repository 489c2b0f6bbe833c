"""The serving sections of ``BENCH_serve.json`` on the port (CPU units).

``request_level`` (MixedServer), ``decode_continuous`` (the prefix-sharing
burst), ``decode_cluster`` (one worker, ``save_aot``, two workers booted
from the cache) and ``observability`` (the traced cluster run) come from
:mod:`repro_torch.bench.serve_sections`, the port's copies of the
reference's section workloads, and equal the committed file field by
field.  The cluster's tokens also equal the JAX package's solo decode of
the same prompts.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch.bench import serve_sections as ss

BENCH = json.loads((Path(__file__).resolve().parents[1] / "BENCH_serve.json").read_text())


@pytest.fixture(scope="module")
def cluster_run():
    return ss.cluster_workload(backend="cpu")


@pytest.mark.parametrize("name", ["request_level", "decode_continuous"])
def test_in_process_section_equals_bench_serve(name):
    got = ss.sections("cpu", [name])
    assert ss.mismatches(got) == []
    assert got[name] == BENCH[name]


def test_decode_cluster_equals_bench_serve(cluster_run):
    metrics, problems, _base, _clus, extra = cluster_run
    assert problems == []
    got = dict(metrics, bit_identity_violations=len(problems))
    assert ss.mismatches({"decode_cluster": got}) == []
    assert extra["aot"]["skipped_units"] == 0
    # each run's workers ship their own kernel counts over the channel; the
    # CPU units run the plain versions, which count nothing
    for run in ("baseline", "cluster"):
        counts = extra["launches"][run]
        assert set(counts) == {"rmsnorm", "flash_attention", "decode_attention",
                               "paged_decode_attention", "ssd_scan"}
        assert all(n == 0 for routes in counts.values() for n in routes.values())


def test_decode_cluster_tokens_equal_reference(cluster_run):
    """Every cluster stream equals the JAX package's solo greedy decode
    (same seeded weights, same prompts, same capacity)."""
    from repro import mixed as jmixed
    from repro.models.programs import export_attn_decode_lm as jexport
    from repro.serve import decode_reference as jdecode_reference

    *_, extra = cluster_run
    geo = ss.SMALL
    planned = jmixed.trace(jexport(vocab=geo.vocab, d_model=geo.d_model,
                                   max_context=geo.max_context)).plan("tech-gfp")
    prefill, step = planned.compile(), planned.for_entry("decode_step").compile()
    for (p, n), out in zip(extra["both"], extra["outs"]):
        ref = jdecode_reference(prefill, step, p, n, capacity=geo.n_streams)
        np.testing.assert_array_equal(out, ref)


def test_observability_equals_bench_serve():
    got = ss.sections("cpu", ["observability"])
    assert ss.mismatches(got) == []
