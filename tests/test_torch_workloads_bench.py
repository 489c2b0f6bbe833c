"""The port at bench scale against the JAX package's recorded counters.

``chip_smoke.py`` holds the card's bench-scale sweep against
``src/repro_torch/workloads/reference_counters.json``; this file holds the
same sweep with the units on the CPU, through the same comparison
(:func:`repro_torch.bench.common.reference_mismatches`): each scheme's cold
and warm counters, coverage, units and output dtypes equal the reference's,
and its outputs lie within 2e-3/2e-4 of pure interpretation.
"""
import pytest

from repro_torch.bench import table3_library
from repro_torch.bench.common import load_reference, reference_mismatches, sweep_schemes
from repro_torch.workloads import WORKLOADS

REFERENCE = load_reference()


def test_reference_covers_every_workload_and_app():
    assert REFERENCE["scale"] == "bench"
    assert sorted(REFERENCE["workloads"]) == sorted(WORKLOADS)
    assert sorted(REFERENCE["table3"]) == sorted(table3_library.APPS)
    assert REFERENCE["native_infeasible"] == sorted(
        n for n, s in WORKLOADS.items() if s.has_host_ops)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_at_bench_scale_matches_reference(name):
    prog, args = WORKLOADS[name].build("bench")
    runs = sweep_schemes(prog, args, repeats=1, device="cpu")
    assert reference_mismatches({name: runs},
                                {name: REFERENCE["workloads"][name]}) == []


def test_library_apps_at_bench_scale_match_reference():
    sweeps = table3_library.sweep("bench", device="cpu", repeats=1)
    assert reference_mismatches(sweeps, REFERENCE["table3"]) == []
