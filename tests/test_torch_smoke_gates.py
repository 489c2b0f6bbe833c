"""The port's in-process smoke gates against the reference's, on the CPU.

``repro_torch.bench.smoke``, ``smoke_serve`` and ``smoke_decode`` are ports
of ``benchmarks/smoke.py``, ``smoke_serve.py`` and ``smoke_decode.py``.
Each runs here as its program would (``main(["--device", "cpu"])``, exit
status 0) and every deterministic field of every row equals the row the
reference gate's ``run()`` prints on the CPU; the fields that depend on
thread timing (how many batches a window coalesced) and the wall times are
not compared.  The gates' outputs equal the reference's: the scheme sweep's
to the engine tolerance, every decoded stream exactly.  Without a card and
without ``--device cpu`` every gate raises.  The reference package is
imported inside the tests that use it, so the ``gpu`` test also runs on
the card's machine, which has no JAX.
"""
import contextlib
import importlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import mixed
from repro_torch.bench import serve_sections, smoke, smoke_decode, smoke_serve

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-3, 2e-4               # tests/test_core_engine.py:53
GATES = {"smoke": smoke, "smoke_serve": smoke_serve, "smoke_decode": smoke_decode}
ALL_GATES = ("smoke", "smoke_serve", "smoke_decode", "smoke_cluster", "smoke_trace")
# fields fixed by how concurrent requests met a batching window, not by the
# workload: compared by the gates' own inequalities, not across packages
TIMING = {"smoke_serve/batched": {"batches", "cpr", "occupancy"},
          "smoke_decode/tokens_per_crossing": {"request_level"},
          "smoke_decode/attn_tokens_per_crossing": {"request_level"}}


def reference_gate(name):
    """``benchmarks.<name>`` (the reference's gate, importing ``repro``)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"benchmarks.{name}")


def parse(rows):
    """``{row name: (wall field, {key: value})}`` from ``name,us,k=v;k=v``."""
    out = {}
    for row in rows:
        name, wall, derived = row.split(",", 2)
        out[name] = (wall, dict(kv.split("=", 1) for kv in derived.split(";")
                                if "=" in kv))
    return out


def run_main(module, argv):
    """A gate's ``main(argv)``: its exit status and standard output lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    return rc, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def port_rows():
    """Each gate run once as its program would be, on the CPU."""
    out = {}
    for name, module in GATES.items():
        rc, lines = run_main(module, ["--device", "cpu"])
        assert rc == 0, (name, lines)
        out[name] = lines
    return out


def reference_rows(name):
    ref = reference_gate(name)
    if name == "smoke_decode":       # its optional accelerator section skips here
        return (ref.run() + ref.run_attn() + ref.run_paged_kernel() + ref.run_prefix()
                + ref.run_multimodel())
    return ref.run()


@pytest.mark.parametrize("name", list(GATES))
def test_rows_equal_the_reference_gate(port_rows, name):
    mine, theirs = parse(port_rows[name]), parse(reference_rows(name))
    extra = {f"{name}/launches"} | (
        {"smoke_decode/card_paged_kernel"} if name == "smoke_decode" else set())
    assert set(mine) == set(theirs) | extra
    for row, (_, fields) in theirs.items():
        skip = TIMING.get(row, set())
        got = {k: v for k, v in mine[row][1].items() if k not in skip}
        want = {k: v for k, v in fields.items() if k not in skip}
        assert got == want, row
        assert set(mine[row][1]) == set(fields), row
    # the CPU units run the kernels' plain versions, which count nothing
    assert mine[f"{name}/launches"][1] == {}
    assert port_rows[name][-1] == f"{name}/launches,nan,none"


def test_smoke_decode_card_section_not_requested_on_the_cpu(port_rows):
    rows = port_rows["smoke_decode"]
    assert "smoke_decode/card_paged_kernel,nan,not_requested=device_cpu" in rows
    assert not any("skipped" in r for r in rows)


@pytest.mark.parametrize("scheme", smoke.SWEEP)
def test_smoke_scheme_outputs_equal_the_reference(scheme):
    from repro import mixed as jmixed

    ref = reference_gate("smoke")
    jprog, jx = ref.build_program()
    prog, x = smoke.build_program()
    assert np.array_equal(jx, x)
    assert all(np.array_equal(jprog.constants[k], prog.constants[k]) for k in jprog.constants)
    want = jmixed.trace(jprog).plan(scheme).compile()(jx)
    hybrid = mixed.trace(prog).plan(scheme).compile(backend="cpu")
    got = hybrid(x)
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=RTOL, atol=ATOL)


def test_smoke_serve_program_is_the_reference_program():
    ref = reference_gate("smoke_serve")
    jprog, prog = ref.build_program(), serve_sections.build_program()
    assert sorted(jprog.functions) == sorted(prog.functions)
    assert all(np.array_equal(jprog.constants[k], prog.constants[k]) for k in jprog.constants)


def _solo_streams(pkg, vocab, dm, seed, prompt_len, lens, capacity, attn_ctx=None):
    """Every prompt of a gate's burst decoded solo through ``decode_reference``
    by either package (``backend="cpu"`` for the port)."""
    progs = importlib.import_module(f"{pkg}.models.programs")
    serve = importlib.import_module(f"{pkg}.serve")
    mx = importlib.import_module(f"{pkg}.mixed")
    prog = (progs.export_decode_lm(vocab=vocab, d_model=dm) if attn_ctx is None
            else progs.export_attn_decode_lm(vocab=vocab, d_model=dm, max_context=attn_ctx))
    planned = mx.trace(prog).plan("tech-gfp")
    kw = {"backend": "cpu"} if pkg == "repro_torch" else {}
    prefill = planned.compile(**kw)
    step = planned.for_entry("decode_step").compile(**kw)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, (prompt_len,), dtype=np.int32) for _ in lens]
    return [serve.decode_reference(prefill, step, p, n, capacity=capacity)
            for p, n in zip(prompts, lens)]


def _workload_streams(pkg, name):
    """The streams a smoke_decode section decodes, by either package."""
    port = pkg == "repro_torch"
    ref = None if port else reference_gate("smoke_decode")
    if name == "decode_lm":
        return _solo_streams(pkg, smoke_decode.VOCAB, smoke_decode.DM, 7,
                             smoke_decode.PROMPT_LEN, smoke_decode.LENS,
                             smoke_decode.N_STREAMS)
    if name == "attn":
        return _solo_streams(pkg, 32, 16, 11, 6, (6, 8, 10, 12), 4, attn_ctx=24)
    if name == "paged_kernel":
        decode_all = (smoke_decode.paged_kernel_workload("cpu") if port
                      else ref.paged_kernel_workload())[0]
        return decode_all()[0]
    if name.startswith("prefix"):
        decode_all = (serve_sections.prefix_workload("cpu") if port
                      else ref.prefix_workload())[0]
        return decode_all(share=name == "prefix_shared")[0]
    decode_all = (smoke_decode.multimodel_workload("cpu") if port
                  else ref.multimodel_workload())[0]
    return [(m, p, t) for m, p, t in decode_all()[0]]


@pytest.mark.parametrize("name", ["decode_lm", "attn", "paged_kernel", "prefix_shared",
                                  "prefix_unshared", "multimodel"])
def test_smoke_decode_streams_equal_the_reference(name):
    mine = _workload_streams("repro_torch", name)
    theirs = _workload_streams("repro", name)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        if name == "multimodel":
            assert a[0] == b[0] and np.array_equal(a[1], b[1])
            a, b = a[2], b[2]
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ALL_GATES)
def test_gate_raises_without_a_card(monkeypatch, name):
    """No card and no ``--device cpu``: the gate raises before it runs
    anything (it never skips)."""
    module = importlib.import_module(f"repro_torch.bench.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        module.main([])


def test_launch_row_and_required_kernels():
    from repro_torch.bench.common import (
        GateFailure, launch_row, launches_from_rows, require_launches)

    launches = {"paged_decode_attention": {"split": 7, "simt": 0},
                "flash_attention": {"tf32x3": 0, "wgmma": 0}}
    row = launch_row("g", launches)
    assert row == "g/launches,nan,paged_decode_attention:split=7"
    assert launches_from_rows(["g/x,nan,a=1", row], "g") == {
        "paged_decode_attention": {"split": 7}}
    assert launches_from_rows(["g/launches,nan,none"], "g") == {}
    require_launches(launches, ("flash_attention",), "cpu", "g")      # not the card
    if torch.cuda.is_available():
        with pytest.raises(GateFailure, match="flash_attention"):
            require_launches(launches, ("flash_attention",), None, "g")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GATES))
def test_gate_passes_on_the_card(name):
    """Each in-process gate on the card: exit 0, its path's kernels
    launched (the gate fails otherwise), and the card section's tokens the
    CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc, lines = run_main(GATES[name], [])
    assert rc == 0, lines
    if name == "smoke_decode":
        assert any(r.startswith("smoke_decode/card_paged_kernel,nan,tokens=8;") for r in lines)


def test_a_failed_check_prints_the_rows_and_exits_1(monkeypatch, capsys):
    """A gate whose check fails prints the rows it has, its launches and the
    check's numbers, and exits 1 (nothing is caught while the run exits 0)."""
    monkeypatch.setattr(smoke, "ABLATION", ["tech-gfp", "tech"])
    assert smoke.main(["--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    assert "smoke/tech," in out and "smoke/tech-gfp," in out
    assert out.splitlines()[-1] == "smoke/launches,nan,none"
    assert "SMOKE FAILED: crossing regression: tech-gfp=2 < tech=50" in err
    assert "full sweep: {'qemu': 0, 'tech': 50" in err
