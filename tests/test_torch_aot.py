"""AOT persistence (repro_torch.serve.aot): save/load of plan artifacts.

Covers the compile-count-0 contract end to end:

* in-process round trip — a loaded plan replays the saved workload with
  ZERO compiles (no first-signature unit call) and bit-identical outputs, and unseen signatures fall
  back to the normal compile path,
* the fresh-process boot — save in this process, ``spawn`` a brand-new
  interpreter that loads the cache and decodes; outputs are bit-identical
  to the in-process oracle and the second boot's compile count is 0,
* the trust boundary — missing/corrupt manifest and program-digest
  tampering raise :class:`AotError` (never loaded blind); a version skew
  or a corrupt blob degrades to a warning + recompile of exactly the
  affected scope, with results still correct.
"""
import json
import multiprocessing
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch import mixed
from repro_torch.core import ProgramBuilder
from repro_torch.serve import AotError, load_planned, program_digest, save_planned
from repro_torch.serve.aot import MANIFEST, PROGRAM_FILE

VOCAB, DM, SEQ = 16, 8, 4


def build_program(width: int = 12, repeats: int = 6, builder=ProgramBuilder):
    """Offloadable dense tower + host-only check: the PFO shape whose
    offload units export cleanly while the residual stays host-side."""
    pb = builder("aot-test")
    W = (np.random.default_rng(0).standard_normal((width, width)) / 10).astype(
        np.float32)
    pb.constant("W", W)

    step = pb.function("step", ["x"])
    step.use_global("W")
    h = step.emit("matmul", "x", "W")
    h = step.emit("tanh", h)
    step.build([h])

    dense = pb.function("dense", ["x"])
    out = dense.repeat("step", repeats, "x")
    dense.build([out])

    m = pb.function("main", ["x"])
    y = m.call("dense", "x")
    y = m.emit("host_assert_finite", y, tag="aot-test")
    z = m.emit("mul", y, y)
    m.build([z])
    return pb.build("main")


def arg(rows: int = 8, width: int = 12):
    rng = np.random.default_rng(7)
    return rng.standard_normal((rows, width)).astype(np.float32)


@pytest.fixture()
def cache_dir(tmp_path):
    """A saved artifact from a warm plan + the warm plan's outputs."""
    planned = mixed.trace(build_program()).plan("tech-gfp")
    hybrid = planned.compile(backend="cpu")
    outs = hybrid(arg())
    assert hybrid.last_report.compiles > 0          # the save really was warm
    path = tmp_path / "cache"
    summary = planned.save_aot(path)
    assert summary["exported_units"] >= 1
    assert summary["skipped_units"] == 0
    return path, outs


# ---------------------------------------------------------------------------
# in-process round trip
# ---------------------------------------------------------------------------


def test_roundtrip_zero_compiles_bit_identical(cache_dir):
    path, oracle = cache_dir
    loaded = load_planned(path).compile(backend="cpu")
    outs, report = loaded.call_reported(arg())
    assert report.compiles == 0                     # the headline contract
    assert loaded.planned.unit_cache.aot_dispatches > 0
    for o, ref in zip(outs, oracle):
        np.testing.assert_array_equal(o, ref)       # bit-identical, not close


def test_save_load_via_planned_methods(cache_dir):
    # PlannedProgram.save_aot / load_aot are the public surface
    path, oracle = cache_dir
    from repro_torch.core.api import PlannedProgram
    loaded = PlannedProgram.load_aot(path)
    np.testing.assert_array_equal(loaded.compile(backend="cpu")(arg())[0], oracle[0])


def test_unseen_signature_falls_back_to_compile(cache_dir):
    path, _ = cache_dir
    loaded = load_planned(path).compile(backend="cpu")
    outs, report = loaded.call_reported(arg(rows=3))    # never exported
    assert report.compiles > 0                      # normal path, not a crash
    ref = mixed.trace(build_program()).plan("tech-gfp").compile(backend="cpu")(arg(rows=3))
    np.testing.assert_array_equal(outs[0], ref[0])


def test_resave_from_loaded_plan_keeps_blobs(cache_dir, tmp_path):
    # a warm *loaded* worker can re-save: loaded executables are carried
    # verbatim even though their unit bodies were never re-traced
    path, oracle = cache_dir
    loaded = load_planned(path)
    loaded.compile(backend="cpu")(arg())
    second = tmp_path / "cache2"
    summary = save_planned(loaded, second)
    assert summary["signatures"] >= 1
    replayed = load_planned(second).compile(backend="cpu")
    outs, report = replayed.call_reported(arg())
    assert report.compiles == 0
    np.testing.assert_array_equal(outs[0], oracle[0])


def test_save_rejects_unit_filter(tmp_path):
    planned = mixed.trace(build_program()).plan(
        "tech-gfp", unit_filter=lambda fname: True)
    with pytest.raises(AotError, match="unit_filter"):
        planned.save_aot(tmp_path / "cache")


# ---------------------------------------------------------------------------
# trust boundary
# ---------------------------------------------------------------------------


def test_missing_and_corrupt_manifest_raise(tmp_path, cache_dir):
    with pytest.raises(AotError, match="no loadable"):
        load_planned(tmp_path / "nowhere")
    path, _ = cache_dir
    (path / MANIFEST).write_text("{not json")
    with pytest.raises(AotError, match="no loadable"):
        load_planned(path)


def test_future_format_refused(cache_dir):
    path, _ = cache_dir
    manifest = json.loads((path / MANIFEST).read_text())
    manifest["format"] = 99
    (path / MANIFEST).write_text(json.dumps(manifest))
    with pytest.raises(AotError, match="format"):
        load_planned(path)


def test_tampered_program_refused(cache_dir):
    # flip one op kind: digest check must refuse the whole artifact
    path, _ = cache_dir
    prog = json.loads((path / PROGRAM_FILE).read_text())
    prog["functions"]["step"]["ops"][0]["kind"] = "add"
    (path / PROGRAM_FILE).write_text(json.dumps(prog))
    with pytest.raises(AotError, match="digest mismatch"):
        load_planned(path)


def test_corrupt_blob_recompiles_that_signature(cache_dir):
    path, oracle = cache_dir
    blobs = sorted(path.glob("unit-*.pt2"))
    assert blobs
    blobs[0].write_bytes(b"\x00garbage")
    with pytest.warns(UserWarning, match="corrupt executable"):
        loaded = load_planned(path)
    outs, report = loaded.compile(backend="cpu").call_reported(arg())
    np.testing.assert_array_equal(outs[0], oracle[0])   # correct either way


def test_version_skew_recompiles_everything(cache_dir):
    path, oracle = cache_dir
    manifest = json.loads((path / MANIFEST).read_text())
    manifest["torch"] = "0.0.0-elsewhere"
    (path / MANIFEST).write_text(json.dumps(manifest, sort_keys=True))
    with pytest.warns(UserWarning, match="ignoring exported"):
        loaded = load_planned(path)
    outs, report = loaded.compile(backend="cpu").call_reported(arg())
    assert report.compiles > 0                      # nothing served from disk
    np.testing.assert_array_equal(outs[0], oracle[0])


def test_program_digest_is_content_addressed():
    assert program_digest(build_program()) == program_digest(build_program())
    assert program_digest(build_program()) != program_digest(
        build_program(repeats=7))


# ---------------------------------------------------------------------------
# the fresh-process boot (the point of the subsystem)
# ---------------------------------------------------------------------------


def _fresh_boot(path, out_file):
    """Child entry (spawn): load the cache, replay the workload, report."""
    from repro_torch.serve import load_planned as load  # noqa: PLC0415 — fresh proc
    hybrid = load(path).compile(backend="cpu")
    outs, report = hybrid.call_reported(arg())
    np.savez(out_file, out=outs[0], compiles=report.compiles,
             dispatches=hybrid.planned.unit_cache.aot_dispatches)


def test_fresh_process_second_boot_compiles_zero(cache_dir, tmp_path):
    path, oracle = cache_dir
    src = str(Path(__file__).resolve().parents[1] / "src")
    if src not in sys.path:                         # survive the spawn trip
        sys.path.insert(0, src)
    out_file = tmp_path / "child.npz"
    ctx = multiprocessing.get_context("spawn")      # CUDA does not survive a fork either
    child = ctx.Process(target=_fresh_boot, args=(str(path), str(out_file)))
    child.start()
    child.join(timeout=300)
    assert child.exitcode == 0
    with np.load(out_file) as z:
        np.testing.assert_array_equal(z["out"], oracle[0])
        assert int(z["compiles"]) == 0              # cold process, warm cache
        assert int(z["dispatches"]) > 0


def test_unit_index_matches_reference(cache_dir, tmp_path):
    """Parity with the JAX package: the same warm plan saves the same units
    at the same signature shapes, with the same program digest."""
    from repro import mixed as jmixed
    from repro.core import ProgramBuilder as JBuilder

    path, _ = cache_dir
    jprog = build_program(builder=JBuilder)
    jplanned = jmixed.trace(jprog).plan("tech-gfp")
    jplanned.compile()(arg())
    jplanned.save_aot(tmp_path / "jcache")
    mine = json.loads((path / MANIFEST).read_text())
    ref = json.loads((tmp_path / "jcache" / MANIFEST).read_text())
    assert mine["program_digest"] == ref["program_digest"]
    assert mine["analysis"] == ref["analysis"] and mine["scheme"] == ref["scheme"]

    def index(m):
        # unit key without the device, and each signature's shapes (the
        # dtype strings are each framework's own spelling)
        return sorted((json.dumps(u["key"][:2]),
                       json.dumps([[[g[0] for g in s["globals"]],
                                    [a[0] for a in s["args"]]]
                                   for s in u["signatures"]]))
                      for u in m["units"])
    assert index(mine) == index(ref)


def test_blobs_hold_no_weights(tmp_path):
    """The unit's globals are inputs of its exported program, not lifted
    constants: a 16x wider weight leaves every blob's size alone (up to
    the shapes spelled in its graph)."""
    sizes = []
    for width in (12, 48):
        planned = mixed.trace(build_program(width=width)).plan("tech-gfp")
        planned.compile(backend="cpu")(arg(width=width))
        summary = planned.save_aot(tmp_path / f"w{width}")
        manifest = json.loads((tmp_path / f"w{width}" / MANIFEST).read_text())
        per_blob = [sig["bytes"] for u in manifest["units"] for sig in u["signatures"]]
        assert sum(per_blob) == summary["bytes"]
        sizes.append(summary["bytes"])
    weight_growth = 4 * (48 * 48 - 12 * 12)
    assert abs(sizes[1] - sizes[0]) < weight_growth / 4, sizes
