"""The port's examples (``repro_torch.examples``) against the reference's.

``quickstart``, ``decode_stream`` and ``offload_library`` print the
reference's counts: crossings, conversion builds, GRT hits and coverage per
scheme, plans and cache hits, tokens per crossing, stream slots and steps,
offloaded units per library set (timings masked).  ``serve_mixed`` serves
bit-identical batched results with fewer crossings per request, and
``train_lm --tiny`` lowers the loss and resumes exactly from its
checkpoint.  Without a card and without ``--device cpu`` every example
raises.  The reference package is imported inside the tests that use it.
"""
import contextlib
import importlib
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.examples import (
    decode_stream,
    offload_library,
    quickstart,
    serve_mixed,
    train_lm,
)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_mixed", "decode_stream", "offload_library", "train_lm")
# wall-clock readings in the printed lines
TIMED = re.compile(r"\d+(\.\d+)? ms|mean admit wait.*")


def reference_example(name):
    """``examples/<name>.py`` of the reference, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"reference_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    return [TIMED.sub("<t>", line) for line in buf.getvalue().splitlines()]


@pytest.mark.parametrize("name", ["quickstart", "decode_stream"])
def test_printed_counts_equal_the_reference(name):
    port = {"quickstart": quickstart, "decode_stream": decode_stream}[name]
    assert printed(port.main, ["--device", "cpu"]) == printed(reference_example(name).main)


def test_quickstart_returns_the_printed_counts():
    got = quickstart.run("cpu")
    assert {s: r["guest_to_host"] for s, r in got["schemes"].items()} == {
        "qemu": 0, "tech": 100, "tech-g": 100, "tech-gf": 50, "tech-gfp": 2}
    assert (got["plans"], got["cache_hits"], got["calls"]) == (2, 3, 5)


@pytest.mark.parametrize("app", offload_library.APPS)
def test_offload_library_units_and_outputs_equal_the_reference(app):
    """At the test scale: the units each library set offloads equal the
    reference's, and so do the outputs (2e-3)."""
    from repro.workloads.libs import build_library_app as jbuild
    from repro.workloads.libs import library_unit_filter as jfilter
    from repro_torch.workloads.libs import build_library_app, library_unit_filter

    ref = reference_example("offload_library")
    prog, args = build_library_app(app, "test")
    jprog, jargs = jbuild(app, "test")
    for (label, libs) in offload_library.LIB_SETS:
        _, out, hybrid = offload_library.bench(prog, args, library_unit_filter(libs),
                                               device="cpu")
        _, jout, jhybrid = ref.bench(jprog, jargs, jfilter(libs))
        assert sorted(hybrid.last_plan.units) == sorted(jhybrid.last_plan.units), label
        np.testing.assert_allclose(np.asarray(out[0]), np.asarray(jout[0]),
                                   rtol=2e-3, atol=2e-3)


def test_offload_library_run_prints_every_library_set():
    lines = printed(offload_library.run, "cpu", scale="test")
    for app in offload_library.APPS:
        assert f"== {app} (unmodified app binary) ==" in lines
    assert sum("offload " in line for line in lines) == 3 * len(offload_library.APPS)


def test_serve_mixed_is_bit_identical_and_batching_cuts_crossings():
    got = serve_mixed.run("cpu", n_layers=2, n_clients=4, requests_per_client=2)
    assert got["bitident"] and got["requests"] == 8
    assert got["crossings_per_request"] < got["unbatched_crossings_per_request"]
    assert got["report"].fallback_requests == 0


def test_train_lm_tiny_lowers_the_loss():
    assert train_lm.main(["--tiny", "--steps", "30", "--device", "cpu"]) == 0


def test_train_lm_resumes_exactly(tmp_path):
    """5 steps, a checkpoint, then a resumed run to 10 equals 10 steps in one
    run (same schedule: ``total_steps`` is 10 in both)."""
    whole = train_lm.run(tiny=True, steps=10, device="cpu",
                         ckpt_dir=str(tmp_path / "whole"))
    train_lm.run(tiny=True, steps=5, device="cpu", ckpt_dir=str(tmp_path / "cut"),
                 ckpt_every=5)
    resumed = train_lm.run(tiny=True, steps=10, device="cpu",
                           ckpt_dir=str(tmp_path / "cut"), resume=True)
    assert [m["step"] for m in resumed["metrics"]] == list(range(6, 11))
    assert resumed["losses"][-1] == whole["losses"][-1]
    flat = lambda t: [x for _, x in sorted(_leaves(t))]
    for a, b in zip(flat(whole["params"]), flat(resumed["params"])):
        assert torch.equal(a, b)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card(monkeypatch, name):
    module = importlib.import_module(f"repro_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        module.main([])


def test_matmul_rows_is_the_product_and_row_invariant():
    """``opset.matmul_rows`` (the ``matmul`` op's body on the card for a 2-D
    right operand): the product to float32 rounding, and each row of a
    batch bitwise equal to the row alone, for a narrow and a wide weight,
    at heights that are no multiple of the block."""
    from repro_torch.core.opset import MATMUL_ROWS, matmul_rows

    g = torch.Generator().manual_seed(0)
    for n, shapes in ((512, ((8, 128, 192), (3, 70, 192), (MATMUL_ROWS + 5, 192))),
                      (16384, ((300, 192), (2, 9, 192)))):
        w = torch.randn(192, n, generator=g)
        for shape in shapes:
            x = torch.randn(*shape, generator=g)
            got = matmul_rows(x, w)
            torch.testing.assert_close(got, x @ w, rtol=1e-5, atol=1e-5)
            for i in (0, shape[0] - 1):
                assert torch.equal(matmul_rows(x[i:i + 1], w)[0], got[i])
        view = torch.randn(300, 200, generator=g)[:, 4:196]   # strided rows: copied
        torch.testing.assert_close(matmul_rows(view, w), view @ w, rtol=1e-5, atol=1e-5)


def test_matmul_rows_exports():
    """The AOT cache exports units holding the ``matmul`` op, so its card
    form must trace under ``torch.export`` (a pointer read or an ``out=``
    call made the cluster's units unexportable)."""
    from repro_torch.core.opset import MATMUL_ROWS, matmul_rows

    class Product(torch.nn.Module):
        def forward(self, x, w):
            return matmul_rows(x, w)

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, MATMUL_ROWS + 3, 16, generator=g)
    w = torch.randn(16, 24, generator=g)
    ep = torch.export.export(Product(), (x, w))
    assert torch.equal(ep.module()(x, w), matmul_rows(x, w))


@pytest.mark.gpu
def test_matmul_op_is_batch_invariant_on_the_card():
    """The fault ``serve_mixed`` found on the card: one cuBLAS call's
    reduction order depends on its height, so a padded batch of requests
    was not bitwise equal to each request alone (up to 8.9e-7 on the
    logits).  The ``matmul`` op now runs weight products in fixed row
    blocks there (1 to 30 blocks here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import opset

    fn = opset.get("matmul").torch_fn
    g = torch.Generator().manual_seed(0)
    for n in (512, 49152):
        w = torch.randn(192, n, generator=g).cuda()
        for B, T in ((8, 128), (8, 1), (5, 96), (40, 96)):
            x = torch.randn(B, T, 192, generator=g).cuda()
            (batched,) = fn({}, x, w)
            for i in range(B):
                assert torch.equal(fn({}, x[i:i + 1], w)[0][0], batched[i])


@pytest.mark.gpu
def test_serve_mixed_is_bit_identical_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = serve_mixed.run(None, n_layers=2, n_clients=4, requests_per_client=2)
    assert got["bitident"]
