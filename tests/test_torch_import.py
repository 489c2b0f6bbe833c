"""The port stands alone: it imports neither JAX nor the JAX package.

``repro_torch`` must import with ``jax`` made unimportable, and no module of
``src/repro_torch/`` (nor ``chip_smoke.py``) may name ``jax``, ``repro`` or
the reference's ``benchmarks`` package in an import statement —
framework-free reference modules are copied into the port, never imported
from the reference.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_modules():
    assert len(PORT_FILES) > 20


# modules copied or ported from framework-free reference modules, and the
# training path's: each must be among the files checked below
TRAINING_MODULES = ["data/pipeline.py", "optim/__init__.py", "optim/adamw.py",
                    "optim/clip.py", "optim/schedule.py", "optim/tree.py",
                    "checkpoint/checkpoint.py", "launch/train.py", "launch/steps.py",
                    "kernels/flash_attention_bwd.py"]


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_are_checked(module):
    assert PORT / module in PORT_FILES


# the model families ported last (moe, encdec, vlm, ssm) and what they share
ZOO_MODULES = ["models/moe.py", "models/encdec.py", "models/vlm.py", "models/xlstm.py",
               "models/dense.py", "models/layers.py", "models/api.py"]


@pytest.mark.parametrize("module", ZOO_MODULES)
def test_zoo_modules_are_checked(module):
    assert PORT / module in PORT_FILES


# sharded training: the mesh and collectives, the layout rules, the pipeline,
# fault tolerance and the production mesh
PARALLEL_MODULES = ["parallel/__init__.py", "parallel/spmd.py", "parallel/sharding.py",
                    "parallel/pipeline.py", "parallel/units.py", "runtime/__init__.py",
                    "runtime/fault_tolerance.py", "launch/mesh.py"]


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_modules_are_checked(module):
    assert PORT / module in PORT_FILES


# the smoke gates and the examples (ports of benchmarks/smoke*.py and examples/)
ENTRY_MODULES = ["bench/common.py", "bench/smoke.py", "bench/smoke_serve.py",
                 "bench/smoke_decode.py", "bench/smoke_cluster.py", "bench/smoke_trace.py",
                 "examples/__init__.py", "examples/quickstart.py",
                 "examples/decode_stream.py", "examples/offload_library.py",
                 "examples/serve_mixed.py", "examples/train_lm.py"]


@pytest.mark.parametrize("module", ENTRY_MODULES)
def test_entry_point_modules_are_checked(module):
    assert PORT / module in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_import_with_jax_blocked():
    """Every module of the port imports in a process where ``import jax``
    (and ``import repro``) fails."""
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro', 'benchmarks'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items()"
        " if v is not None)\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device the chip smoke exits non-zero and prints no
    result line — on this host, and from a directory holding only it."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
