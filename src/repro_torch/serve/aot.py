"""AOT persistence: a versioned on-disk cache of plan artifacts.

The paper's system translates each guest function once and reuses the
native unit forever; within one process the
:class:`~repro_torch.core.offload.UnitCache` already does that.  This module
extends the idiom across *process boundaries* — the specialize-once/
reuse-forever pattern of learned-rule and fully-static DBT: a warm process
serializes everything a cold worker needs to skip the compile phase, so
cluster workers boot with compile count 0.

What :func:`save_planned` writes (one directory per plan):

``manifest.json``
    Format version, the ``torch``/``numpy`` versions, the CUDA runtime
    version and each unit device (``cuda sm_XX`` or ``cpu``), the **program
    digest**, the scheme's feature flags, the cost-model config, the
    eligibility analysis summary (compilable set — re-derived and
    cross-checked at load), and the unit index: one entry per offload-unit
    cache key (function, per-arg rank/dtype, device) listing the exported
    programs with per-blob sha256 checksums and sizes.
``program.json`` / ``constants.npz``
    The guest program IR and its constants — the digest covers both.
``unit-*.pt2``
    One :func:`torch.export.export` program per concrete signature each
    unit has run at (``OffloadUnit.seen_signatures``), saved with
    :func:`torch.export.save`.  The unit's globals are *inputs* of the
    exported program, never lifted constants, so no blob carries the
    weights.  A kernel the unit reaches is one ``repro_torch::`` operator
    node (:mod:`repro_torch.kernels.library`).

What counts as a compile: an eager unit "compiles" at its first call per
concrete signature (:mod:`repro_torch.core.offload`).  A signature loaded
from the cache is placed in the unit's ``seen_signatures`` and runs the
loaded graph, so it is not a compile; a signature not in the cache compiles
as always.

Trust boundary (the never-loaded-blind rule): a missing/corrupt manifest or
a program-digest mismatch raises :class:`AotError` — the caller falls back
to planning from source.  A ``torch``/``numpy`` or CUDA version mismatch, a
unit device that is absent here or of another architecture, an
analysis-summary skew, a checksum failure, or an unloadable blob degrades
to a warning and a recompile of exactly the affected scope; wrong artifacts
are never executed.

Units whose body crosses back into the guest (host callbacks from
non-inlinable callees) cannot be exported — ``torch.export`` cannot trace
the gather to host memory — so :func:`save_planned` skips them with a
warning and they recompile on load.  Decode-LM style programs keep their
host-only checks in PFO residuals (interpreted on the guest side), so their
offloaded units export cleanly.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import threading
from pathlib import Path

import numpy as np
import torch

from .. import obs
from ..core.api import PlannedProgram, trace
from ..core.costmodel import CostModel, CostModelConfig
from ..core.offload import Scheme, UnitCache, _tensor_sig
from ..core.program import Function, Op, Program

AOT_FORMAT = 1
MANIFEST = "manifest.json"
PROGRAM_FILE = "program.json"
CONSTANTS_FILE = "constants.npz"


class AotError(RuntimeError):
    """The artifact cannot be trusted as a whole (missing/corrupt manifest,
    program-digest mismatch).  Callers fall back to planning from source."""


# ---------------------------------------------------------------------------
# program IR serialization (tuple-preserving JSON)
# ---------------------------------------------------------------------------


def _enc(v):
    """JSON-encode an op-param value, preserving tuple-ness exactly.

    Op params hold ints, floats, bools, strings and (nested) tuples — e.g.
    ``perm=(0, 2, 1, 3)`` or ``axis=(1,)`` — and several op bodies require
    tuples back, so a plain JSON list round-trip would corrupt them."""
    if isinstance(v, tuple):
        return {"__t__": [_enc(x) for x in v]}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, list):
        return [_enc(x) for x in v]
    raise AotError(f"op param of unsupported type {type(v).__name__}: {v!r}")


def _dec(v):
    if isinstance(v, dict):
        if set(v) != {"__t__"}:
            raise AotError(f"unexpected param encoding: {v!r}")
        return tuple(_dec(x) for x in v["__t__"])
    if isinstance(v, list):
        return [_dec(x) for x in v]
    return v


def program_to_dict(program: Program) -> dict:
    """Canonical JSON-able form of the IR (constants serialized separately)."""
    return {
        "name": program.name,
        "entry": program.entry,
        "functions": {
            fname: {
                "args": list(fn.args),
                "returns": list(fn.returns),
                "globals": list(fn.globals),
                "ops": [
                    {
                        "kind": op.kind,
                        "inputs": list(op.inputs),
                        "outputs": list(op.outputs),
                        "params": {k: _enc(v) for k, v in sorted(op.params.items())},
                    }
                    for op in fn.ops
                ],
            }
            for fname, fn in sorted(program.functions.items())
        },
    }


def program_from_dict(d: dict, constants: dict[str, np.ndarray]) -> Program:
    functions = {
        fname: Function(
            name=fname,
            args=tuple(f["args"]),
            returns=tuple(f["returns"]),
            ops=tuple(
                Op(
                    kind=o["kind"],
                    inputs=tuple(o["inputs"]),
                    outputs=tuple(o["outputs"]),
                    params={k: _dec(v) for k, v in o["params"].items()},
                )
                for o in f["ops"]
            ),
            globals=tuple(f["globals"]),
        )
        for fname, f in d["functions"].items()
    }
    return Program(d["name"], functions, d["entry"], dict(constants))


def program_digest(program: Program) -> str:
    """sha256 over the canonical IR and every constant's dtype/shape/bytes."""
    h = hashlib.sha256()
    h.update(json.dumps(program_to_dict(program), sort_keys=True,
                        separators=(",", ":")).encode())
    for name in sorted(program.constants):
        c = np.ascontiguousarray(program.constants[name])
        h.update(name.encode())
        h.update(str(c.dtype).encode())
        h.update(repr(c.shape).encode())
        h.update(c.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# unit keys and signatures (disk form <-> runtime form)
# ---------------------------------------------------------------------------


def _key_to_json(key: tuple) -> list:
    fname, rankdtypes, backend = key
    return [fname, [[int(r), str(d)] for r, d in rankdtypes], backend]


def _key_from_json(j) -> tuple:
    fname, rankdtypes, backend = j
    return (fname, tuple((int(r), str(d)) for r, d in rankdtypes), backend)


def _sig_to_json(sig: tuple) -> dict:
    gsig, asig = sig
    return {
        "globals": [[list(shape), dtype] for shape, dtype in gsig],
        "args": [[list(shape), dtype] for shape, dtype in asig],
    }


def _sig_from_json(j: dict) -> tuple:
    return (
        tuple((tuple(int(d) for d in shape), dtype) for shape, dtype in j["globals"]),
        tuple((tuple(int(d) for d in shape), dtype) for shape, dtype in j["args"]),
    )


def _torch_dtype(name: str) -> torch.dtype:
    """``"torch.float32"`` (a signature's dtype string) -> ``torch.float32``."""
    dtype = getattr(torch, name.removeprefix("torch."), None)
    if not isinstance(dtype, torch.dtype):
        raise AotError(f"unknown dtype {name!r} in a unit signature")
    return dtype


def _device_label(backend: str | None) -> str | None:
    """What an exported unit was built for: ``"cuda sm_XX"`` or ``"cpu"``
    (``None`` when ``backend`` names a device this host does not have)."""
    device = torch.device(backend or "cpu")
    if device.type != "cuda":
        return device.type
    if not torch.cuda.is_available() or (device.index or 0) >= torch.cuda.device_count():
        return None
    major, minor = torch.cuda.get_device_capability(device)
    return f"cuda sm_{major}{minor}"


class _UnitProgram(torch.nn.Module):
    """An offload unit's body as a module of plain tensor inputs — globals
    first, then arguments — for :func:`torch.export.export`."""

    def __init__(self, body, n_globals: int):
        super().__init__()
        self._body = body
        self._n_globals = n_globals

    def forward(self, *tensors):
        g, a = tensors[:self._n_globals], tensors[self._n_globals:]
        return tuple(self._body(g, a, np.int32(0)))


def _export_unit(unit, sig: tuple, backend: str | None) -> bytes:
    """``torch.export`` one unit at one concrete signature; the saved bytes."""
    gsig, asig = sig
    device = torch.device(backend or "cpu")
    example = tuple(torch.zeros(shape, dtype=_torch_dtype(dt), device=device)
                    for shape, dt in (*gsig, *asig))
    ep = torch.export.export(_UnitProgram(unit.body, len(gsig)), example, strict=False)
    if getattr(ep, "example_inputs", None) is not None:
        ep.example_inputs = None     # they would carry the globals into the blob
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the AOT-aware unit cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Artifact:
    blob: bytes                 # serialized form (re-saved verbatim)
    exported: "torch.export.ExportedProgram"


class _AotUnitCache(UnitCache):
    """A :class:`UnitCache` whose units run loaded programs where it can.

    When a unit is built for a key with loaded artifacts, each loaded
    signature is placed in the unit's ``seen_signatures`` (so it is no
    compile) and its ``call`` is replaced by a dispatcher: calls whose
    concrete signature was exported run the loaded program, anything else
    falls through to the eager body and compiles as always.
    """

    def __init__(self, artifacts: dict[tuple, dict[tuple, _Artifact]] | None = None):
        super().__init__()
        self.artifacts: dict[tuple, dict[tuple, _Artifact]] = dict(artifacts or {})
        self.aot_dispatches = 0     # calls served by a loaded program
        self._dispatch_lock = threading.Lock()

    def get_or_build(self, key, factory):
        def build():
            unit = factory()
            arts = self.artifacts.get(key)
            if arts:
                unit.seen_signatures.update(arts)
                unit.call = self._dispatcher(unit.call, arts)
            return unit
        return super().get_or_build(key, build)

    def _dispatcher(self, real_call, arts: dict[tuple, _Artifact]):
        modules: dict[tuple, torch.nn.Module] = {}

        def dispatch(globals_tuple, args_tuple, token):
            sig = (_tensor_sig(globals_tuple), _tensor_sig(args_tuple))
            art = arts.get(sig)
            if art is None:
                return real_call(globals_tuple, args_tuple, token)
            fn = modules.get(sig)
            if fn is None:
                fn = modules.setdefault(sig, art.exported.module())
            with self._dispatch_lock:
                self.aot_dispatches += 1
            return tuple(fn(*globals_tuple, *args_tuple))

        return dispatch


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------


@obs.traced("aot_save", obs.AOT)
def save_planned(planned: PlannedProgram, path) -> dict:
    """Write ``planned``'s artifacts to ``path`` (see module docstring).

    The manifest is written last, so a crashed save leaves no loadable
    artifact (loads require the manifest and verify the program digest).
    Returns a summary: exported/skipped unit counts, signature totals and
    the bytes of the exported programs.
    """
    if planned.unit_filter is not None:
        raise AotError("cannot save a plan with a unit_filter (not serializable); "
                       "save the unfiltered plan or re-plan at load time")
    if planned.mesh is not None or planned.arg_specs is not None:
        raise AotError("cannot save a plan with mesh/arg_specs (device topology "
                       "is a property of the loading host, not the artifact)")

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    program = planned.traced.program

    prog_dict = program_to_dict(program)
    (path / PROGRAM_FILE).write_text(json.dumps(prog_dict, sort_keys=True, indent=1))
    np.savez(path / CONSTANTS_FILE, **program.constants)

    prior: dict[tuple, dict[tuple, _Artifact]] = (
        planned.unit_cache.artifacts
        if isinstance(planned.unit_cache, _AotUnitCache) else {}
    )

    unit_index = []
    devices: dict[str, str] = {}
    exported_units = skipped = n_sigs = n_bytes = 0
    for key, unit in sorted(planned.unit_cache.items(), key=lambda kv: repr(kv[0])):
        backend = key[2]
        # start from artifacts this process itself loaded (carried verbatim)
        blobs: dict[tuple, bytes] = {
            sig: art.blob for sig, art in prior.get(key, {}).items()
        }
        try:
            for sig in sorted(unit.seen_signatures, key=repr):
                if sig in blobs:
                    continue
                blobs[sig] = _export_unit(unit, sig, backend)
        except Exception as e:  # noqa: BLE001 — host callbacks (guest reentry)
            # are not exportable; the unit just recompiles on load
            obs.warn(
                f"AOT: unit {unit.fname!r} not exportable "
                f"({type(e).__name__}: {e}); it will recompile on load")
            skipped += 1
            continue
        if not blobs:
            continue        # never called, nothing to persist
        devices[str(backend)] = _device_label(backend)
        sigs_json = []
        for j, (sig, blob) in enumerate(sorted(blobs.items(), key=lambda kv: repr(kv[0]))):
            fname = f"unit-{len(unit_index):03d}-sig-{j:03d}.pt2"
            (path / fname).write_bytes(blob)
            entry = _sig_to_json(sig)
            entry["file"] = fname
            entry["sha256"] = hashlib.sha256(blob).hexdigest()
            entry["bytes"] = len(blob)
            sigs_json.append(entry)
            n_sigs += 1
            n_bytes += len(blob)
        unit_index.append({"key": _key_to_json(key), "signatures": sigs_json})
        exported_units += 1

    manifest = {
        "format": AOT_FORMAT,
        "torch": torch.__version__,
        "numpy": np.__version__,
        "cuda": torch.version.cuda,
        "device": devices,
        "program_digest": program_digest(program),
        "program_file": PROGRAM_FILE,
        "constants_file": CONSTANTS_FILE,
        "entry": program.entry,
        "scheme": dataclasses.asdict(planned.scheme),
        "compute_dtype": planned.compute_dtype,
        "costmodel": dataclasses.asdict(planned.costmodel.config),
        "analysis": {"compilable": sorted(planned.analysis.compilable)},
        "units": unit_index,
    }
    (path / MANIFEST).write_text(json.dumps(manifest, sort_keys=True, indent=1))
    return {
        "path": str(path),
        "units": len(planned.unit_cache),
        "exported_units": exported_units,
        "skipped_units": skipped,
        "signatures": n_sigs,
        "bytes": n_bytes,
    }


def _load_manifest(path: Path) -> dict:
    try:
        manifest = json.loads((path / MANIFEST).read_text())
    except (OSError, ValueError) as e:
        raise AotError(f"no loadable AOT artifact at {path}: {e}") from e
    if manifest.get("format") != AOT_FORMAT:
        raise AotError(
            f"AOT artifact at {path} has format {manifest.get('format')!r}; "
            f"this build reads format {AOT_FORMAT}")
    return manifest


def _usable_backends(path: Path, manifest: dict) -> set[str]:
    """The unit devices whose exported programs may run in this process."""
    if manifest["torch"] != torch.__version__ or manifest["numpy"] != np.__version__:
        obs.warn(
            f"AOT artifact at {path} was saved under torch {manifest['torch']}/"
            f"numpy {manifest['numpy']} but this process runs torch "
            f"{torch.__version__}/numpy {np.__version__}; ignoring exported "
            f"programs (everything recompiles)")
        return set()
    if manifest["cuda"] != torch.version.cuda:
        obs.warn(
            f"AOT artifact at {path} was saved under CUDA {manifest['cuda']} "
            f"but this process runs CUDA {torch.version.cuda}; ignoring "
            f"exported programs (everything recompiles)")
        return set()
    usable = set()
    for backend, label in manifest["device"].items():
        here = _device_label(backend)
        if here != label:
            obs.warn(
                f"AOT artifact at {path} was exported for {backend!r} = "
                f"{label!r} but this process has {here or 'no such device'!r}; "
                f"ignoring exported programs for {backend!r}")
            continue
        usable.add(backend)
    return usable


@obs.traced("aot_load", obs.AOT)
def load_planned(path) -> PlannedProgram:
    """Reconstruct a :class:`PlannedProgram` saved by :func:`save_planned`.

    See the module docstring for the trust boundary: whole-artifact damage
    raises :class:`AotError`, recoverable skew warns and recompiles exactly
    the affected scope.
    """
    from ..kernels import library  # noqa: F401 — registers the repro_torch:: ops

    path = Path(path)
    manifest = _load_manifest(path)

    try:
        prog_dict = json.loads((path / manifest["program_file"]).read_text())
        with np.load(path / manifest["constants_file"], allow_pickle=False) as z:
            constants = {k: np.array(z[k]) for k in z.files}
        program = program_from_dict(prog_dict, constants)
    except AotError:
        raise
    except Exception as e:  # noqa: BLE001 — any IR damage means: do not trust
        raise AotError(f"corrupt AOT program at {path}: "
                       f"{type(e).__name__}: {e}") from e
    digest = program_digest(program)
    if digest != manifest["program_digest"]:
        raise AotError(
            f"AOT program digest mismatch at {path}: manifest says "
            f"{manifest['program_digest'][:12]}…, contents hash to "
            f"{digest[:12]}… — refusing to load a tampered artifact")

    usable = _usable_backends(path, manifest)
    artifacts: dict[tuple, dict[tuple, _Artifact]] = {}
    for u in manifest["units"]:
        key = _key_from_json(u["key"])
        if str(key[2]) not in usable:
            continue
        for s in u["signatures"]:
            try:
                blob = (path / s["file"]).read_bytes()
                if hashlib.sha256(blob).hexdigest() != s["sha256"]:
                    raise ValueError("checksum mismatch")
                exported = torch.export.load(io.BytesIO(blob))
            except Exception as e:  # noqa: BLE001 — skip just this blob
                obs.warn(
                    f"AOT: skipping corrupt executable {s['file']} for "
                    f"unit {key[0]!r} ({type(e).__name__}: {e}); this "
                    f"signature recompiles")
                continue
            artifacts.setdefault(key, {})[_sig_from_json(s)] = _Artifact(
                blob=blob, exported=exported)

    cache = _AotUnitCache(artifacts)
    planned = trace(program).plan(
        Scheme(**manifest["scheme"]),
        costmodel=CostModel(CostModelConfig(**manifest["costmodel"])),
        compute_dtype=manifest["compute_dtype"],
        unit_cache=cache,
    )
    # the eligibility analysis is re-derived from the IR; the manifest's
    # summary cross-checks that this build's planner still agrees with the
    # saving build's — skew means the programs may not match the plan
    if sorted(planned.analysis.compilable) != manifest["analysis"]["compilable"]:
        obs.warn(
            f"AOT artifact at {path}: eligibility analysis changed since "
            f"save (planner skew); ignoring exported programs")
        cache.artifacts.clear()
    return planned
