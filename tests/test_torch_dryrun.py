"""The port's launch dry run (``python -m repro_torch.launch.dryrun``).

In a subprocess (the dry run joins a fake process group, which a test
process must not), with every kernel's plain version replaced by one that
raises, so a cell that ran no plain version is one the shape-only route
served: SmolLM-360M's ``decode_32k`` on the multi-pod mesh (512 chips),
Qwen2-1.5B's ``long_500k`` (skipped with the reference's reason),
Zamba2-2.7B's ``long_500k`` on the single-pod mesh (the sequence-parallel
decode), Granite MoE's ``train_4k`` under ``--strategy fsdp``, and a cell
whose batch does not split over its mesh, recorded as an error with its
trace and a non-zero exit.  Each record is written to the directory given.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
from repro_torch.kernels import decode_attention, flash_attention, flash_attention_bwd, ops
from repro_torch.kernels import rmsnorm, ssm_scan
from repro_torch.launch import dryrun


def refuse(*args, **kwargs):
    raise AssertionError("a kernel's plain version ran in the dry run")


for module in (ops, decode_attention, flash_attention, flash_attention_bwd, rmsnorm, ssm_scan):
    for name in dir(module):
        if name.endswith("_plain"):
            setattr(module, name, refuse)
out = sys.argv[1]
codes = [dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--mesh", "multi",
                      "--out", out, "--op-hist"]),
         dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k", "--mesh", "single",
                      "--out", out]),
         dryrun.main(["--arch", "zamba2-2.7b", "--shape", "long_500k", "--mesh", "single",
                      "--out", out]),
         dryrun.main(["--arch", "granite-moe-1b-a400m", "--shape", "train_4k", "--mesh",
                      "single", "--strategy", "fsdp", "--out", out, "--tag", "fsdp"]),
         dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--mesh",
                      "data=3,model=1", "--out", out])]
print("CODES", codes)
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(out)], capture_output=True,
                          text=True, timeout=600, env=env, cwd=str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    codes = [line for line in proc.stdout.splitlines() if line.startswith("CODES")]
    records = {p.name: json.loads(p.read_text()) for p in out.glob("*.json")}
    return codes[-1], records, proc.stdout


def test_exit_codes(cells):
    codes, _, _ = cells
    assert codes == "CODES [0, 0, 0, 0, 1]"


def test_decode_cell_on_the_multi_pod_mesh(cells):
    _, records, _ = cells
    r = records["smollm-360m_decode_32k_multi.json"]
    assert r["status"] == "ok" and r["chips"] == 512
    assert r["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    mem = r["memory"]
    assert mem["activation_peak"] > 0 and mem["params"] > 0 and mem["cache"] > 0
    assert mem["total"] == sum(mem[k] for k in ("params", "cache", "batch", "activation_peak"))
    assert mem["fits"] is True and mem["card_bytes"] == 81_559 * 2**20
    assert r["roofline"]["terms"]["dominant"] in ("compute", "memory", "collective")
    assert r["roofline"]["params"] > 0
    coll = r["collectives"]
    assert coll["total_bytes"] == sum(coll["bytes_by_kind"].values()) > 0
    assert set(coll["bytes_by_kind"]) <= {"all_reduce", "all_gather", "all_to_all", "ppermute"}
    # 32 layers: every flash-decode and RMSNorm launch on the shape-only route
    assert r["launches_by_route"] == {"rmsnorm": {"fake": 65}, "decode_attention": {"fake": 32}}
    assert r["counted_flops"]["kernels"]["decode_attention"] > 0
    assert r["counted_flops"]["total"] > r["counted_flops"]["matmul"] > 0
    assert "aten.mm" in r["aten_ops"] or "aten.bmm" in r["aten_ops"]


def test_skipped_cell_carries_the_reference_reason(cells):
    _, records, _ = cells
    r = records["qwen2-1.5b_long_500k_single.json"]
    assert r["status"] == "skipped"
    assert r["reason"] == "full-attention arch: 500k decode needs sub-quadratic mixing"


def test_sequence_parallel_and_fsdp_cells(cells):
    _, records, _ = cells
    r = records["zamba2-2.7b_long_500k_single.json"]
    assert r["status"] == "ok" and r["chips"] == 256
    assert r["launches_by_route"]["decode_attention"] == {"fake": 9}
    assert r["collectives"]["bytes_by_axis"].get("data", 0) > 0     # the partials' fold
    t = records["granite-moe-1b-a400m_train_4k_single_fsdp.json"]
    assert t["status"] == "ok" and t["strategy"] == "fsdp" and t["memory"]["opt_state"] > 0
    routes = t["launches_by_route"]
    for name in ("flash_attention_fwd_stats", "flash_attention_dq", "flash_attention_dkv"):
        assert set(routes[name]) == {"fake"}
    assert t["collectives"]["count_by_kind"]["all_to_all"] > 0       # expert parallelism


def test_error_cell_is_recorded_with_its_trace(cells):
    _, records, stdout = cells
    r = records["smollm-360m_decode_32k_data=3,model=1.json"]
    assert r["status"] == "error" and "ValueError" in r["error"] and "Traceback" in r["trace"]
    assert "done; 1 failures" in stdout
