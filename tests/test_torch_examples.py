"""The port's examples run to their end on the CPU (their own asserts check
the results: no lost commit, pruning fired, a chain kept on its workers, a
lost result rebuilt, two tenants served, pods trained through a failure,
a straggler and a resize): the Future-API ones, the cluster's dataflow,
payload-cache, lineage and fault twins, the serving tier's, and the
qwen2-moe smoke Server."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name,expect", [
    ("quickstart_torch.py", "cuda_async future_map of 4 slices sums to "
                            "the whole: True"),
    ("param_server_torch.py", "commits=48"),
    ("async_hyperband_torch.py", "epochs spent:"),
    ("serve_torch.py --arch qwen2-moe-a2.7b", "all requests served"),
    ("dataflow_chain_torch.py", "fewer bytes through the driver"),
    ("payload_cache_torch.py", "(reused=True)"),
    ("lineage_recovery_torch.py", "OK: lost results rebuilt "
                                  "digest-identical; replicas make "
                                  "recovery free"),
    ("multi_tenant_serving_torch.py --tls", "server: per-tenant attribution"),
    ("cluster_faults_torch.py", "OK: converged through failure, straggler, "
                                "and resize"),
])
def test_example_runs_on_cpu(name, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    script, *args = name.split()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *args, "--device",
         "cpu"],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert expect in proc.stdout
