"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run without a GPU unless asked for the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch
from _torch_parity import _reset_port  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_module_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(_port_modules()) >= 20
    assert {"repro_torch.models.rglru", "repro_torch.configs.recurrentgemma_9b",
            "repro_torch.kernels.rglru_scan",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.decode_attention",
            "repro_torch.kernels.autograd", "repro_torch.optim.adamw",
            "repro_torch.train.state", "repro_torch.train.trainer",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
            "repro_torch.tree", "repro_torch.core.mapreduce",
            "repro_torch.core.stream", "repro_torch.core.state",
            "repro_torch.core.backends.asyncio_loop",
            "repro_torch.core.backends.cuda_async",
            "repro_torch.configs.yi_9b", "repro_torch.configs.yi_34b",
            "repro_torch.configs.nemotron_4_340b",
            "repro_torch.configs.qwen2_vl_72b", "repro_torch.models.moe",
            "repro_torch.configs.qwen2_moe_a2_7b",
            "repro_torch.configs.deepseek_moe_16b",
            "repro_torch.models.mla",
            "repro_torch.configs.minicpm3_4b",
            "repro_torch.configs.hubert_xlarge",
            "repro_torch.core.backends.processes",
            "repro_torch.core.backends.worker",
            "repro_torch.core.backends.blobstore",
            "repro_torch.core.backends.transport",
            "repro_torch.core.backends.cluster",
            "repro_torch.core.backends.cluster_worker",
            "repro_torch.core.backends.launchers",
            "repro_torch.core.serving",
            "repro_torch.core.serving.__main__",
            "repro_torch.optim.compression",
            "repro_torch.launch",
            "repro_torch.launch.train",
            "repro_torch.launch.mesh",
            "repro_torch.launch.specs",
            "repro_torch.launch.op_analysis",
            "repro_torch.launch.dryrun",
            "repro_torch.launch.dtensor_rules",
            "repro_torch.models.sharding",
            "repro_torch.train.pipeline",
            "repro_torch.collectives"} <= set(_port_modules())


def test_dryrun_help_leaves_jax_out():
    """``python -m repro_torch.launch.dryrun --help`` runs and imports no
    JAX module and nothing of the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--help"], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "--arch" in proc.stdout, proc.stderr
    code = ("import runpy, sys\n"
            "sys.argv = ['dryrun', '--help']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.launch.dryrun',\n"
            "                     run_name='__main__')\n"
            "except SystemExit as exc:\n"
            "    assert exc.code == 0\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT_REPRO = re.compile(r"^\s*(import\s+repro\b(?!_torch)|"
                           r"from\s+repro(\.|\s+import)|import\s+jax\b|"
                           r"from\s+jax\b)", re.M)


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")]
    + [ROOT / "chip_smoke.py", ROOT / "examples" / "serve_torch.py",
       ROOT / "examples" / "train_lm_torch.py",
       ROOT / "examples" / "quickstart_torch.py",
       ROOT / "examples" / "param_server_torch.py",
       ROOT / "examples" / "async_hyperband_torch.py",
       ROOT / "examples" / "dataflow_chain_torch.py",
       ROOT / "examples" / "payload_cache_torch.py",
       ROOT / "examples" / "lineage_recovery_torch.py",
       ROOT / "examples" / "multi_tenant_serving_torch.py",
       ROOT / "examples" / "cluster_faults_torch.py",
       ROOT / "tests" / "_torch_cluster_harness.py",
       ROOT / "tests" / "_torch_dist_harness.py",
       ROOT / "scripts" / "train_divergence.py",
       ROOT / "scripts" / "profile_torch.py",
       ROOT / "scripts" / "flash_builds.py",
       ROOT / "scripts" / "flash_phases.py",
       ROOT / "scripts" / "flash_knobs.py",
       ROOT / "scripts" / "pipe_bench.py",
       ROOT / "scripts" / "ship_costs.py",
       ROOT / "scripts" / "multidevice_phase.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_repro_or_jax(path):
    assert not _IMPORT_REPRO.findall(path.read_text())


def test_kernel_sources_are_present():
    assert sorted(p.name for p in (PORT / "kernels" / "csrc").glob("*.cu")) \
        == ["decode_attention.cu", "flash_attention.cu", "mlstm_scan.cu",
            "rglru_scan.cu", "slstm_scan.cu"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    import repro_torch.core as rc
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_jax
    from repro_torch.device import resolve_device
    from repro_torch.models import Model
    from repro_torch.convert import train_state_from_jax
    from repro_torch.data import Prefetcher
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.launch.train import pod_round
    from repro_torch.serve import Server
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_arch("xlstm-125m", smoke=True)
    model = Model(cfg)
    for call in (lambda: Server(),
                 lambda: model.init(torch.Generator()),
                 lambda: model.init_cache(2),
                 lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: params_from_jax({}, cfg),
                 lambda: train_state_from_jax(None, cfg),
                 lambda: Trainer(cfg, TrainerConfig()),
                 lambda: Prefetcher(cfg, batch=1, seq=8),
                 lambda: pod_round("xlstm-125m", True, [], 0, 0, 1, 1, 1,
                                   16, 1e-3, 0),
                 lambda: rc.plan("cuda_async"),
                 lambda: make_production_mesh(),
                 lambda: make_host_mesh()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_entry_points_run_on_cpu_when_asked(no_cuda):
    from repro_torch.serve import Server

    server = Server(device="cpu")
    cache = server.model.init_cache(1, device="cpu")
    tok, _ = server.step(server.params, cache, torch.zeros(1, 1,
                                                           dtype=torch.long))
    assert tok.shape == (1, 1) and server.params["embed"]["table"].is_cpu


def test_tf32_is_off():
    import repro_torch.device  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the smoke script exits non-zero and prints no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          env=env, capture_output=True, text=True,
                          timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
