"""The CUDA kernels against their plain versions on the card. Needs a
CUDA device and nvcc, not JAX; skips without a card. On the GPU host (whose
Python has no JAX for tests/conftest.py to import):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
from _torch_parity import (MLSTM_TOL, SLSTM_TOL, _reset_port,  # noqa: F401
                           cuda_device, mlstm_inputs, n, slstm_inputs, t)

from repro_torch.kernels import mlstm_scan as MK
from repro_torch.kernels import ops
from repro_torch.kernels import slstm_scan as SK


# --------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# --------------------------------------------------------------------------

@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,h,s,d", [(2, 2, 256, 64), (1, 4, 512, 384)])
def test_mlstm_kernel_matches_plain_on_card(cuda_device, b, h, s, d):
    args = [t(a, cuda_device) for a in mlstm_inputs(3, b, h, s, d)]
    before = MK.launches
    got = ops.mlstm_scan(*args)
    torch.cuda.synchronize()
    assert MK.launches == before + 1
    want = MK.plain(*args, cs=256)
    np.testing.assert_allclose(n(got), n(want), **MLSTM_TOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,nh,s,hd", [(2, 2, 128, 64), (2, 4, 256, 192)])
def test_slstm_kernel_matches_plain_on_card(cuda_device, b, nh, s, hd):
    args = [t(a, cuda_device) for a in slstm_inputs(3, b, nh, s, hd)]
    before = SK.launches
    got = ops.slstm_scan(*args)
    torch.cuda.synchronize()
    assert SK.launches == before + 1
    np.testing.assert_allclose(n(got), n(SK.plain(*args)), **SLSTM_TOL)


@pytest.mark.requires_cuda
def test_mlstm_kernel_rejects_unsupported_head_dim(cuda_device):
    args = [t(a, cuda_device) for a in mlstm_inputs(0, 1, 1, 64, 32)]
    with pytest.raises(ValueError, match="multiple of 64"):
        ops.mlstm_scan(*args)


# --------------------------------------------------------------------------
# the build, on any host
# --------------------------------------------------------------------------

def test_build_targets_are_hashed_per_source():
    from repro_torch.kernels import _build
    assert _build.sources() == ["mlstm_scan", "slstm_scan"]
    for name in _build.sources():
        target = _build._target(name)
        assert target.parent == _build.BUILD_DIR
        assert target.name.startswith(f"{name}-") and target.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; nothing falls back."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("mlstm_scan")
