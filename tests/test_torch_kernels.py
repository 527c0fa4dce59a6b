"""The port's kernels: plain versions against the JAX Pallas kernels
(interpret mode) and their jnp oracles on the CPU. The CUDA kernels are
held against their plain versions in test_torch_cuda.py."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _torch_parity import (MLSTM_TOL, SLSTM_TOL, _reset_port,  # noqa: E402,F401
                           mlstm_inputs, n, slstm_inputs, t)

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mlstm_scan import mlstm_scan as jax_mlstm_scan  # noqa: E402
from repro.kernels.slstm_scan import slstm_scan as jax_slstm_scan  # noqa: E402
from repro_torch.kernels import mlstm_scan as MK  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import slstm_scan as SK  # noqa: E402


MLSTM_CASES = [(1, 1, 128, 32, 32), (2, 2, 128, 64, 64),
               (1, 2, 256, 32, 128), (2, 1, 256, 64, 64)]


@pytest.mark.parametrize("b,h,s,d,cs", MLSTM_CASES)
def test_mlstm_plain_matches_jax_kernel(b, h, s, d, cs):
    args = mlstm_inputs(b * 100 + s + d, b, h, s, d)
    got = ops.mlstm_scan(*(t(a) for a in args), cs=cs)
    want = jax_mlstm_scan(*(jnp.asarray(a) for a in args), cs=cs,
                          interpret=True)
    np.testing.assert_allclose(n(got), n(want), **MLSTM_TOL)


@pytest.mark.parametrize("b,h,s,d,cs", MLSTM_CASES)
def test_mlstm_plain_matches_jax_sequential_oracle(b, h, s, d, cs):
    args = mlstm_inputs(b * 100 + s + d + 1, b, h, s, d)
    got = ops.mlstm_scan(*(t(a) for a in args), cs=cs)
    want, _ = jref.mlstm_chunk_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(n(got), n(want), **MLSTM_TOL)


def test_mlstm_sequential_oracle_matches_jax_with_state():
    args = mlstm_inputs(7, 2, 2, 64, 32)
    got, gstate = ref.mlstm_chunk_ref(*(t(a) for a in args))
    want, wstate = jref.mlstm_chunk_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(n(got), n(want), rtol=2e-5, atol=2e-5)
    for key in ("C", "n", "m"):
        np.testing.assert_allclose(n(gstate[key]), n(wstate[key]),
                                   rtol=2e-5, atol=2e-5)


SLSTM_CASES = [(1, 1, 64, 32, 32), (2, 2, 64, 64, 64), (1, 2, 128, 32, 64)]


@pytest.mark.parametrize("b,nh,s,hd,cs", SLSTM_CASES)
def test_slstm_plain_matches_jax_kernel(b, nh, s, hd, cs):
    args = slstm_inputs(b * 10 + s + hd, b, nh, s, hd)
    got = ops.slstm_scan(*(t(a) for a in args))
    want = jax_slstm_scan(*(jnp.asarray(a) for a in args), cs=cs,
                          interpret=True)
    np.testing.assert_allclose(n(got), n(want), **SLSTM_TOL)


@pytest.mark.parametrize("b,nh,s,hd,cs", SLSTM_CASES)
def test_slstm_plain_matches_jax_oracle(b, nh, s, hd, cs):
    args = slstm_inputs(b * 10 + s + hd + 1, b, nh, s, hd)
    got = ops.slstm_scan(*(t(a) for a in args))
    want = jref.slstm_scan_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(n(got), n(want), **SLSTM_TOL)


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    before = (MK.launches, SK.launches)
    ops.mlstm_scan(*(t(a) for a in mlstm_inputs(0, 1, 1, 64, 64)), cs=32)
    ops.slstm_scan(*(t(a) for a in slstm_inputs(0, 1, 1, 8, 32)))
    assert (MK.launches, SK.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run the plain version themselves: a CPU
    tensor is an error there (the dispatch in ops picks the plain one)."""
    with pytest.raises(ValueError, match="CUDA"):
        MK.mlstm_scan(*(t(a) for a in mlstm_inputs(0, 1, 1, 64, 64)))
    with pytest.raises(ValueError, match="CUDA"):
        SK.slstm_scan(*(t(a) for a in slstm_inputs(0, 1, 1, 8, 32)))


def test_unknown_kernel_impl_raises():
    with pytest.raises(ValueError, match="kernel_impl"):
        ops.mlstm_scan(*(t(a) for a in mlstm_inputs(0, 1, 1, 64, 64)),
                       kernel_impl="pallas")
