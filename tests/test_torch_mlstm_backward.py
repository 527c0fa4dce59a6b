"""The mLSTM backward on the CPU: the plain backward
``mlstm_chunkwise_bwd_ref`` against autograd and ``jax.vjp``, and the
plumbing of the wrapper's ``autograd.Function`` with the plain versions
standing in for the kernels (the CUDA kernels themselves run in
``test_torch_cuda.py`` on the card).

Tolerances. In fp64 the plain backward equals autograd through the plain
forward to 1e-12 of each gradient's largest value (measured: below 2.5e-15
at these shapes and chunk sizes; the two take the same steps in other
groupings, and the function does not depend on the chunk size). In fp32
each gradient's error against the fp64 plain backward, over its largest
value, is held within ``JAX_YARDSTICKS`` times JAX's own fp32 error against
the same (at least one fp32 ulp), and the port's distance from JAX within
the same multiple. Measured at these shapes, the port's error was 0.3 to
4.8 times JAX's and its distance from JAX 0.4 to 5.2 times, against
``repro.models.xlstm.mlstm_chunkwise`` and the sequential oracle
``repro.kernels.ref.mlstm_chunk_ref`` alike. A fixed bound cannot serve:
with the input gates shifted by +6 both fp32 backwards sit at 2e-4 to
1.8e-3 of fp64 (a long product of large gates, near cancellation), with no
shift or -6 at 1e-7 to 4e-6.
"""

import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_parity import (_reset_port, jax_params,  # noqa: E402,F401
                           mlstm_b_i_scales, n, t, torch_params)

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import synth_batch  # noqa: E402
from repro_torch.kernels import mlstm_scan as MK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.train import kernel_launches  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.tree import map_with_path  # noqa: E402

FP64_TOL = 1e-12
JAX_YARDSTICKS = 8.0
NAMES = ("q", "k", "v", "i", "f")

#: (b, h, s, d, cs): head dims 64 and 128, chunks of 16 (the kernel's) and
#: 64, up to 8 chunks
CASES = [(1, 1, 64, 64, 16), (2, 2, 128, 64, 64), (1, 2, 128, 128, 16),
         (2, 1, 64, 128, 64)]
#: input-gate shifts: none; -6, where |n_t| stays below exp(-m_row); +6
SHIFTS = (0.0, -6.0, 6.0)


def _inputs(b, h, s, d, shift):
    rng = np.random.default_rng(b * 10 + s + d)

    def draw(*shape, shift=0.0):
        return (rng.standard_normal(shape) + shift).astype(np.float32)

    args = [draw(b, h, s, d), draw(b, h, s, d), draw(b, h, s, d),
            draw(b, h, s, shift=shift), draw(b, h, s, shift=2.0)]
    return args, draw(b, h, s, d)


def _plain_bwd(args, grad_h, dtype, cs):
    a = [t(x).to(dtype) for x in args]
    h, states = ref.mlstm_chunkwise_fwd_states_ref(*a, cs=cs)
    return ref.mlstm_chunkwise_bwd_ref(*a, h, states, t(grad_h).to(dtype),
                                       cs=cs)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-300)


def _autograd_fp64(args, grad_h, cs):
    wide = [t(a).double().requires_grad_(True) for a in args]
    return torch.autograd.grad(ref.mlstm_chunkwise(*wide, cs=cs), wide,
                               t(grad_h).double())


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("b,h,s,d,cs", CASES)
def test_plain_backward_is_autograd_in_fp64(b, h, s, d, cs, shift):
    """At the chunk size of the forward it follows, and at the kernel's 16:
    the backward does not depend on the chunk size either."""
    args, grad_h = _inputs(b, h, s, d, shift)
    want = _autograd_fp64(args, grad_h, cs)
    for chunk in sorted({cs, 16}):
        got = _plain_bwd(args, grad_h, torch.float64, chunk)
        assert len(got) == 5
        for name, g, w in zip(NAMES, got, want):
            assert g.shape == w.shape and g.dtype == torch.float64
            assert _rel(n(g), n(w)) <= FP64_TOL, (name, chunk)


@pytest.mark.parametrize("b,h,s,d,cs", CASES)
def test_inputs_take_both_sides_of_the_denominator(b, h, s, d, cs):
    """Over the three gate shifts, |n_t| lies above exp(-m_row) somewhere
    and below it somewhere, and n_t takes both signs, so both routings of
    the normaliser's grad and both signs of d|n_t| are exercised."""
    above = below = pos = neg = False
    for shift in SHIFTS:
        args, _ = _inputs(b, h, s, d, shift)
        _, (_, _, _, m_row, n_row) = ref.mlstm_chunkwise_fwd_states_ref(
            *(t(a).double() for a in args), cs=cs)
        em = torch.exp(-m_row)
        above |= bool((n_row.abs() > em).any())
        below |= bool((n_row.abs() < em).any())
        pos |= bool((n_row > 0).any())
        neg |= bool((n_row < 0).any())
    assert above and below and pos and neg


def _tie_inputs():
    """Row 0 with q = 8 e_0, k = e_0, i = 0 and f = 40 at D = 64: its
    decay and stabiliser are exactly 0, so n_0 = q^ . k = 1 = exp(-m_row)."""
    args, grad_h = _inputs(1, 1, 32, 64, 0.0)
    args = [a.astype(np.float64) for a in args]
    q, k, _, i, f = args
    q[0, 0, 0] = 0.0
    q[0, 0, 0, 0] = 8.0
    k[0, 0, 0] = 0.0
    k[0, 0, 0, 0] = 1.0
    i[0, 0, 0], f[0, 0, 0] = 0.0, 40.0
    return args, grad_h.astype(np.float64)


def test_a_tie_of_the_denominator_is_split_in_half():
    """At |n_t| = exp(-m_row) the plain backward splits the grad in half
    between the two sides, as ``torch.maximum``'s gradient does (and so
    ``jnp.maximum``'s); sending it all to |n_t| misses autograd by far."""
    args, grad_h = _tie_inputs()
    _, (_, _, _, m_row, n_row) = ref.mlstm_chunkwise_fwd_states_ref(
        *(t(a) for a in args), cs=16)
    assert n_row[0, 0, 0].item() == 1.0 == torch.exp(-m_row[0, 0, 0]).item()
    want = _autograd_fp64(args, grad_h, 16)
    got = _plain_bwd(args, grad_h, torch.float64, 16)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(n(g), n(w)) <= FP64_TOL, name
    one_side = ref._tie_weight
    try:
        ref._tie_weight = lambda a, b: torch.where(a >= b, 1.0, 0.0).to(
            a.dtype)
        wrong = _plain_bwd(args, grad_h, torch.float64, 16)
    finally:
        ref._tie_weight = one_side
    assert max(_rel(n(g), n(w)) for g, w in zip(wrong, want)) > 1e-3


def _held_against_jax(got, want, wide):
    for name, g, w, y in zip(NAMES, got, want, wide):
        yard = max(_rel(n(w), n(y)), 2.0 ** -23)
        assert _rel(n(g), n(y)) <= JAX_YARDSTICKS * yard, name
        assert _rel(n(g), n(w)) <= JAX_YARDSTICKS * yard, name


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("b,h,s,d,cs", CASES)
def test_plain_backward_matches_jax_vjp_of_the_model_chunkwise(b, h, s, d,
                                                               cs, shift):
    """Against ``jax.vjp`` of ``repro.models.xlstm.mlstm_chunkwise`` at the
    same chunk size, both in fp32, the fp64 plain backward as the
    yardstick."""
    args, grad_h = _inputs(b, h, s, d, shift)
    _, vjp = jax.vjp(lambda *a: JX.mlstm_chunkwise(*a, cs=cs),
                     *(jnp.asarray(a) for a in args))
    _held_against_jax(_plain_bwd(args, grad_h, torch.float32, cs),
                      vjp(jnp.asarray(grad_h)),
                      _plain_bwd(args, grad_h, torch.float64, cs))


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("b,h,s,d,cs", CASES)
def test_plain_backward_matches_jax_vjp_of_the_oracle(b, h, s, d, cs,
                                                      shift):
    """Against ``jax.vjp`` of the sequential oracle
    ``repro.kernels.ref.mlstm_chunk_ref`` (a stabiliser a step), both in
    fp32, the fp64 plain backward as the yardstick."""
    args, grad_h = _inputs(b, h, s, d, shift)
    _, vjp = jax.vjp(lambda *a: jref.mlstm_chunk_ref(*a)[0],
                     *(jnp.asarray(a) for a in args))
    _held_against_jax(_plain_bwd(args, grad_h, torch.float32, cs),
                      vjp(jnp.asarray(grad_h)),
                      _plain_bwd(args, grad_h, torch.float64, cs))


@pytest.mark.parametrize("cs", [16, 64])
def test_plain_forward_with_states_is_the_chunkwise_form_bit_for_bit(cs):
    args = [t(a) for a in _inputs(2, 2, 128, 64, 0.0)[0]]
    h, states = MK.plain_forward_states(*args, cs=cs)
    assert torch.equal(h, MK.plain(*args, cs=cs))
    assert MK.SAVED_STATES == ("C", "n", "m", "m_row", "n_row")
    nc = 128 // cs
    assert [tuple(x.shape) for x in states] == [
        (2, 2, nc, 64, 64), (2, 2, nc, 64), (2, 2, nc), (2, 2, 128),
        (2, 2, 128)]
    C, nn, m, _, _ = states
    assert not C[:, :, 0].any() and not nn[:, :, 0].any() \
        and not m[:, :, 0].any()


def test_plain_backward_refuses_states_of_another_chunk_size():
    args, grad_h = _inputs(1, 1, 64, 64, 0.0)
    a = [t(x) for x in args]
    h, states = ref.mlstm_chunkwise_fwd_states_ref(*a, cs=16)
    with pytest.raises(ValueError, match="chunks"):
        ref.mlstm_chunkwise_bwd_ref(*a, h, states, t(grad_h), cs=32)


def _stand_in_forward(*a):
    return MK.plain_forward_states(*a, cs=16)


def _stand_in_backward(*a):
    return MK.plain_backward(*a, cs=16)


#: each non-empty subset of the five inputs
SUBSETS = [c for r in range(1, 6) for c in itertools.combinations(range(5), r)]


@pytest.mark.parametrize("wanted", SUBSETS,
                         ids=["".join(NAMES[i] for i in c) for c in SUBSETS])
def test_with_backward_gives_the_plain_grads(wanted):
    """The autograd.Function with the plain forward-with-states and the
    plain backward standing in for the kernels: h is the plain version's
    bit for bit, and the inputs that require grad (each subset of the
    five) get autograd's grads through the plain version, within 1e-5 of
    each one's largest value (two fp32 groupings of the same function;
    the measured yardsticks above sit at 1e-7 to 4e-6 without a shift)."""
    args = [t(a).requires_grad_(k in wanted)
            for k, a in enumerate(_inputs(2, 2, 64, 64, 0.0)[0])]
    h = MK.with_backward(_stand_in_forward, _stand_in_backward, *args)
    assert h.grad_fn is not None
    assert torch.equal(h, MK.plain(*args, cs=16))
    grad_h = torch.from_numpy(np.random.default_rng(2).standard_normal(
        h.shape).astype(np.float32))
    got = torch.autograd.grad(h, [args[k] for k in wanted], grad_h)
    fresh = [a.detach().clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(MK.plain(*fresh, cs=16),
                               [fresh[k] for k in wanted], grad_h)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel(n(g), n(w)) <= 1e-5


def _stand_ins(monkeypatch) -> dict:
    """The wrapper's three launches replaced by the plain versions, each
    call counted."""
    calls = {"forward": 0, "train": 0, "backward": 0}

    def counted(key, fn):
        def call(*a):
            calls[key] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(MK, "_launch",
                        counted("forward", lambda *a: MK.plain(*a, cs=16)))
    monkeypatch.setattr(MK, "_launch_train",
                        counted("train", _stand_in_forward))
    monkeypatch.setattr(MK, "_launch_backward",
                        counted("backward", _stand_in_backward))
    return calls


def test_mlstm_scan_takes_the_training_forward_only_under_grad(monkeypatch):
    calls = _stand_ins(monkeypatch)
    args = [t(a) for a in _inputs(1, 2, 32, 64, 0.0)[0]]
    MK.mlstm_scan(*args)
    with torch.no_grad():
        MK.mlstm_scan(*[a.requires_grad_(True) for a in args])
    assert calls == {"forward": 2, "train": 0, "backward": 0}
    h = MK.mlstm_scan(*args)
    assert calls["train"] == 1 and calls["backward"] == 0
    h.sum().backward()
    assert calls == {"forward": 2, "train": 1, "backward": 1}
    assert all(a.grad is not None for a in args)


def test_model_loss_through_the_stand_ins_matches_jax(monkeypatch):
    """xLSTM's smoke config (two mLSTM blocks at head dim 64) at S=512,
    where both models take the chunkwise form: the loss and every grad
    leaf with the mLSTM going through the wrapper's autograd.Function (the
    plain versions at the kernel's chunk of 16 standing in for the
    kernels) against ``jax.grad``, to tests/test_torch_train.py's limits
    (loss 1e-5, each leaf 1e-4 of its largest JAX grad, b_i on w_i's
    scale)."""
    calls = _stand_ins(monkeypatch)
    monkeypatch.setattr(
        ops, "mlstm_scan",
        lambda *a, cs=256, kernel_impl="hopper": MK.mlstm_scan(*a))
    jcfg, tcfg = jax_arch("xlstm-125m", smoke=True), \
        get_arch("xlstm-125m", smoke=True)
    jp, npp = jax_params(jcfg, seed=3)
    batch = synth_batch(tcfg, batch=1, seq=512, seed=5, step=0)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        JModel(jcfg).loss, has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, _), grads = value_and_grad(
        Model(tcfg), torch_params(npp, tcfg),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    n_m = sum(kind == "mlstm" for kind in tcfg.layer_pattern)
    assert n_m >= 1
    assert calls == {"forward": 0, "train": n_m, "backward": n_m}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        want[key] = np.asarray(leaf)
    got = {}
    map_with_path(lambda path, leaf: got.__setitem__(path, n(leaf)), grads)
    assert sorted(got) == sorted(want)
    scale_of = mlstm_b_i_scales(tcfg, want)
    for key in want:
        scale = max(float(np.abs(want[scale_of.get(key, key)]).max()), 1e-30)
        assert float(np.abs(got[key] - want[key]).max()) <= 1e-4 * scale, key


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    """The backward kernel's wrapper takes CUDA tensors only and launches
    nothing for others: it has no fallback to the plain backward, and
    neither has the training forward."""
    args = [t(a) for a in _inputs(1, 1, 32, 64, 0.0)[0]]
    h, states = MK.plain_forward_states(*args, cs=16)
    before = (MK.launches, MK.backward_launches)
    with pytest.raises(ValueError, match="CUDA"):
        MK._launch_backward(*args, h, states, torch.ones_like(h))
    with pytest.raises(ValueError, match="CUDA"):
        MK._launch_train(*args)
    assert (MK.launches, MK.backward_launches) == before


@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384, 448, 512])
def test_backward_tiles_fit_shared_memory(d):
    """The backward's tiles are those that divide d and whose CTA fits,
    never wider than the forward's; at the xLSTM head dim (384) the
    backward takes 32 or 64 columns, the forward up to 96."""
    fwd, bwd = MK.tile_widths(d), MK.tile_widths(d, backward=True)
    assert bwd and set(bwd) <= set(fwd)
    for dv in MK.TILE_WIDTHS:
        fits = d % dv == 0 and MK.backward_smem_bytes(d, dv) <= MK.SMEM_LIMIT
        assert (dv in bwd) == fits
    if d == 384:
        assert (fwd, bwd) == ([32, 64, 96], [32, 64])
        assert MK.backward_smem_bytes(384, 64) == 219968


def test_backward_geometry_at_the_train_shape():
    """B=8, H=4, D=384 on 132 SMs holding one CTA each: no tile's grid
    fits one wave, so the widest that fits, 64 columns: 192 CTAs in two
    waves, six a (b, h) and as many partial planes of dq and dk."""
    geo = MK.geometry(8, 4, 384, 132, {32: 1, 64: 1}, backward=True)
    assert (geo.dv, geo.grid, geo.waves, geo.backward) == (64, 192, 2, True)
    assert geo.smem_bytes == MK.backward_smem_bytes(384, 64)
    fwd = MK.geometry(8, 4, 384, 132, {32: 1, 64: 1, 96: 1})
    assert (fwd.dv, fwd.grid, fwd.waves, fwd.backward) == (96, 128, 1, False)
    small = MK.geometry(2, 2, 64, 132, {32: 2, 64: 2}, backward=True)
    assert small.dv == 32


def test_pod_rounds_count_the_mlstm_backward_kernel():
    counts = kernel_launches()
    assert counts["mlstm_scan_backward"] == MK.backward_launches
    assert counts["mlstm_scan"] == MK.launches
