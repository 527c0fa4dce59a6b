"""The sLSTM backward on the CPU: the plain backward ``slstm_scan_bwd_ref``
against autograd and ``jax.grad``, and the plumbing of the wrapper's
``autograd.Function`` with the plain versions standing in for the kernels
(the CUDA kernels themselves run in ``test_torch_cuda.py`` on the card).

Tolerances. In fp64 the plain backward equals autograd through the plain
forward to 1e-12 of each gradient's largest value (measured: below 1.1e-15
at these shapes; the two take the same steps in other groupings). In fp32
each gradient is held against JAX's within 1e-5 of its largest value
(``JAX_TOL``); the yardstick is each one's own error against the fp64
plain backward, which measured 1.0e-7 to 7.9e-7 for JAX and 1.1e-7 to
6.7e-7 for the port here (the two 8.3e-7 apart at most), so the limit
sits about 12x above either. The port's own fp32 error against fp64 is
also held within 4x JAX's (``JAX_YARDSTICKS``, at least one fp32 ulp):
the measured ratios were 0.26 to 2.5.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from _torch_parity import (_reset_port, jax_params,  # noqa: E402,F401
                           mlstm_b_i_scales, n, slstm_inputs, t,
                           torch_params)

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import synth_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import slstm_scan as SK  # noqa: E402
from repro_torch.launch.train import kernel_launches  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.tree import map_with_path  # noqa: E402

FP64_TOL = 1e-12
JAX_TOL = 1e-5
JAX_YARDSTICKS = 4.0
NAMES = ("z", "i", "f", "o", "r_z", "r_i", "r_f", "r_o")

#: tests/test_torch_kernels.py's SLSTM_CASES shapes (b, nh, s, hd), and
#: one at the model's head dim
CASES = [(1, 1, 64, 32), (2, 2, 64, 64), (1, 2, 128, 32), (2, 1, 32, 192)]


def _inputs(b, nh, s, hd):
    args = slstm_inputs(b * 10 + s + hd, b, nh, s, hd)
    grad_h = np.random.default_rng(9).standard_normal(
        (b, nh, s, hd)).astype(np.float32)
    return args, grad_h


def _plain_bwd(args, grad_h, dtype):
    a = [t(x).to(dtype) for x in args]
    h, states = ref.slstm_scan_fwd_states_ref(*a)
    return ref.slstm_scan_bwd_ref(h, states, *a[4:], t(grad_h).to(dtype))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-300)


@pytest.mark.parametrize("b,nh,s,hd", CASES)
def test_plain_backward_is_autograd_in_fp64(b, nh, s, hd):
    args, grad_h = _inputs(b, nh, s, hd)
    wide = [t(a).double().requires_grad_(True) for a in args]
    want = torch.autograd.grad(ref.slstm_scan_ref(*wide), wide,
                               t(grad_h).double())
    got = _plain_bwd(args, grad_h, torch.float64)
    assert len(got) == 8
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == torch.float64
        assert _rel(n(g), n(w)) <= FP64_TOL, name


@pytest.mark.parametrize("b,nh,s,hd", CASES)
def test_inputs_take_both_branches_of_each_maximum(b, nh, s, hd):
    """m = max(log f + m_prev, i) and n = max(f' n_prev + i', exp(-m))
    each pick either side somewhere in these inputs, so both routings of
    each adjoint are exercised."""
    args, _ = _inputs(b, nh, s, hd)
    h, (pz, pi, pf, po, c, nn, m) = ref.slstm_scan_fwd_states_ref(
        *(t(a).double() for a in args))
    m_p = F.pad(m, (0, 0, 1, 0))[:, :, :s]
    n_p = F.pad(nn, (0, 0, 1, 0))[:, :, :s]
    mf = F.logsigmoid(pf) + m_p
    nv = torch.exp(mf - m) * n_p + torch.exp(pi - m)
    em = torch.exp(-m)
    assert bool((mf > pi).any()) and bool((mf < pi).any())
    assert bool((nv > em).any()) and bool((nv < em).any())


@pytest.mark.parametrize("b,nh,s,hd", CASES)
def test_plain_backward_matches_jax_grad_of_the_oracle(b, nh, s, hd):
    """Against ``jax.vjp`` of ``repro.kernels.ref.slstm_scan_ref``, both in
    fp32, with the fp64 plain backward as the yardstick."""
    args, grad_h = _inputs(b, nh, s, hd)
    _, vjp = jax.vjp(jref.slstm_scan_ref, *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(grad_h))
    got = _plain_bwd(args, grad_h, torch.float32)
    wide = _plain_bwd(args, grad_h, torch.float64)
    for name, g, w, y in zip(NAMES, got, want, wide):
        assert _rel(n(g), n(w)) <= JAX_TOL, name
        assert _rel(n(g), n(y)) <= JAX_YARDSTICKS * max(
            _rel(n(w), n(y)), 2.0 ** -23), name


def _model_scan_grads_torch(p, x, nh, grad_h, dtype):
    """The JAX model's sLSTM (input projections, then the scan) written
    with the port's plain forward and backward: grads of x, w_*, b_*,
    r_*."""
    p = {k: t(v).to(dtype) for k, v in p.items()}
    x = t(x).to(dtype)
    b, s, d = x.shape
    hd = d // nh
    pre = [(x @ p[f"w_{g}"] + p[f"b_{g}"]).reshape(b, s, nh, hd)
           .transpose(1, 2).contiguous() for g in "zifo"]
    rs = [p[f"r_{g}"] for g in "zifo"]
    h, states = ref.slstm_scan_fwd_states_ref(*pre, *rs)
    gh = t(grad_h).to(dtype).reshape(b, s, nh, hd).transpose(1, 2)
    grads = ref.slstm_scan_bwd_ref(h, states, *rs, gh.contiguous())
    dpre = [g.transpose(1, 2).reshape(b, s, d) for g in grads[:4]]
    out = {"x": sum(dp @ p[f"w_{g}"].T for g, dp in zip("zifo", dpre))}
    for g, dp, dr in zip("zifo", dpre, grads[4:]):
        out[f"w_{g}"] = torch.einsum("bsd,bse->de", x, dp)
        out[f"b_{g}"] = dp.sum((0, 1))
        out[f"r_{g}"] = dr
    return out


@pytest.mark.parametrize("b,nh,s,hd", CASES)
def test_plain_backward_matches_jax_grad_of_the_model_scan(b, nh, s, hd):
    """Against ``jax.vjp`` of the JAX model's ``lax.scan`` sLSTM
    (``repro.models.xlstm.slstm_scan``) with random input projections, the
    model's biases (3 on f), both in fp32, the fp64 port as the
    yardstick."""
    d = nh * hd
    rng = np.random.default_rng(b * 100 + s + hd)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    p = {}
    for g in "zifo":
        p[f"w_{g}"] = (rng.standard_normal((d, d)) * d ** -0.5).astype(
            np.float32)
        p[f"r_{g}"] = (rng.standard_normal((nh, hd, hd)) * hd ** -0.5
                       ).astype(np.float32)
        p[f"b_{g}"] = np.full((d,), 3.0 if g == "f" else 0.0, np.float32)
    grad_h = rng.standard_normal((b, s, d)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _, vjp = jax.vjp(lambda q, xx: JX.slstm_scan(q, xx, nh)[0], jp,
                     jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(grad_h))
    want = {"x": jgx, **jgp}
    got = _model_scan_grads_torch(p, x, nh, grad_h, torch.float32)
    wide = _model_scan_grads_torch(p, x, nh, grad_h, torch.float64)
    assert sorted(got) == sorted(want)
    for name in want:
        assert _rel(n(got[name]), n(want[name])) <= JAX_TOL, name
        assert _rel(n(got[name]), n(wide[name])) <= JAX_YARDSTICKS * max(
            _rel(n(want[name]), n(wide[name])), 2.0 ** -23), name


def test_plain_forward_with_states_is_the_oracle_bit_for_bit():
    args = [t(a) for a in slstm_inputs(3, 2, 2, 48, 32)]
    h, states = SK.plain_forward_states(*args)
    assert torch.equal(h, SK.plain(*args))
    assert states.shape == (len(SK.SAVED_PLANES), 2, 2, 48, 32)
    assert SK.SAVED_PLANES == ("z", "i", "f", "o", "c", "n", "m")


@pytest.mark.parametrize("needs", ["all", "gates", "recurrent"])
def test_with_backward_gives_the_plain_grads(needs):
    """The autograd.Function with the plain forward-with-states and the
    plain backward standing in for the kernels: h is the plain version's
    bit for bit, and the inputs that require grad get autograd's grads
    through the plain version, within 1e-5 of each one's largest value
    (two fp32 groupings of the same steps; JAX_TOL's yardstick)."""
    wanted = {"all": range(8), "gates": range(4),
              "recurrent": range(4, 8)}[needs]
    args = [t(a).requires_grad_(k in wanted)
            for k, a in enumerate(slstm_inputs(4, 2, 2, 64, 32))]
    h = SK.with_backward(SK.plain_forward_states, SK.plain_backward, *args)
    assert h.grad_fn is not None
    assert torch.equal(h, SK.plain(*args))
    grad_h = torch.from_numpy(np.random.default_rng(2).standard_normal(
        h.shape).astype(np.float32))
    got = torch.autograd.grad(h, [args[k] for k in wanted], grad_h)
    fresh = [a.detach().clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(SK.plain(*fresh), [fresh[k] for k in wanted],
                               grad_h)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel(n(g), n(w)) <= JAX_TOL


def _stand_ins(monkeypatch) -> dict:
    """The wrapper's three launches replaced by the plain versions, each
    call counted."""
    calls = {"forward": 0, "train": 0, "backward": 0}

    def counted(key, fn):
        def call(*a):
            calls[key] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(SK, "_launch", counted("forward", SK.plain))
    monkeypatch.setattr(SK, "_launch_train",
                        counted("train", SK.plain_forward_states))
    monkeypatch.setattr(SK, "_launch_backward",
                        counted("backward", SK.plain_backward))
    return calls


def test_slstm_scan_takes_the_training_forward_only_under_grad(monkeypatch):
    calls = _stand_ins(monkeypatch)
    args = [t(a) for a in slstm_inputs(5, 1, 2, 16, 32)]
    SK.slstm_scan(*args)
    with torch.no_grad():
        SK.slstm_scan(*[a.requires_grad_(True) for a in args])
    assert calls == {"forward": 2, "train": 0, "backward": 0}
    h = SK.slstm_scan(*args)
    assert calls["train"] == 1 and calls["backward"] == 0
    h.sum().backward()
    assert calls == {"forward": 2, "train": 1, "backward": 1}
    assert all(a.grad is not None for a in args)


def test_model_loss_through_the_stand_ins_matches_jax(monkeypatch):
    """xLSTM's smoke config (one sLSTM block) at S=64: the loss and every
    grad leaf with the sLSTM going through the wrapper's autograd.Function
    (the plain versions standing in for the kernels) against ``jax.grad``,
    to tests/test_torch_train.py's limits (loss 1e-5, each leaf 1e-4 of
    its largest JAX grad, b_i on w_i's scale)."""
    calls = _stand_ins(monkeypatch)
    monkeypatch.setattr(ops, "slstm_scan",
                        lambda *a, kernel_impl="hopper": SK.slstm_scan(*a))
    jcfg, tcfg = jax_arch("xlstm-125m", smoke=True), \
        get_arch("xlstm-125m", smoke=True)
    jp, npp = jax_params(jcfg, seed=2)
    batch = synth_batch(tcfg, batch=2, seq=64, seed=4, step=0)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        JModel(jcfg).loss, has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, _), grads = value_and_grad(
        Model(tcfg), torch_params(npp, tcfg),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    n_s = sum(kind == "slstm" for kind in tcfg.layer_pattern)
    assert n_s >= 1
    assert calls == {"forward": 0, "train": n_s, "backward": n_s}
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
    nothing for others: it has no fallback to the plain backward."""
    args = [t(a) for a in slstm_inputs(6, 1, 1, 8, 32)]
    h, states = SK.plain_forward_states(*args)
    before = SK.backward_launches
    with pytest.raises(ValueError, match="CUDA"):
        SK._launch_backward(h, states, *args[4:], torch.ones_like(h))
    assert SK.backward_launches == before


def test_pod_rounds_count_the_backward_kernel():
    counts = kernel_launches()
    assert counts["slstm_scan_backward"] == SK.backward_launches
    assert sorted(counts) == ["decode_attention", "flash_attention",
                              "mlstm_scan", "mlstm_scan_backward",
                              "rglru_scan", "slstm_scan",
                              "slstm_scan_backward"]
