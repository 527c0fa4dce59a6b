"""Shared helpers for the PyTorch port's tests (``test_torch_*.py``).

Not collected (leading underscore). Inputs are made with numpy from a seed
and handed to the JAX package and the port alike; parameters go from a JAX
``Model.init`` pytree through ``repro_torch.convert.params_from_jax``.
"""

from __future__ import annotations

import importlib.util
import pathlib
import threading

import numpy as np
import pytest
import torch

import repro_torch.core as prc

# Tolerances. The kernel ones are tests/test_kernels.py's: mLSTM 5e-4
# (chunked vs sequential stabilisers), sLSTM and RG-LRU 3e-5, attention
# 2e-5 in fp32 and 2e-2 in bf16 (``_tol``). Model parity in fp32 is 1e-4:
# XLA and ATen sum matmuls in different orders, about 1e-6 of each value
# per block, and the logits reach ~70 at smoke width.
MLSTM_TOL = dict(rtol=5e-4, atol=5e-4)
SLSTM_TOL = dict(rtol=3e-5, atol=3e-5)
RGLRU_TOL = dict(rtol=3e-5, atol=3e-5)
ATTN_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _reset_port():
    """The port's plan, seed and shared state per test (tests/conftest.py
    resets only repro.core)."""
    prc.plan("sequential")
    prc.set_session_seed(0)
    prc.state.reset()              # fresh shared-state service per test
    yield
    prc.shutdown()
    prc.plan("sequential")
    prc.state.reset()


@pytest.fixture
def cuda_device():
    """The GPU for ``requires_cuda`` tests; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 host)")
    return torch.device("cuda")


#: the port's backend matrix for the Future-API mirrors: (id, name, kwargs)
BACKENDS = [
    ("sequential", "sequential", {}),
    ("threads", "threads", {"workers": 2}),
    # the synchronous form: on the card it records a CUDA event instead
    ("cuda_async", "cuda_async", {"device": "cpu"}),
    ("asyncio", "asyncio", {}),
]
BACKEND_IDS = [b[0] for b in BACKENDS]


@pytest.fixture(params=BACKENDS, ids=BACKEND_IDS)
def backend(request):
    """Each test of a backend-parametrised mirror runs once a backend."""
    _id, name, kw = request.param
    prc.plan(name, **kw)
    yield name
    prc.shutdown()


def randn(rng: np.random.Generator, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def mlstm_inputs(seed, b, h, s, d):
    """q, k, v (B,H,S,D) and gates i, f (B,H,S) for mlstm_scan."""
    rng = np.random.default_rng(seed)
    return (randn(rng, b, h, s, d), randn(rng, b, h, s, d),
            randn(rng, b, h, s, d), randn(rng, b, h, s),
            randn(rng, b, h, s, shift=2.0))


def slstm_inputs(seed, b, nh, s, hd):
    """z, i, f, o (B,NH,S,HD) and r_z, r_i, r_f, r_o (NH,HD,HD)."""
    rng = np.random.default_rng(seed)
    xs = [randn(rng, b, nh, s, hd) for _ in range(4)]
    rs = [randn(rng, nh, hd, hd, scale=hd ** -0.5) for _ in range(4)]
    return xs + rs


def flash_inputs(seed, b, kv, g, s, d):
    """q (B,H,S,D) and k, v (B,KV,S,D), H = KV*G."""
    rng = np.random.default_rng(seed)
    return (randn(rng, b, kv * g, s, d), randn(rng, b, kv, s, d),
            randn(rng, b, kv, s, d))


def decode_inputs(seed, b, kv, g, s, d, lengths=None):
    """q (B,H,D), a cache k, v (B,S,KV,D) and lengths (B,) int32 in
    [1, S] unless given."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = rng.integers(1, s + 1, size=b)
    return (randn(rng, b, kv * g, d), randn(rng, b, s, kv, d),
            randn(rng, b, s, kv, d), np.asarray(lengths, np.int32))


def rglru_inputs(seed, b, s, w, with_h0):
    """x (B,S,W), gates in (0, 1), lambda (W,) around 3, h0 (B,W) or
    None, as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    x = randn(rng, b, s, w)
    ag = 1 / (1 + np.exp(-randn(rng, b, s, w)))
    ig = 1 / (1 + np.exp(-randn(rng, b, s, w)))
    lam = randn(rng, w, shift=3.0)
    h0 = randn(rng, b, w) if with_h0 else None
    return x, ag.astype(np.float32), ig.astype(np.float32), lam, h0


def t(a: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_params(cfg, seed: int = 0):
    """(JAX params, the same as a numpy pytree) from ``Model(cfg).init``.
    A stage with repeat > 1 is one dict whose leaves are stacked on a
    leading axis in both packages, so the numpy pytree hands over as it
    is."""
    import jax
    from repro.models import Model
    params = Model(cfg).init(jax.random.PRNGKey(seed))
    return params, jax.tree_util.tree_map(np.asarray, params)


def torch_params(np_tree, cfg, device="cpu"):
    from repro_torch.convert import params_from_jax
    return params_from_jax(np_tree, cfg, device=device)


def mlstm_b_i_scales(cfg, names) -> dict:
    """{b_i path: w_i path} for the mLSTM blocks of ``cfg``. The input-gate
    bias b_i's grad is the sum of dL/d i_raw over positions, which cancels
    to 1e-4 or less of its sibling w_i's (the same terms weighted by the
    conv output), so a grad comparison holds b_i on w_i's scale
    (test_torch_train.py's docstring has the measurement)."""
    kinds = dict(enumerate(cfg.layer_pattern))
    return {name: name[:-len("b_i")] + "w_i" for name in names
            if name.endswith("/b_i")
            and kinds[int(name.split("/")[2][1:])] == "mlstm"}


def chip_smoke():
    """The repo's ``chip_smoke.py`` as a module (its helpers: the 1-ulp
    yardstick, ``WidenedFlash``); importing it starts nothing."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROOT = pathlib.Path(__file__).resolve().parents[1]


def jax_serve_example():
    """The JAX package's ``examples/serve.py`` as a module (its
    ``Server``)."""
    spec = importlib.util.spec_from_file_location(
        "jax_serve_example", ROOT / "examples" / "serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def serve_all(server, api, prompts) -> list:
    """Submits every prompt to ``server`` before its loop starts (so the
    JAX Server and the port's batch them alike: 4 then 2), runs the loop
    on a thread and returns the values of the futures of ``api`` (JAX's
    Future API or the port's) in order. Each pending request holds a
    worker of the plan, so the plan needs at least as many workers as
    there are prompts."""
    futures = [server.submit(p) for p in prompts]
    loop = threading.Thread(target=server.serve_loop, daemon=True)
    loop.start()
    try:
        return [api.value(f) for f in futures]
    finally:
        server._stop = True
        loop.join(timeout=10)
        assert not loop.is_alive()


def decided(logits, tol: float) -> np.ndarray:
    """Rows whose top-2 margin exceeds ``tol`` of the largest |logit|:
    there the greedy token is decided, whatever the rounding."""
    x = n(logits).astype(np.float32).reshape(-1, logits.shape[-1])
    top2 = np.sort(x, -1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > tol * np.abs(x).max()


def jax_greedy(jcfg, jp, batch, tol: float, max_new: int = 16) -> tuple:
    """The JAX Server's ``_decode_batch`` on ``batch`` (prompts), through
    ``decode_step`` so that the logits are seen: each request's tokens and,
    for each, whether the reference's top-2 margin decided it."""
    import jax
    import jax.numpy as jnp
    from repro.models import Model as JModel
    jm = JModel(jcfg)
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(len(batch), max_seq=64, dtype=jnp.float32)
    maxlen = max(len(p) for p in batch)
    toks = [[] for _ in batch]
    sure = [[] for _ in batch]
    last = [0] * len(batch)
    for s in range(maxlen + max_new):
        col = [p[s] if s < len(p) else last[i] for i, p in enumerate(batch)]
        logits, cache = step(jp, cache, jnp.asarray(col, jnp.int32)[:, None])
        last = [int(x) for x in np.asarray(logits[:, -1].argmax(-1))]
        rows = decided(logits[:, -1], tol)
        for i, p in enumerate(batch):
            if s >= len(p) - 1:
                toks[i].append(last[i])
                sure[i].append(bool(rows[i]))
    return ([x[:max_new] for x in toks], [x[:max_new] for x in sure])
