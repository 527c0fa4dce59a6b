"""The port's decode Server on the CPU against the JAX Server of
examples/serve.py: same smoke weights (converted), same 6 prompts, same
greedy tokens, each request answered through a future, for xLSTM-125M and
RecurrentGemma-9B."""

import importlib.util
import os
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402
from _torch_parity import MODEL_TOL, _reset_port, n, torch_params  # noqa: E402,F401

import repro.core as jrc  # noqa: E402
import repro_torch.core as rc  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import Server  # noqa: E402
from repro_torch.train import make_prefill_step  # noqa: E402

_EXAMPLE = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "serve.py")


def _jax_server_module():
    spec = importlib.util.spec_from_file_location("jax_serve_example",
                                                  _EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serve(server, api, prompts):
    """Submit every prompt before the loop starts (so both servers batch
    them alike: 4 then 2), then collect through the futures. Each pending
    request holds a worker of the plan, so the plan needs at least as many
    workers as there are prompts."""
    futures = [server.submit(p) for p in prompts]
    loop = threading.Thread(target=server.serve_loop, daemon=True)
    loop.start()
    try:
        return [api.value(f) for f in futures]
    finally:
        server._stop = True
        loop.join(timeout=10)
        assert not loop.is_alive()


def test_server_matches_jax_server_tokens():
    mod = _jax_server_module()
    jrc.plan("threads", workers=8)
    jserver = mod.Server()
    rng = np.random.default_rng(0)                 # as serve.py's main()
    prompts = [rng.integers(0, jserver.cfg.vocab_size, size=4).tolist()
               for _ in range(6)]
    want = _serve(jserver, jrc, prompts)

    rc.plan("threads", workers=8)
    np_params = jax.tree_util.tree_map(np.asarray, jserver.params)
    server = Server(device="cpu",
                    params=torch_params(np_params, jserver.cfg))
    got = _serve(server, rc, prompts)
    assert got == want
    assert all(len(toks) == 16 for toks in got)


def test_long_prompt_first_token_matches_prefill_step():
    """A 512-token prompt: the Server prefills it by single-token decode
    steps, the prefill step by one chunkwise forward (the kernel path);
    the first generated token and the logits behind it agree."""
    rc.plan("threads", workers=4)
    server = Server(device="cpu", max_new=2, seed=1)
    prompt = np.random.default_rng(1).integers(
        0, server.cfg.vocab_size, size=512).tolist()
    (toks,) = _serve(server, rc, [prompt])
    batch = {"tokens": torch.tensor([prompt])}
    assert toks[0] == int(make_prefill_step(server.model)(server.params,
                                                          batch))
    model = Model(server.cfg)
    want, _ = model.apply(server.params, batch)
    cache = model.init_cache(1, device="cpu")
    for i in range(len(prompt)):
        got, cache = model.decode_step(server.params, cache,
                                       batch["tokens"][:, i:i + 1])
    np.testing.assert_allclose(n(got[0, -1]), n(want[0, -1]), **MODEL_TOL)


def test_server_batches_more_requests_than_slots():
    rc.plan("threads", workers=8)
    server = Server(device="cpu", slots=2, max_new=3)
    prompts = [[1, 2, 3], [4], [5, 6], [7, 8, 9, 10], [11]]
    replies = _serve(server, rc, prompts)
    assert [len(r) for r in replies] == [3] * 5
    alone = [_serve(Server(device="cpu", slots=1, max_new=3), rc, [p])[0]
             for p in prompts]
    assert replies == alone


def test_recurrentgemma_server_matches_jax_server_tokens():
    """The JAX Server sizes its caches for 64 positions and the port's for
    the batch (prompt + max_new = 20): both local-attention caches hold 16
    positions, the smoke window, and every generated token past it agrees."""
    mod = _jax_server_module()
    jrc.plan("threads", workers=8)
    jserver = mod.Server(arch="recurrentgemma-9b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jserver.cfg.vocab_size, size=4).tolist()
               for _ in range(6)]
    want = _serve(jserver, jrc, prompts)

    rc.plan("threads", workers=8)
    np_params = jax.tree_util.tree_map(np.asarray, jserver.params)
    server = Server("recurrentgemma-9b", device="cpu",
                    params=torch_params(np_params, jserver.cfg))
    got = _serve(server, rc, prompts)
    assert got == want
    assert all(len(toks) == 16 for toks in got)


def test_recurrentgemma_long_prompt_first_token_matches_prefill_step():
    """A 48-token prompt, three times the smoke window: the Server's
    single-token steps wrap the ring buffer and still give the prefill
    step's first token and logits."""
    rc.plan("threads", workers=4)
    server = Server("recurrentgemma-9b", device="cpu", max_new=2, seed=1)
    prompt = np.random.default_rng(1).integers(
        0, server.cfg.vocab_size, size=48).tolist()
    (toks,) = _serve(server, rc, [prompt])
    batch = {"tokens": torch.tensor([prompt])}
    assert toks[0] == int(make_prefill_step(server.model)(server.params,
                                                          batch))
    model = Model(server.cfg)
    want, _ = model.apply(server.params, batch)
    cache = model.init_cache(1, max_seq=50, device="cpu",
                             dtype=torch.float32)
    for i in range(len(prompt)):
        got, cache = model.decode_step(server.params, cache,
                                       batch["tokens"][:, i:i + 1])
    np.testing.assert_allclose(n(got[0, -1]), n(want[0, -1]), **MODEL_TOL)
