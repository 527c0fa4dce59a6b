"""The port's decode Server on the CPU against the JAX Server of
examples/serve.py: same smoke weights (converted), same 6 prompts, same
greedy tokens, each request answered through a future, for xLSTM-125M and
RecurrentGemma-9B."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402
from _torch_parity import (MODEL_TOL, _reset_port,  # noqa: E402,F401
                           jax_serve_example, n, serve_all, torch_params)

import repro.core as jrc  # noqa: E402
import repro_torch.core as rc  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import Server  # noqa: E402
from repro_torch.train import make_prefill_step  # noqa: E402


def test_server_matches_jax_server_tokens():
    mod = jax_serve_example()
    jrc.plan("threads", workers=8)
    jserver = mod.Server()
    rng = np.random.default_rng(0)                 # as serve.py's main()
    prompts = [rng.integers(0, jserver.cfg.vocab_size, size=4).tolist()
               for _ in range(6)]
    want = serve_all(jserver, jrc, prompts)

    rc.plan("threads", workers=8)
    np_params = jax.tree_util.tree_map(np.asarray, jserver.params)
    server = Server(device="cpu",
                    params=torch_params(np_params, jserver.cfg))
    got = serve_all(server, rc, prompts)
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
    (toks,) = serve_all(server, rc, [prompt])
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
    replies = serve_all(server, rc, prompts)
    assert [len(r) for r in replies] == [3] * 5
    alone = [serve_all(Server(device="cpu", slots=1, max_new=3), rc, [p])[0]
             for p in prompts]
    assert replies == alone


def test_recurrentgemma_server_matches_jax_server_tokens():
    """The JAX Server sizes its caches for 64 positions and the port's for
    the batch (prompt + max_new = 20): both local-attention caches hold 16
    positions, the smoke window, and every generated token past it agrees."""
    mod = jax_serve_example()
    jrc.plan("threads", workers=8)
    jserver = mod.Server(arch="recurrentgemma-9b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jserver.cfg.vocab_size, size=4).tolist()
               for _ in range(6)]
    want = serve_all(jserver, jrc, prompts)

    rc.plan("threads", workers=8)
    np_params = jax.tree_util.tree_map(np.asarray, jserver.params)
    server = Server("recurrentgemma-9b", device="cpu",
                    params=torch_params(np_params, jserver.cfg))
    got = serve_all(server, rc, prompts)
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
    (toks,) = serve_all(server, rc, [prompt])
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
