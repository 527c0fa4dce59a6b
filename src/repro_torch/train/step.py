"""serve_step / prefill_step builders. Counterpart of the serving half of
``repro/train/step.py``; the train step comes with training.

``make_serve_step`` performs one greedy decode step for a whole request
batch against the recurrent cache; ``make_prefill_step`` runs the full
forward over a prompt and returns the greedy token after it.
``make_eval_step`` reports the loss, so it comes with training too.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..models.model import Model


def make_serve_step(model: Model) -> Callable:
    """One decode step for a batch of requests: greedy argmax sampling.
    (params, cache, tokens (B,1)) -> (next tokens (B,1) int32, cache)."""

    @torch.no_grad()
    def serve_step(params, cache: Any, tokens: torch.Tensor
                   ) -> tuple[torch.Tensor, Any]:
        logits, new_cache = model.decode_step(params, cache, tokens)
        next_tokens = logits[:, -1:].argmax(-1).to(torch.int32)
        return next_tokens, new_cache

    return serve_step


def make_prefill_step(model: Model) -> Callable:
    """Prefill: full forward over the prompt; the logits of the last
    position give the first generated token, (B,1) int32."""

    @torch.no_grad()
    def prefill_step(params, batch: dict) -> torch.Tensor:
        logits, _ = model.apply(params, batch)
        return logits[:, -1:].argmax(-1).to(torch.int32)

    return prefill_step
