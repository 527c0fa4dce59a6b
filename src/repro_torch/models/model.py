"""Model assembly in PyTorch: builds an architecture from an ArchConfig.
Counterpart of ``repro/models/model.py``.

Block kinds of this slice: ``mlstm`` (self-contained mLSTM block) and
``slstm`` (self-contained sLSTM block), the xLSTM stack. Parameters are a
plain nested dict with the JAX pytree's paths (``stages/0/b3/cell/w_up``),
so ``repro_torch.convert.params_from_jax`` maps one onto the other leaf by
leaf. Stages run unrolled: xLSTM has ``scan_layers=False``, and a stage
with repeat > 1 (stacked params) comes with the families that use it.
Activation checkpointing comes with training.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import torch

from ..device import resolve_device
from ..kernels.ops import KERNEL_IMPLS
from . import layers as L
from . import xlstm as XL

if TYPE_CHECKING:                      # avoid circular import (configs -> models)
    from ..configs.base import ArchConfig
else:
    ArchConfig = Any

Params = dict

#: block kinds of the JAX package that later slices of the port bring
_LATER = {"attn": "the GQA attention slice", "dense": "the GQA attention slice",
          "moe": "the MoE slice", "lattn": "the recurrentgemma slice",
          "rglru": "the recurrentgemma slice", "mla": "the MLA slice"}


def _unsupported(kind: str) -> NotImplementedError:
    if kind in _LATER:
        return NotImplementedError(
            f"block kind {kind!r} is not ported yet; it comes with "
            f"{_LATER[kind]}")
    return NotImplementedError(f"unknown block kind {kind!r}")


# --------------------------------------------------------------------------
# Per-block init / apply / cache dispatch
# --------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ArchConfig, kind: str, dtype,
               device) -> Params:
    norm_init = (L.layernorm_init if cfg.norm == "layernorm"
                 else L.rmsnorm_init)
    if kind == "mlstm":
        return {"ln1": norm_init(cfg.d_model, dtype, device),
                "cell": XL.mlstm_block_init(gen, cfg.xlstm, dtype, device)}
    if kind == "slstm":
        return {"cell": XL.slstm_block_init(gen, cfg.xlstm, dtype, device)}
    raise _unsupported(kind)


def _norm(cfg: ArchConfig, p: Params, x):
    if cfg.norm == "layernorm":
        return L.layernorm(p, x, cfg.norm_eps)
    return L.rmsnorm(p, x, cfg.norm_eps)


def block_apply(p: Params, x, cfg: ArchConfig, kind: str, *, cache=None,
                kernel_impl: str = "hopper"):
    """Returns (x_out, new_cache)."""
    if kind == "mlstm":
        h, new_cache = XL.mlstm_block_apply(
            p["cell"], _norm(cfg, p["ln1"], x), cfg.xlstm, cache=cache,
            kernel_impl=kernel_impl)
        return x + h, new_cache
    if kind == "slstm":
        h, new_cache = XL.slstm_block_apply(p["cell"], x, cfg.xlstm,
                                            cache=cache,
                                            kernel_impl=kernel_impl)
        return x + h, new_cache
    raise _unsupported(kind)


def block_cache_init(cfg: ArchConfig, kind: str, batch: int,
                     device) -> Params:
    # the xLSTM caches are fp32 whatever dtype the model runs in
    if kind == "mlstm":
        return XL.mlstm_cache_init(batch, cfg.xlstm, torch.float32, device)
    if kind == "slstm":
        return XL.slstm_cache_init(batch, cfg.xlstm, torch.float32, device)
    raise _unsupported(kind)


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------

class Model:
    """``kernel_impl="hopper"`` runs each kernel of the path on a CUDA
    tensor and its plain version on a CPU tensor; ``"plain"`` runs the
    plain versions on any device."""

    def __init__(self, cfg: ArchConfig, kernel_impl: str = "hopper"):
        if kernel_impl not in KERNEL_IMPLS:
            raise ValueError(f"kernel_impl must be one of {KERNEL_IMPLS}")
        for pattern, repeat in cfg.stages:
            if repeat != 1:
                raise NotImplementedError(
                    "stacked (scanned) stages come with the families that "
                    "use them; set scan_layers=False")
            for kind in pattern:
                if kind not in ("mlstm", "slstm"):
                    raise _unsupported(kind)
        if cfg.frontend is not None:
            raise NotImplementedError(
                f"the {cfg.frontend} frontend comes with its model family")
        self.cfg = cfg
        self.kernel_impl = kernel_impl

    # -- params ---------------------------------------------------------------

    def init(self, generator: torch.Generator, *, device=None,
             dtype=torch.float32) -> Params:
        """Random parameters drawn from ``generator`` (on its own device)
        and placed on ``device`` (the GPU by default; ``"meta"`` gives the
        shapes alone)."""
        cfg = self.cfg
        dev = resolve_device(device)
        norm_init = (L.layernorm_init if cfg.norm == "layernorm"
                     else L.rmsnorm_init)
        p: Params = {"embed": L.embedding_init(generator, cfg.vocab_size,
                                               cfg.d_model, dtype, dev)}
        p["final_norm"] = norm_init(cfg.d_model, dtype, dev)
        if not cfg.tie_embeddings:
            p["unembed"] = L.embedding_init(generator, cfg.vocab_size,
                                            cfg.d_model, dtype, dev)
        p["stages"] = [
            {f"b{bi}": block_init(generator, cfg, kind, dtype, dev)
             for bi, kind in enumerate(pattern)}
            for pattern, _ in cfg.stages]
        return p

    # -- forward --------------------------------------------------------------

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = _norm(cfg, params["final_norm"], x)
        table = (params["embed"] if cfg.tie_embeddings
                 else params["unembed"])
        logits = L.unembed(table, x)                           # fp32
        if cfg.logits_softcap:
            c = cfg.logits_softcap
            logits = torch.tanh(logits / c) * c
        return logits

    def apply(self, params: Params, batch: dict
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (logits fp32, aux_loss); the
        xLSTM blocks add no auxiliary loss, so aux is 0."""
        cfg = self.cfg
        x = L.embed(params["embed"], batch["tokens"])
        for (pattern, _), sp in zip(cfg.stages, params["stages"]):
            for bi, kind in enumerate(pattern):
                x, _ = block_apply(sp[f"b{bi}"], x, cfg, kind,
                                   kernel_impl=self.kernel_impl)
        return self._logits(params, x), x.new_zeros((), dtype=torch.float32)

    # -- decode ---------------------------------------------------------------

    def init_cache(self, batch: int, max_seq: int = 0, *,
                   device=None) -> list:
        """Per-block recurrent state (fp32). ``max_seq`` is accepted for
        the JAX signature; the xLSTM state does not grow with it."""
        dev = resolve_device(device)
        return [{f"b{bi}": block_cache_init(self.cfg, kind, batch, dev)
                 for bi, kind in enumerate(pattern)}
                for pattern, _ in self.cfg.stages]

    @torch.no_grad()
    def decode_step(self, params: Params, cache: list,
                    tokens: torch.Tensor) -> tuple[torch.Tensor, list]:
        """One token for every sequence. tokens: (B, 1) int."""
        cfg = self.cfg
        x = L.embed(params["embed"], tokens)
        new_caches = []
        for (pattern, _), sp, sc in zip(cfg.stages, params["stages"], cache):
            nc = {}
            for bi, kind in enumerate(pattern):
                x, nc[f"b{bi}"] = block_apply(sp[f"b{bi}"], x, cfg, kind,
                                              cache=sc[f"b{bi}"],
                                              kernel_impl=self.kernel_impl)
            new_caches.append(nc)
        return self._logits(params, x), new_caches

    def param_count(self) -> int:
        shapes = self.init(torch.Generator(), device="meta")
        return sum(t.numel() for t in _leaves(shapes))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
