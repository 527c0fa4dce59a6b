"""Model assembly in PyTorch: builds an architecture from an ArchConfig.
Counterpart of ``repro/models/model.py``.

Block kinds of the port so far:
  attn    pre-norm GQA/MQA attention + pre-norm MLP (yi, nemotron, qwen2-vl)
  moe     pre-norm attention + pre-norm MoE (shared + routed experts)
  dense   like attn with an MLP of width ``moe_dense_ff or d_ff``
  mla     pre-norm Multi-head Latent Attention + pre-norm MLP (minicpm3)
  mlstm   self-contained mLSTM block (xLSTM)
  slstm   self-contained sLSTM block (xLSTM)
  rglru   RG-LRU recurrent temporal mixing + MLP (recurrentgemma)
  lattn   local (windowed) attention + MLP (recurrentgemma)

Parameters are a plain nested dict with the JAX pytree's paths
(``stages/0/b3/cell/w_up``), so ``repro_torch.convert.params_from_jax``
maps one onto the other leaf by leaf. A stage with repeat > 1 has its
parameters (and its decode caches) stacked on a leading axis, exactly as
the JAX package stacks them for ``lax.scan``; here a Python loop runs the
repeats over views ``p[r]``. ``Model.loss`` is the training loss;
``remat`` checkpoints each unit of a stage's repeat as the JAX model's
``_maybe_remat`` does (``none``, ``full``, ``dots``). Under the audio
frontend (HuBERT) the batch carries ``frames`` (B, S, frontend_dim) in
place of tokens; such an encoder-only config (``decode_capable=False``)
has no decode step.
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Any

import torch
from torch.utils import checkpoint as ckpt

from ..device import resolve_device
from ..kernels.ops import KERNEL_IMPLS
from ..tree import leaves, tree_map
from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import rglru as RG
from . import xlstm as XL

if TYPE_CHECKING:                      # avoid circular import (configs -> models)
    from ..configs.base import ArchConfig
else:
    ArchConfig = Any

Params = dict

_KINDS = ("attn", "dense", "moe", "mla", "mlstm", "slstm", "rglru", "lattn")
_ATTN_KINDS = ("attn", "dense", "moe", "lattn")


def _unsupported(kind: str) -> NotImplementedError:
    return NotImplementedError(f"unknown block kind {kind!r}")


def check_decode_capable(cfg: ArchConfig) -> None:
    """Raise for a config with no decode step (an encoder-only one), with
    the reason the reference's ``ArchConfig.supports`` gives for a decode
    shape and the ValueError its launcher raises on it."""
    if not cfg.decode_capable:
        raise ValueError(f"{cfg.name}: encoder-only architecture has no "
                         f"decode step")


def _attn_dims(cfg: ArchConfig) -> L.AttnDims:
    return L.AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def _repeats(tree, repeat: int) -> list:
    """A stage's tree for each repeat: views ``t[r]`` of a stacked stage,
    the tree itself for an unstacked one."""
    if repeat == 1:
        return [tree]
    return [tree_map(lambda t: t[r], tree) for r in range(repeat)]


def _write_back(dst, src) -> None:
    """Copy a repeat's new cache into its views of the stacked cache,
    skipping leaves that were already updated in place."""
    if isinstance(dst, dict):
        for k in dst:
            _write_back(dst[k], src[k])
    elif src.data_ptr() != dst.data_ptr():
        dst.copy_(src)


# --------------------------------------------------------------------------
# Per-block init / apply / cache dispatch
# --------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ArchConfig, kind: str, dtype,
               device) -> Params:
    norm_init = (L.layernorm_init if cfg.norm == "layernorm"
                 else L.rmsnorm_init)
    d = cfg.d_model
    if kind in _ATTN_KINDS:
        p = {"ln1": norm_init(d, dtype, device),
             "attn": L.attention_init(gen, _attn_dims(cfg), dtype, device,
                                      qk_norm=cfg.qk_norm),
             "ln2": norm_init(d, dtype, device)}
        if kind == "moe":
            p["moe"] = MOE.moe_init(gen, cfg.moe, dtype, device)
        else:
            d_ff = ((cfg.moe_dense_ff or cfg.d_ff) if kind == "dense"
                    else cfg.d_ff)
            p["mlp"] = L.mlp_init(gen, d, d_ff, cfg.mlp_kind, dtype, device)
        return p
    if kind == "mla":
        return {"ln1": norm_init(d, dtype, device),
                "attn": MLA.mla_init(gen, cfg.mla, dtype, device),
                "ln2": norm_init(d, dtype, device),
                "mlp": L.mlp_init(gen, d, cfg.d_ff, cfg.mlp_kind, dtype,
                                  device)}
    if kind == "rglru":
        return {"ln1": norm_init(d, dtype, device),
                "rec": RG.rglru_block_init(gen, cfg.rglru, dtype, device),
                "ln2": norm_init(d, dtype, device),
                "mlp": L.mlp_init(gen, d, cfg.d_ff, cfg.mlp_kind, dtype,
                                  device)}
    if kind == "mlstm":
        return {"ln1": norm_init(d, dtype, device),
                "cell": XL.mlstm_block_init(gen, cfg.xlstm, dtype, device)}
    if kind == "slstm":
        return {"cell": XL.slstm_block_init(gen, cfg.xlstm, dtype, device)}
    raise _unsupported(kind)


def _norm(cfg: ArchConfig, p: Params, x):
    if cfg.norm == "layernorm":
        return L.layernorm(p, x, cfg.norm_eps)
    return L.rmsnorm(p, x, cfg.norm_eps)


def block_apply(p: Params, x, cfg: ArchConfig, kind: str, *,
                positions=None, cache=None, kernel_impl: str = "hopper"):
    """Returns (x_out, aux, new_cache); aux is the MoE block's
    load-balancing loss, the float 0.0 for the other kinds (nothing to
    launch on a decode step). ``positions`` (the batch's, or None) reach
    the attention blocks' RoPE."""
    aux = 0.0
    if kind in _ATTN_KINDS:
        h, new_cache = L.attention_apply(
            p["attn"], _norm(cfg, p["ln1"], x), _attn_dims(cfg),
            positions=positions, rope_kind=cfg.rope_kind,
            mrope_sections=cfg.mrope_sections, rope_theta=cfg.rope_theta,
            causal=cfg.causal,
            window=cfg.attn_window if kind == "lattn" else None,
            cache=cache, norm_eps=cfg.norm_eps, kernel_impl=kernel_impl)
        x = x + h
        h2 = _norm(cfg, p["ln2"], x)
        if kind == "moe":
            y, aux = MOE.moe_apply(p["moe"], h2, cfg.moe)
        else:
            y = L.mlp_apply(p["mlp"], h2, cfg.mlp_kind)
        return x + y, aux, new_cache
    if kind == "mla":
        h, new_cache = MLA.mla_apply(
            p["attn"], _norm(cfg, p["ln1"], x), cfg.mla,
            positions=positions, cache=cache, rope_theta=cfg.rope_theta,
            norm_eps=cfg.norm_eps)
        x = x + h
        y = L.mlp_apply(p["mlp"], _norm(cfg, p["ln2"], x), cfg.mlp_kind)
        return x + y, aux, new_cache
    if kind == "rglru":
        h, new_cache = RG.rglru_block_apply(
            p["rec"], _norm(cfg, p["ln1"], x), cfg.rglru, cache=cache,
            kernel_impl=kernel_impl)
        x = x + h
        y = L.mlp_apply(p["mlp"], _norm(cfg, p["ln2"], x), cfg.mlp_kind)
        return x + y, aux, new_cache
    if kind == "mlstm":
        h, new_cache = XL.mlstm_block_apply(
            p["cell"], _norm(cfg, p["ln1"], x), cfg.xlstm, cache=cache,
            kernel_impl=kernel_impl)
        return x + h, aux, new_cache
    if kind == "slstm":
        h, new_cache = XL.slstm_block_apply(p["cell"], x, cfg.xlstm,
                                            cache=cache,
                                            kernel_impl=kernel_impl)
        return x + h, aux, new_cache
    raise _unsupported(kind)


def block_cache_init(cfg: ArchConfig, kind: str, batch: int, max_seq: int,
                     dtype, device) -> Params:
    # the recurrent caches are fp32 whatever dtype the attention caches take
    if (kind in _ATTN_KINDS or kind == "mla") and max_seq < 1:
        raise ValueError("an attention cache needs max_seq >= 1")
    if kind in _ATTN_KINDS:
        smax = (min(max_seq, cfg.attn_window or max_seq) if kind == "lattn"
                else max_seq)
        return L.attention_cache_init(batch, smax, _attn_dims(cfg), dtype,
                                      device)
    if kind == "mla":
        return MLA.mla_cache_init(batch, max_seq, cfg.mla, dtype, device)
    if kind == "rglru":
        return RG.rglru_cache_init(batch, cfg.rglru, torch.float32, device)
    if kind == "mlstm":
        return XL.mlstm_cache_init(batch, cfg.xlstm, torch.float32, device)
    if kind == "slstm":
        return XL.slstm_cache_init(batch, cfg.xlstm, torch.float32, device)
    raise _unsupported(kind)


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------

REMATS = ("none", "full", "dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> ckpt.CheckpointPolicy:
    """Keep the outputs of matrix products without batch dims, recompute
    the rest: ``dots_with_no_batch_dims_saveable``. A kernel launched
    through ctypes is no aten op, so it is recomputed."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, remat: str):
    """Activation-checkpoint policies: none | full | dots. A checkpointed
    unit runs its forward again in the backward, kernels included."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    return functools.partial(
        ckpt.checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots))


class Model:
    """``kernel_impl="hopper"`` runs each kernel of the path on a CUDA
    tensor and its plain version on a CPU tensor; ``"plain"`` runs the
    plain versions on any device. ``remat`` is one of ``REMATS``."""

    def __init__(self, cfg: ArchConfig, kernel_impl: str = "hopper",
                 remat: str = "none"):
        if kernel_impl not in KERNEL_IMPLS:
            raise ValueError(f"kernel_impl must be one of {KERNEL_IMPLS}")
        if remat not in REMATS:
            raise ValueError(f"unknown remat policy {remat!r}")
        for pattern, _ in cfg.stages:
            for kind in pattern:
                if kind not in _KINDS:
                    raise _unsupported(kind)
        self.cfg = cfg
        self.kernel_impl = kernel_impl
        self.remat = remat

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
        if cfg.frontend == "audio":
            # the embedding table above is unused here, as in the reference
            p["frontend"] = {
                "proj": L._he(generator, (cfg.frontend_dim, cfg.d_model),
                              cfg.frontend_dim ** -0.5, dtype, dev),
                "convpos": L.convpos_init(generator, cfg.d_model,
                                          dtype=dtype, device=dev)}
        p["final_norm"] = norm_init(cfg.d_model, dtype, dev)
        if not cfg.tie_embeddings:
            p["unembed"] = L.embedding_init(generator, cfg.vocab_size,
                                            cfg.d_model, dtype, dev)
        p["stages"] = []
        for pattern, repeat in cfg.stages:
            def unit(_pattern=pattern):
                return {f"b{bi}": block_init(generator, cfg, kind, dtype, dev)
                        for bi, kind in enumerate(_pattern)}
            p["stages"].append(unit() if repeat == 1
                               else _stack_filled(unit, repeat))
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

    def _frontend(self, params: Params, batch: dict) -> torch.Tensor:
        """Token embeddings; under the vision stub the batch's
        ``vision_embeds`` (B, P, d) replace the first P of them. Under the
        audio stub the batch's ``frames`` (B, S, frontend_dim), taken in
        the parameters' type, are projected to d and the conv positional
        encoding is added."""
        if self.cfg.frontend == "audio":
            fp = params["frontend"]
            x = batch["frames"].to(fp["proj"].dtype) @ fp["proj"]
            return x + L.convpos_apply(fp["convpos"], x)
        x = L.embed(params["embed"], batch["tokens"])
        if self.cfg.frontend == "vision" and "vision_embeds" in batch:
            ve = batch["vision_embeds"].to(x.dtype)
            x = torch.cat([ve, x[:, ve.shape[1]:]], 1)
        return x

    def apply(self, params: Params, batch: dict
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (logits fp32, aux_loss), aux the
        MoE blocks' load-balancing losses summed over every stage and
        repeat (0 without MoE blocks). The batch's ``positions`` ((B,S), or
        (3,B,S) under M-RoPE), when given, are where the attention blocks
        apply RoPE."""
        cfg = self.cfg
        x = self._frontend(params, batch)
        positions = batch.get("positions")
        aux = x.new_zeros((), dtype=torch.float32)
        for (pattern, repeat), sp in zip(cfg.stages, params["stages"]):
            def unit(xx, lp, _pattern=pattern):
                acc = 0.0
                for bi, kind in enumerate(_pattern):
                    xx, a, _ = block_apply(lp[f"b{bi}"], xx, cfg, kind,
                                           positions=positions,
                                           kernel_impl=self.kernel_impl)
                    acc = acc + a
                return xx, acc
            for lp in _repeats(sp, repeat):
                x, a = _maybe_remat(unit, self.remat)(x, lp)
                aux = aux + a
        return self._logits(params, x), aux

    def loss(self, params: Params, batch: dict
             ) -> tuple[torch.Tensor, dict]:
        """Mean next-token cross-entropy over the positions whose label is
        >= 0, plus the aux loss. Returns (total, {"ce", "aux"})."""
        logits, aux = self.apply(params, batch)
        labels = batch["labels"]
        logp = torch.log_softmax(logits, -1)
        nll = -logp.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
        mask = (labels >= 0).float()
        ce = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        return ce + aux, {"ce": ce, "aux": aux}

    # -- decode ---------------------------------------------------------------

    def init_cache(self, batch: int, max_seq: int = 0, *, device=None,
                   dtype=torch.bfloat16) -> list:
        """Per-block decode state, stacked like the parameters. The
        recurrent states are fp32; attention caches (MLA's latent ones too)
        take ``dtype`` and hold
        ``max_seq`` positions (``min(max_seq, attn_window)`` for local
        attention), as in the JAX package; a global cache past ``max_seq``
        keeps its first ``max_seq`` positions. The xLSTM state does not
        grow with ``max_seq``. An encoder-only config has none: it
        raises (:func:`check_decode_capable`)."""
        check_decode_capable(self.cfg)
        dev = resolve_device(device)
        caches = []
        for pattern, repeat in self.cfg.stages:
            def unit(_pattern=pattern):
                return {f"b{bi}": block_cache_init(self.cfg, kind, batch,
                                                   max_seq, dtype, dev)
                        for bi, kind in enumerate(_pattern)}
            caches.append(unit() if repeat == 1
                          else _stack_filled(unit, repeat))
        return caches

    @torch.no_grad()
    def decode_step(self, params: Params, cache: list,
                    tokens: torch.Tensor) -> tuple[torch.Tensor, list]:
        """One token for every sequence. tokens: (B, 1) int. Attention
        caches are written in place; a stacked stage's cache is updated in
        place in its stacked tensors and returned as it is. The MoE
        blocks' aux losses are dropped, as in the reference. An
        encoder-only config raises (:func:`check_decode_capable`)."""
        cfg = self.cfg
        check_decode_capable(cfg)
        x = L.embed(params["embed"], tokens)
        new_caches = []
        for (pattern, repeat), sp, sc in zip(cfg.stages, params["stages"],
                                             cache):
            for lp, lc in zip(_repeats(sp, repeat), _repeats(sc, repeat)):
                nc = {}
                for bi, kind in enumerate(pattern):
                    x, _, nc[f"b{bi}"] = block_apply(
                        lp[f"b{bi}"], x, cfg, kind, cache=lc[f"b{bi}"],
                        kernel_impl=self.kernel_impl)
                if repeat > 1:
                    _write_back(lc, nc)
            new_caches.append(nc if repeat == 1 else sc)
        return self._logits(params, x), new_caches

    def param_count(self) -> int:
        shapes = self.init(torch.Generator(), device="meta")
        return sum(t.numel() for t in leaves(shapes))


def _stack_filled(make_unit, repeat: int):
    """``repeat`` units from ``make_unit()`` stacked on a leading axis, as
    the JAX package stacks a stage for ``lax.scan``. The stacked tensors are
    allocated once and filled a unit at a time, so the peak is the stack
    plus one unit (a full-width stage would not fit twice)."""
    first = make_unit()
    stacked = tree_map(lambda t: t.new_empty((repeat, *t.shape)), first)
    for r in range(repeat):
        unit = first if r == 0 else make_unit()
        tree_map(lambda dst, src: dst[r].copy_(src), stacked, unit)
        del unit
    return stacked

