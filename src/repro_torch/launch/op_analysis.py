"""Roofline analyzer over the ATen ops one rank runs. Counterpart of
``repro/launch/hlo_analysis.py``.

The reference parses XLA's post-SPMD HLO text; PyTorch has no HLO, so
:class:`OpCounter` is a ``TorchDispatchMode`` that watches each ATen op as
it runs. Over DTensors it steps aside for the DTensor op itself and counts
the op DTensor then runs on this rank's local tensors, and the collectives
its redistributions issue: every count is per device, as the reference's
post-SPMD shapes are. DTensor's sharding propagation also runs ops of
its own: each new op once under a ``FakeTensorMode`` at the global shapes,
to infer the output's shape, and an op it shards through its
decomposition on ``meta`` tensors that carry a placement (``_spec``);
those calls are not the rank's work and are skipped. Only
the outermost op is counted: ops that run inside another op's
implementation (a collective's ``meta`` kernel) are its own. Eager mode
runs every loop body as often as it runs, so no trip count is recovered.
Kernels loaded through ctypes are no ATen op: a trace counts the plain
path, as the reference's HLO counts its jnp path.

It counts:

* FLOPs of the products and convolutions, by ``torch.utils.flop_counter``'s
  formulas (mm, bmm, addmm, baddbmm, convolutions and their backward) on
  the local shapes, split by the output's type;
* HBM bytes: operands plus result of every op that moves data. Views,
  metadata and allocation ops move none (``_SKIP_BYTES``); an op that
  reads or writes a slice counts the slice (``_sliced_op_bytes``): a
  gather, ``index_select``, ``embedding`` or advanced index at twice its
  output, a slice or select scatter at twice its update, an index put or
  scatter at three times its update (the reference's multipliers for
  dynamic-slice, dynamic-update-slice and scatter); ``copy_`` and fills at
  what they read and write;
* pure dtype casts (``_to_copy`` to a new type) again apart, as
  ``convert_bytes``;
* link bytes of each collective: an all-reduce at twice its input (the
  reduce-scatter and all-gather phases of a ring), an all-gather at its
  output, a reduce-scatter at its input, an all-to-all at the larger of its
  input and output, a send or a receive at its tensor;
* the peak of the bytes of live storages: each storage an op returns is
  counted until it is freed, plus what :meth:`OpCounter.hold` names (a
  step's arguments); and the peak once the donated arguments are given
  up (:meth:`OpCounter.donated_peak`).

:meth:`Roofline.seconds` turns the counts into times at one NVIDIA H100
SXM's published dense peaks: 989 TFLOP/s for bf16 and fp16 products, 67
TFLOP/s for fp32 (and any other type: the port turns TF32 off,
``device.py``), 3.35 TB/s of HBM, and 450 GB/s each way of NVLink for the
link term. NVLink joins the 8 cards of one host; a mesh axis of more than
8 ranks crosses hosts over a slower network, where the link term is a
lower bound. None of these is a measured time.
"""

from __future__ import annotations

import array
import dataclasses
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# one NVIDIA H100 SXM, dense peak rates: products by type, HBM, NVLink
# each way
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12}
PEAK_FLOPS_OTHER = 67e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9

aten = torch.ops.aten

_SKIP_BYTES = {
    aten.detach.default, aten.alias.default, aten.lift_fresh.default,
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten._local_scalar_dense.default,
    aten.sym_size.int, aten.sym_stride.int, aten.sym_numel.default,
    aten.is_same_size.default, aten.set_.source_Storage_storage_offset,
}

_WRITE_ONLY = {aten.fill_.Scalar, aten.fill_.Tensor, aten.zero_.default}

_GATHERS = {aten.index_select.default, aten.gather.default,
            aten.embedding.default, aten.index.Tensor}
_SLICE_SCATTERS = {aten.slice_scatter.default, aten.select_scatter.default}
_SCATTERS = {aten.index_put.default, aten.index_put_.default,
             aten._index_put_impl_.default, aten.scatter.src,
             aten.scatter_.src, aten.scatter.value, aten.scatter_.value,
             aten.scatter_add.default, aten.scatter_add_.default,
             aten.index_add.default, aten.index_add_.default,
             aten.index_copy.default, aten.index_copy_.default}

# collective op name -> kind; the op's local input and output come from
# _collective_io
_COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "_c10d_functional.broadcast": "broadcast",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "broadcast",
    "c10d.send": "send",
    "c10d.recv_": "recv",
}
_NO_WORK = {"_c10d_functional.wait_tensor",
            "_c10d_functional._wrap_tensor_autograd", "c10d.barrier"}


def _tensors(tree) -> list:
    """The tensors in nested tuples, lists, dicts and dataclasses (an op's
    arguments and results, a step's trees), a DTensor as its local
    tensor."""
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    return []


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _op_name(func) -> str:
    return f"{func.namespace}.{func._schema.name.split('::')[-1]}"


def _collective_io(name: str, args, out) -> tuple[int, int]:
    """(input bytes, output bytes) of a collective on this rank."""
    if name.startswith("c10d."):
        if name in ("c10d.allreduce_", "c10d.broadcast_", "c10d.send",
                    "c10d.recv_"):
            b = _nbytes(_tensors(args[0]))
            return b, b
        return _nbytes(_tensors(args[1])), _nbytes(_tensors(args[0]))
    return _nbytes(_tensors(args[0])), _nbytes(_tensors(out))


def _link_bytes(kind: str, in_b: int, out_b: int) -> int:
    if kind == "all-reduce":
        return 2 * in_b                 # RS + AG phases of the ring
    if kind in ("all-gather", "broadcast"):
        return out_b
    if kind == "reduce-scatter":
        return in_b
    if kind in ("send", "recv"):
        return in_b
    return max(in_b, out_b)              # all-to-all


def _sliced_op_bytes(func, args, kwargs, out) -> int | None:
    """HBM bytes of an op that touches only a slice of its operands: the
    slice, not the whole base tensor (see the module docstring)."""
    if func in _GATHERS:
        return 2 * _nbytes(_tensors(out))
    if func in _SLICE_SCATTERS:
        return 2 * _nbytes(_tensors(args[1]))
    if func in _SCATTERS:
        upd = _tensors((args, kwargs))[-1]     # values / src / index
        return 3 * _nbytes([upd])
    return None


@dataclasses.dataclass
class Roofline:
    flops: float = 0.0
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    hbm_bytes: float = 0.0
    link_bytes: float = 0.0
    convert_bytes: float = 0.0    # pure dtype casts, also in hbm_bytes
    collectives: dict = dataclasses.field(default_factory=dict)
    collective_calls: dict = dataclasses.field(default_factory=dict)
    ops: int = 0                  # ops counted (the outermost ones)
    peak_bytes: int = 0           # of live storages

    def seconds(self, chips: int) -> dict:
        """Times at one H100's peaks (module docstring); ``chips`` is
        kept for the reference's signature: every count is per device."""
        compute = sum(f / PEAK_FLOPS.get(getattr(torch, d),
                                          PEAK_FLOPS_OTHER)
                      for d, f in self.flops_by_dtype.items())
        return {"compute_s": compute,
                "memory_s": self.hbm_bytes / HBM_BW,
                "collective_s": self.link_bytes / NVLINK_BW}


class OpCounter(TorchDispatchMode):
    """Counts the ops run under it into :attr:`roof` (a
    :class:`Roofline`), following the live storages for
    :attr:`Roofline.peak_bytes` and :meth:`donated_peak`."""

    def __init__(self):
        super().__init__()
        self.roof = Roofline()
        self.dtensor_op = None          # the last op dispatched on DTensors
        self._depth = 0
        self._live = 0
        self._seen: set = set()         # ids of the live storages
        # live bytes after each op counted (entry 0: before the first)
        self._timeline = array.array("q", [0])
        self._donated: dict = {}        # storage id -> [bytes, last use]

    # -- live bytes ---------------------------------------------------------

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self._live -= n

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()         # one Python object a storage
        if id(s) in self._seen:
            return
        n = s.nbytes()
        self._seen.add(id(s))
        weakref.finalize(s, self._free, id(s), n)
        self._live += n
        self.roof.peak_bytes = max(self.roof.peak_bytes, self._live)

    def hold(self, tree, *, donate: bool = False) -> int:
        """Count the storages of ``tree``'s tensors as live (a step's
        arguments, made before the trace); returns their bytes.
        ``donate``: the step gives them up (the reference's
        ``donate_argnums``), see :meth:`donated_peak`."""
        tensors = _tensors(tree)
        for t in tensors:
            self._track(t)
            if donate:
                s = t.untyped_storage()
                self._donated[id(s)] = [s.nbytes(), 0]
        self._timeline[-1] = self._live
        return _nbytes(tensors)

    def donated_peak(self, returned=()) -> int:
        """The peak of live bytes had each donated storage been freed after
        the last op that read or wrote it, as XLA reuses a donated buffer
        once the step is done with it; a storage in ``returned`` (a
        step's results, a cache written in place) stays live. PyTorch has
        no donation: the step runs with its arguments held throughout
        (:attr:`Roofline.peak_bytes`), and this is the peak it would have
        with them given up."""
        kept = {id(t.untyped_storage()) for t in _tensors(returned)}
        freed = [0] * (len(self._timeline) + 1)
        for key, (n, last) in self._donated.items():
            if key not in kept:
                freed[last + 1] += n
        peak, gone = 0, 0
        for i, live in enumerate(self._timeline):
            gone += freed[i]
            peak = max(peak, live - gone)
        return peak

    # -- dispatch -------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self.dtensor_op = func
            return NotImplemented       # count the local op DTensor runs
        self._depth += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self._depth -= 1
        if self._depth == 0 and not any(
                isinstance(t, FakeTensor) or hasattr(t, "_spec")
                for t in _tensors((args, out))):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        r = self.roof
        name = _op_name(func)
        if name in _NO_WORK:
            return
        r.ops += 1
        for t in _tensors(out):
            self._track(t)
        self._timeline.append(self._live)
        if self._donated:
            for t in _tensors((args, kwargs, out)):
                use = self._donated.get(id(t.untyped_storage()))
                if use is not None:
                    use[1] = r.ops
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            in_b, out_b = _collective_io(name, args, out)
            link = _link_bytes(kind, in_b, out_b)
            r.link_bytes += link
            r.collectives[kind] = r.collectives.get(kind, 0) + link
            r.collective_calls[kind] = r.collective_calls.get(kind, 0) + 1
            r.hbm_bytes += in_b + out_b
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            dtype = str(_tensors(out)[0].dtype).removeprefix("torch.")
            r.flops += f
            r.flops_by_dtype[dtype] = r.flops_by_dtype.get(dtype, 0) + f
        if func.is_view or func in _SKIP_BYTES:
            return
        sliced = _sliced_op_bytes(func, args, kwargs, out)
        if sliced is not None:
            r.hbm_bytes += sliced
            return
        if func is aten.copy_.default:
            r.hbm_bytes += _nbytes(_tensors(args[:2]))
            return
        if func in _WRITE_ONLY:
            r.hbm_bytes += _nbytes(_tensors(out))
            return
        b = _nbytes(_tensors((args, kwargs))) + _nbytes(_tensors(out))
        r.hbm_bytes += b
        if func is aten._to_copy.default and "dtype" in kwargs \
                and kwargs["dtype"] != args[0].dtype:
            r.convert_bytes += b


def analyze(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under an :class:`OpCounter`; returns
    (result, :class:`Roofline`), the arguments' storages held live."""
    counter = OpCounter()
    with counter:
        counter.hold((args, kwargs))
        out = fn(*args, **kwargs)
    return out, counter.roof
