"""Count what a region of eager PyTorch does: the port's counterpart of
the reference's loop-aware HLO walk (``repro.roofline.hlo_walk``).

:func:`count` is a ``TorchDispatchMode``; every aten op that runs inside
it, in the forward pass, in a checkpointed block's recompute and in the
backward pass alike, lands in one :class:`OpRecord`:

- ``flops``: each product's FLOPs (``torch.utils.flop_counter``'s
  formulas: mm, addmm, bmm, baddbmm, convolutions, attention), by the
  dtype of its operands, since an f32 product runs at a fraction of the
  bf16 rate (``roofline.hw``). A Python loop is counted once per trip,
  as it runs.
- ``bytes``: first-order HBM traffic, each op's inputs read once plus
  its outputs written once; views move nothing. An eager program does
  write each op's output to HBM and read it back in the next op, so the
  model is closer here than for XLA's fused HLO, where it counts only
  the inputs and outputs of a fusion; it still ignores what the L2
  cache keeps between ops and what a kernel reads twice.
- ``coll``: every ``torch.distributed`` collective (a ``c10d`` op) by
  kind, the bytes of the result that lands on this rank, the convention
  of ``hlo_walk``'s collective parse (an all-gather's whole output, a
  reduce-scatter's segment, an all-reduce's tensor), and the calls.
- ``peak_bytes``: the most storage bytes live at once, each op's new
  output storage counted from its creation to its release, on top of
  the tensors given as ``live`` (parameters, optimizer state, batch).
- Each ``kernels.ops`` entry (K1–K6 and their forms) as one op whose
  bytes are :func:`kernel_bytes`: its inputs read once plus its outputs
  written once, the figure whatever implements it, CUDA kernel or plain
  version. On fake tensors (``FakeTensorMode``) the entry returns empty
  outputs of the right shapes and dtypes and neither runs the plain
  version nor builds or launches the kernel (:func:`counted_kernel`).
  That path raises for a real tensor, so it never stands in for a
  launch on real data.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

#: The kernel behind each ``kernels.ops`` entry.
KERNEL_OF = {
    "quantize_encode": "K1",
    "decode_dequantize": "K2",
    "decode_dequantize_accumulate": "K2",
    "encode": "K3",
    "decode": "K4",
    "decode_block_async": "K5",
    "histogram": "K6",
}

#: c10d ops by the reference's HLO collective names.
_COLLECTIVE_KIND = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
    "send": "collective-permute",
    "recv_": "collective-permute",
}

#: aten ops that allocate or relabel memory and move no bytes.
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "_unsafe_view", "detach", "alias",
               "lift_fresh", "set_", "resize_"}


def _bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a broadcast dim counts once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _tensors(tree):
    """The tensors in an op's arguments or outputs: a tensor, or tuples,
    lists and dicts of them (one level of nesting is all aten uses)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for a in tree:
            if isinstance(a, torch.Tensor):
                yield a
            elif isinstance(a, (tuple, list, dict)):
                yield from _tensors(a)
    elif isinstance(tree, dict):
        yield from _tensors(tuple(tree.values()))


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


# --- the kernels' inputs and outputs ---------------------------------------

def _out_dtype(kw) -> torch.dtype:
    return kw.get("out_dtype", torch.float32)


def kernel_io(entry: str, *args, **kwargs
              ) -> Tuple[int, List[Tuple[Tuple[int, ...], torch.dtype]]]:
    """``(bytes read, [(shape, dtype) of each output])`` of the kernel
    behind ``kernels.ops.<entry>`` called with these arguments: each
    input read once (K2 reads its scales as f32 and one int32 scheme slot
    a chunk whether or not ids are given; K4 and K5 read ids only when
    given), the tables left out (at most a few KiB)."""
    if entry == "quantize_encode":
        x, _tables, cw = args[:3]
        n, k = x.shape
        outs = [((n, cw), torch.int32), ((n,), torch.int32),
                ((n, k // 32), torch.float32)]
        if kwargs.get("emit_codes"):
            outs.append(((n, k), torch.uint8))
        if kwargs.get("emit_hist"):
            outs.append(((256,), torch.int32))
        return _bytes(x), outs
    if entry in ("decode_dequantize", "decode_dequantize_accumulate"):
        acc = None
        if entry == "decode_dequantize_accumulate":
            acc, args = args[0], args[1:]
        words, scales, _tables, k = args[:4]
        n = words.shape[0]
        read = _bytes(words) + scales.numel() * 4 + n * 4
        if acc is not None:
            read += acc.numel() * 4
            return read, [((n, k), torch.float32)]
        return read, [((n, k), _out_dtype(kwargs))]
    if entry == "encode":
        sym, _tables, cw = args[:3]
        n = sym.shape[0]
        return _bytes(sym), [((n, cw), torch.int32), ((n,), torch.int32)]
    if entry in ("decode", "decode_block_async"):
        words, _tables, k = args[:3]
        n = words.shape[0]
        read = _bytes(words)
        if kwargs.get("scheme_ids") is not None:
            read += n * 4
        return read, [((n, k), torch.uint8)]
    if entry == "histogram":
        (sym,) = args[:1]
        return _bytes(sym), [((256,), torch.int32)]
    raise KeyError(f"no kernel behind kernels.ops.{entry}")


def kernel_bytes(entry: str, *args, **kwargs) -> int:
    """HBM bytes of the kernel behind ``kernels.ops.<entry>`` called with
    these arguments (tensors, or anything with ``shape`` and a torch
    ``dtype``): its inputs read once plus its outputs written once. The
    bound of every K1–K6 figure in ``chip_smoke.py`` and ``PERF.md``."""
    read, outs = kernel_io(entry, *args, **kwargs)
    return read + sum(_nbytes(s, d) for s, d in outs)


# --- the record ------------------------------------------------------------

@dataclasses.dataclass
class OpRecord:
    """What a counted region did on one rank. ``ops`` maps an op's name
    (``aten.mm``, ``c10d.allreduce_``, ``kernels.ops.quantize_encode``)
    to ``{"calls", "bytes", "flops": {dtype: FLOPs}}``; ``coll`` maps a
    collective kind to the bytes landing on the rank, ``coll_calls`` to
    its calls and ``coll_ranks`` to the calls over more than one rank;
    ``coll_groups`` maps a process group's name to its bytes, calls and
    ``shapes`` (``"<kind> <dtype> [dims]"`` of each result tensor -> its
    count; ``launch.mesh.Mesh`` names a mesh axis's group)."""
    ops: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    coll_ranks: Dict[str, int] = dataclasses.field(default_factory=dict)
    coll_groups: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    arg_bytes: int = 0
    peak_bytes: int = 0

    def _add(self, name: str, nbytes: float, flops=None, dtype=None):
        o = self.ops.setdefault(name, {"calls": 0, "bytes": 0, "flops": {}})
        o["calls"] += 1
        o["bytes"] += nbytes
        if flops:
            o["flops"][dtype] = o["flops"].get(dtype, 0) + flops

    @property
    def flops_by_dtype(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for o in self.ops.values():
            for d, f in o["flops"].items():
                out[d] = out.get(d, 0) + f
        return out

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def bytes(self) -> float:
        return float(sum(o["bytes"] for k, o in self.ops.items()
                         if not k.startswith("c10d.")))

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll.values()))

    def kernel_calls(self) -> Dict[str, int]:
        """Calls of each of K1–K6 (every kernel listed, 0 if not called)."""
        out = {k: 0 for k in sorted(set(KERNEL_OF.values()))}
        for entry, kname in KERNEL_OF.items():
            out[kname] += self.ops.get(f"kernels.ops.{entry}",
                                       {"calls": 0})["calls"]
        return out

    def kernel_bytes(self) -> Dict[str, float]:
        out = {k: 0 for k in sorted(set(KERNEL_OF.values()))}
        for entry, kname in KERNEL_OF.items():
            out[kname] += self.ops.get(f"kernels.ops.{entry}",
                                       {"bytes": 0})["bytes"]
        return out

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "OpRecord":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


class _Counter(TorchDispatchMode):
    """The dispatch mode behind :func:`count`."""

    def __init__(self):
        super().__init__()
        self.record = OpRecord()
        self._sizes: Dict[int, int] = {}
        self._live = 0
        self._quiet = False

    # storage lifetimes
    def _track(self, tree):
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = id(st)
            if key in self._sizes:
                continue
            self._sizes[key] = st.nbytes()
            self._live += self._sizes[key]
            self.record.peak_bytes = max(self.record.peak_bytes, self._live)
            weakref.finalize(st, self._release, key)

    def _release(self, key: int):
        self._live -= self._sizes.pop(key, 0)

    def seed(self, tree):
        """Count ``tree``'s storages as live from the start."""
        before = self._live
        self._track(tree)
        self.record.arg_bytes += self._live - before

    @contextlib.contextmanager
    def quiet(self):
        """Track storages made here, record no op."""
        self._quiet, was = True, self._quiet
        try:
            yield
        finally:
            self._quiet = was

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._track(out)
        if self._quiet:
            return out
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns == "c10d":
            self._collective(name, args)
        elif ns == "aten":
            self._aten(func, name, args, kwargs, out)
        return out

    def _collective(self, name: str, args):
        kind = _COLLECTIVE_KIND.get(name)
        if kind is None:                    # barrier, monitored barrier
            self.record._add(f"c10d.{name}", 0)
            return
        results = list(_tensors(args[0]))
        nb = sum(t.numel() * t.element_size() for t in results)
        r = self.record
        r._add(f"c10d.{name}", nb)
        r.coll[kind] = r.coll.get(kind, 0) + nb
        r.coll_calls[kind] = r.coll_calls.get(kind, 0) + 1
        pg = next((g for g in map(_group, args) if g is not None), None)
        if pg is not None and pg.size() > 1:
            r.coll_ranks[kind] = r.coll_ranks.get(kind, 0) + 1
        if pg is not None:
            g = r.coll_groups.setdefault(pg.group_name,
                                         {"bytes": 0, "calls": 0,
                                          "shapes": {}})
            g["bytes"] += nb
            g["calls"] += 1
            for t in results:
                key = (f"{kind} {str(t.dtype).replace('torch.', '')} "
                       f"{list(t.shape)}")
                g["shapes"][key] = g["shapes"].get(key, 0) + 1

    def _aten(self, func, name, args, kwargs, out):
        if _is_view(func) or name in _NO_TRAFFIC:
            self.record._add(f"aten.{name}", 0)
            return
        seen, nb = set(), 0
        for t in _tensors((args, kwargs)):
            if id(t) not in seen:
                seen.add(id(t))
                nb += _bytes(t)
        nb += sum(t.numel() * t.element_size() for t in _tensors(out))
        flops = dtype = None
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            dtype = str(next(_tensors(args)).dtype).replace("torch.", "")
        self.record._add(f"aten.{name}", nb, flops, dtype)


def _is_view(func) -> bool:
    """Whether an aten op returns a view of an input (its schema's return
    aliases an input without writing it)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _group(a):
    """The process group a c10d op was given (a boxed ``ProcessGroup``),
    else None."""
    if not isinstance(a, torch.ScriptObject) or not a._type(
            ).qualified_name().endswith("c10d.ProcessGroup"):
        return None
    from torch.distributed.distributed_c10d import ProcessGroup
    unbox = getattr(ProcessGroup, "unbox", None)
    return None if unbox is None else unbox(a)


@contextlib.contextmanager
def count(live: Any = None) -> Iterator[OpRecord]:
    """Record every op in the region into the yielded :class:`OpRecord`;
    ``live``: a pytree of tensors held from the start (their storages
    count toward the peak and ``arg_bytes``)."""
    mode = _Counter()
    if live is not None:
        mode.seed(live)
    with mode:
        yield mode.record


def _active() -> Optional[_Counter]:
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, _Counter):
            return m
    return None


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def counted_kernel(entry: str, *args, **kwargs):
    """The hook at the top of each ``kernels.ops`` entry: ``None`` outside
    :func:`count`, and inside it the entry's outputs as empty fake
    tensors, recorded as one op of :func:`kernel_bytes` bytes. Raises
    ``RuntimeError`` for a real tensor: a count never stands in for a
    launch on real data.

    A hook rather than ``torch.library.custom_op`` with a fake kernel:
    the entries take ``CodecTables`` and lists of them, which are not
    legal custom-op arguments, and a custom op would put a dispatcher
    hop in front of every real launch."""
    mode = _active()
    if mode is None:
        return None
    tensors = list(_tensors((args, kwargs)))
    real = [t for t in tensors if not _is_fake(t)]
    if real:
        raise RuntimeError(
            f"kernels.ops.{entry} got a real {real[0].device} tensor inside "
            "roofline.op_count.count(): the counted path returns empty "
            "outputs and runs on fake tensors only")
    read, outs = kernel_io(entry, *args, **kwargs)
    like = tensors[0]
    with mode.quiet():
        made = tuple(like.new_empty(s, dtype=d) for s, d in outs)
    mode.record._add(f"kernels.ops.{entry}",
                     read + sum(_nbytes(s, d) for s, d in outs))
    return made[0] if entry not in ("quantize_encode", "encode") else made
