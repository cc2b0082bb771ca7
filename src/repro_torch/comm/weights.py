"""QLC-compressed weight wire for serving (paper §7: per-tensor-type
LUTs).

Each large layer-stack leaf is stored as block-32 e4m3 symbols plus bf16
block scales, in one of two modes:

* ``"qlc"``: the symbols packed into QLC slots of exactly the leaf's
  largest chunk (zero escapes): ``{"words": [G, n_chunks, cap],
  "scales": [G, padded/32]}``, words as int32 bit patterns. Compression
  runs through K1 and opening through K2 (``repro_torch.kernels.ops``);
  on the CPU both use their plain versions.
* ``"e4m3"``: the raw symbols, ``{"codes": u8 [G, n_chunks, 1024],
  "scales"}``, opened by the plain block-32 dequantize, as the
  reference's ``_decode_flat`` opens them outside any kernel.

Leaves keep their leading group dim, the reference's layout. Each leaf
records the scheme-id of its codec (:func:`compress_groups` resolves it
per tensor type), and :meth:`GroupWireCodec.manifest` carries the whole
recipe, registry and channel placement included, through JSON that
either package opens. :meth:`GroupWireCodec.open_group_sharded` opens a
wire whose leaves are chunk-sharded over a process group, streaming the
peers' shards one-shot or around the ring.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import codec
from repro_torch.core.registry import CodecRegistry, registry_of
from repro_torch.kernels import ops
from repro_torch.quant import e4m3

CHUNK = 1024
MIN_COMPRESS_SIZE = 1 << 16      # per-group; leave norms etc. alone

#: registry name used when no per-leaf type key resolves.
DEFAULT_TYPE = "default"

#: the wire's storage modes.
MODES = ("qlc", "e4m3")


@dataclasses.dataclass(frozen=True)
class LeafMeta:
    group_shape: Tuple[int, ...]   # shape of ONE group's slice
    dtype: torch.dtype
    n_symbols: int                 # per group
    n_chunks: int                  # per group
    capacity_words: int            # 0 in e4m3 mode
    mode: str                      # qlc | e4m3
    scheme_id: int = 0             # registry id of the leaf's codec


def _main_key(node) -> Optional[str]:
    """``"words"`` / ``"codes"`` when ``node`` is a wired leaf."""
    if isinstance(node, dict) and len(node) == 2 and "scales" in node:
        for key in ("words", "codes"):
            if key in node:
                return key
    return None


def _map_leaves(fn: Callable[[Any, str], Any], node, prefix: str = ""):
    """``fn(leaf, path)`` over a dict tree whose leaves are tensors or
    wired leaves (path ``"a/b/c"``), the tree's structure kept."""
    if _main_key(node) is not None or not isinstance(node, dict):
        return fn(node, prefix)
    return {k: _map_leaves(fn, v, f"{prefix}/{k}" if prefix else k)
            for k, v in node.items()}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _pack(main: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """One wired piece as ONE int32 message: the words (or the u8 codes,
    four to a word) then the bf16 scales as int16 pairs. Gloo and NCCL
    move the same bytes."""
    return torch.cat([main.contiguous().reshape(-1).view(torch.int32),
                      scales.contiguous().reshape(-1).view(torch.int32)])


def _unpack(buf: torch.Tensor, main_like: torch.Tensor,
            scales_like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n = main_like.numel() * main_like.element_size() // 4
    main = buf[:n].view(main_like.dtype).reshape(main_like.shape)
    scales = buf[n:].view(scales_like.dtype).reshape(scales_like.shape)
    return main, scales


@dataclasses.dataclass
class GroupWireCodec:
    """Static recipe + per-leaf codecs to open wired group params.

    Works on a whole wired tree (leaves keep their leading group dim) or
    on one group's slice inside the layer loop (group dim indexed away):
    leading dims are preserved either way.

    ``use_kernels`` is kept for the reference's manifest only: the port
    routes by device (K2 for QLC leaves on the card, its plain version
    on the CPU). ``transport`` (``None`` meaning ring) and ``axis`` are
    the chunk-sharded open's default placement; :meth:`channel` binds it
    as a :class:`~repro_torch.comm.channel.Channel`.
    """
    meta: Dict[str, LeafMeta]
    registry: CodecRegistry
    use_kernels: bool = False
    transport: Optional[Any] = None
    axis: Optional[str] = None

    def channel(self, axis_name: Optional[str] = None,
                axis_size: Optional[int] = None, *, transport=None,
                use_kernels: Optional[bool] = None):
        """This wire's placement as a ``Channel`` over the registry.

        Arguments default to the codec's recorded placement; an
        axis-bound channel with no recorded transport defaults to
        ``"ring"``, the sharded open's default. The axis's process group
        is that of mesh axis ``axis_name`` on the mesh in scope
        (``launch.mesh.use_mesh``); ``axis_size``, when given, must be
        its size. Without an axis the channel is local."""
        from repro_torch.comm.channel import Channel, ChannelSpec
        axis = axis_name if axis_name is not None else self.axis
        t = transport if transport is not None else self.transport
        if t is None and axis is not None:
            t = "ring"
        ch = Channel(ChannelSpec(
            codec=None, transport=t, axis=axis,
            use_kernels=(self.use_kernels if use_kernels is None
                         else use_kernels)), registry=self.registry)
        if axis_size is not None and ch.group is not None \
                and dist.get_world_size(ch.group) != int(axis_size):
            raise ValueError(f"axis_size {axis_size} != the group's "
                             f"{dist.get_world_size(ch.group)} ranks")
        return ch

    def _walk(self, pg, leaf_fn):
        meta = self.meta
        return _map_leaves(
            lambda node, path: node if _main_key(node) is None
            else leaf_fn(node, meta[path]), pg)

    def open_group(self, pg):
        return self._walk(pg, self._decode)

    def open_group_sharded(self, pg, axis_name: Optional[str] = None,
                           axis_size: Optional[int] = None, transport=None,
                           *, channel=None, group=None):
        """Open a wired tree whose compressed leaves are SHARDED along
        the chunk dim over a process group (:func:`shard_chunks` gives a
        rank its shard), on every rank of the group; a leaf the group
        holds whole (its chunks not divisible by the group's size) is
        opened on each rank.

        The group is ``group``, else the channel's, else that of mesh
        axis ``axis_name`` on the mesh in scope (the FSDP decode opens
        each layer group's wire over the data column). With the ring transport
        (the default) hop *k*'s shard is decoded (K2 for QLC leaves on
        the card) while hop *k+1*'s words are in flight; ``"oneshot"``
        all-gathers the whole wire first and decodes after. Both give
        values bit-identical to :meth:`open_group` on the whole tree
        (per-chunk decode is independent of batching). A channel's
        ``"auto"`` policy resolves per leaf from the shard's geometry."""
        from repro_torch.comm.channel import axis_group
        from repro_torch.comm.planner import resolve_transport
        if group is not None:
            pass
        elif channel is not None:
            group = channel.group
        else:
            group = None if axis_name is None else axis_group(axis_name)
        if group is None:
            raise ValueError("the sharded open needs a process group: a "
                             "bound Channel, or axis_name with a mesh in "
                             "scope")
        d = dist.get_world_size(group)
        if axis_size is not None and int(axis_size) != d:
            raise ValueError(f"axis_size {axis_size} != the group's {d} "
                             "ranks")
        t = None
        if channel is None or transport is not None:
            t = resolve_transport(transport if transport is not None
                                  else (self.transport or "ring"))
        return self._walk(pg, lambda w, m: self._decode_sharded(
            w, m, group, d, t, channel))

    def _decode_sharded(self, wire, m: LeafMeta, group, d: int, t,
                        channel) -> torch.Tensor:
        from repro_torch.comm.planner import clamp_hop_chunks
        from repro_torch.comm.transport import all_gather_flat, ring_stream
        key = _main_key(wire)
        main, scales = wire[key], wire["scales"]
        ncl = main.shape[-2]                     # local chunk shard
        if ncl == m.n_chunks and d > 1:
            return self._decode(wire, m)         # held whole (shard_chunks)
        if ncl * d != m.n_chunks:
            raise ValueError(f"leaf must be evenly chunk-sharded: {ncl} "
                             f"chunks x {d} ranks != {m.n_chunks}")
        if t is None:                # channel-bound transport, per leaf
            t = channel.resolved_transport(ncl * CHUNK, axis_size=d)
        if t.kind == "hierarchical":
            from repro_torch.comm.transport import _HIERARCHICAL
            raise NotImplementedError(_HIERARCHICAL)
        lead = tuple(main.shape[:-2])
        if t.kind == "oneshot":
            msg = _pack(main, scales)[None]
            gathered = torch.empty((d, msg.shape[1]), dtype=msg.dtype,
                                   device=msg.device)
            all_gather_flat(gathered, msg, group=group)
            parts = [_unpack(row, main, scales) for row in gathered]
            whole = {key: torch.cat([p[0] for p in parts], dim=-2),
                     "scales": torch.cat([p[1] for p in parts], dim=-1)}
            vals = self._decode_flat(whole, m, m.n_chunks)
        else:
            hp = clamp_hop_chunks(t.hop_chunks, ncl)
            npc = ncl // hp                       # chunks per piece
            piece = npc * CHUNK
            sb = piece // e4m3.BLOCK
            pieces = [(main[..., p * npc:(p + 1) * npc, :],
                       scales[..., p * sb:(p + 1) * sb]) for p in range(hp)]

            def consume(out, bufs, src):
                for p, buf in enumerate(bufs):
                    w, s = _unpack(buf, *pieces[p])
                    out[..., src, p, :] = self._decode_flat(
                        {key: w, "scales": s}, m, npc)
                return out

            out0 = torch.empty(lead + (d, hp, piece),
                               dtype=self._decode_dtype(m),
                               device=main.device)
            out = ring_stream([_pack(*pc) for pc in pieces], group, consume,
                              out0)
            vals = out.reshape(lead + (d * ncl * CHUNK,))
        out = vals[..., :m.n_symbols].reshape(lead + m.group_shape)
        return out.to(m.dtype)

    @staticmethod
    def _decode_dtype(m: LeafMeta) -> torch.dtype:
        """dtype :meth:`_decode_flat` emits for this leaf: K2 writes an
        f32 or bf16 leaf's own dtype; everything else opens in f32."""
        if m.mode == "qlc" and m.dtype in (torch.bfloat16, torch.float32):
            return m.dtype
        return torch.float32

    def _decode_flat(self, wire, m: LeafMeta, n_chunks: int
                     ) -> torch.Tensor:
        """Decode a (possibly chunk-sharded) wire dict to flat values
        ``[*lead, n_chunks*CHUNK]`` (before the slice to ``n_symbols``),
        in :meth:`_decode_dtype`. ``n_chunks`` is the chunk count of THIS
        wire dict."""
        padded = n_chunks * CHUNK
        main = wire[_main_key(wire)]
        lead = tuple(main.shape[:-2])
        scales = wire["scales"].reshape(lead + (-1,))[..., :padded // e4m3.BLOCK]
        if m.mode == "e4m3":
            return e4m3.dequantize_block32_pieces(
                main.reshape(lead + (padded,)), scales.float())
        tables = self.registry.by_id(m.scheme_id).tables
        g = math.prod(lead)
        return ops.decode_dequantize(
            main.reshape(g * n_chunks, m.capacity_words),
            scales.float().reshape(g * n_chunks, CHUNK // e4m3.BLOCK),
            tables, CHUNK, out_dtype=self._decode_dtype(m)
        ).reshape(lead + (padded,))

    def _decode(self, wire, m: LeafMeta) -> torch.Tensor:
        vals = self._decode_flat(wire, m, m.n_chunks)
        lead = tuple(vals.shape[:-1])
        out = vals[..., :m.n_symbols].reshape(lead + m.group_shape)
        return out.to(m.dtype)

    # ---- manifest (serving handoff) -------------------------------------

    def manifest(self) -> Dict:
        """JSON-able recipe, the reference's format: per-leaf geometry +
        scheme-ids, the registry itself, and the channel placement."""
        from repro_torch.comm.channel import transport_to_json
        leaves = {key: {"group_shape": list(m.group_shape),
                        "dtype": _dtype_name(m.dtype),
                        "n_symbols": m.n_symbols,
                        "n_chunks": m.n_chunks,
                        "capacity_words": m.capacity_words,
                        "mode": m.mode,
                        "scheme_id": m.scheme_id}
                  for key, m in self.meta.items()}
        return {"version": 1, "leaves": leaves,
                "registry": self.registry.to_json_dict(),
                "channel": {"transport": transport_to_json(self.transport),
                            "axis": self.axis,
                            "use_kernels": self.use_kernels}}

    @classmethod
    def from_manifest(cls, d: Dict, use_kernels: Optional[bool] = None
                      ) -> "GroupWireCodec":
        from repro_torch.comm.channel import transport_from_json
        registry = CodecRegistry.from_json_dict(d["registry"])
        meta = {key: LeafMeta(group_shape=tuple(lm["group_shape"]),
                              dtype=getattr(torch, lm["dtype"]),
                              n_symbols=int(lm["n_symbols"]),
                              n_chunks=int(lm["n_chunks"]),
                              capacity_words=int(lm["capacity_words"]),
                              mode=lm["mode"],
                              scheme_id=int(lm["scheme_id"]))
                for key, lm in d["leaves"].items()}
        ch = d.get("channel", {})
        if use_kernels is None:        # explicit arg beats the manifest
            use_kernels = bool(ch.get("use_kernels", False))
        return cls(meta=meta, registry=registry, use_kernels=use_kernels,
                   transport=transport_from_json(ch.get("transport")),
                   axis=ch.get("axis"))


def shard_chunks(wired, index: int, count: int):
    """Rank ``index`` of ``count``'s shard of a wired tree: every wired
    leaf whose chunks ``count`` divides cut to its ``index``-th
    contiguous run of chunks (words or codes along the chunk dim, scales
    along their last dim), every other leaf whole, as the reference's
    ``wire_axes`` cut a wire over the data axes: the input of
    :meth:`GroupWireCodec.open_group_sharded`, which opens a whole leaf
    on each rank."""
    def cut(node, _path):
        key = _main_key(node)
        if key is None or node[key].shape[-2] % count:
            return node
        main, scales = node[key], node["scales"]
        ncl = main.shape[-2] // count
        sb = scales.shape[-1] // count
        return {key: main[..., index * ncl:(index + 1) * ncl, :]
                .contiguous(),
                "scales": scales[..., index * sb:(index + 1) * sb]
                .contiguous()}
    return _map_leaves(cut, wired)


def _eligible(leaf_shape) -> bool:
    if len(leaf_shape) < 2:
        return False
    return math.prod(leaf_shape[1:]) >= MIN_COMPRESS_SIZE


def _geometry(leaf_shape):
    g = leaf_shape[0]
    n = math.prod(leaf_shape[1:])
    padded = -(-n // CHUNK) * CHUNK           # CHUNK % BLOCK == 0
    return g, n, padded, padded // CHUNK


def _entry_for(registry: CodecRegistry, prefix: str,
               type_key_fn: Optional[Callable[[str], str]] = None):
    """Resolve a leaf path to its registry entry (per tensor type):
    ``type_key_fn(path)`` when it names an entry, else the path itself,
    else ``"default"``, else the first entry."""
    if type_key_fn is not None:
        name = type_key_fn(prefix)
        if name is not None and name in registry:
            return registry[name]
    entry = registry.get(prefix, default=DEFAULT_TYPE)
    if entry is None:
        entries = registry.entries()
        if not entries:
            raise KeyError("empty codec registry")
        entry = entries[0]
    return entry


def _check_mode(mode: str):
    if mode not in MODES:
        raise ValueError(f"wire mode must be one of {MODES}, got {mode!r}")


def compress_groups(groups, tables, mode: str = "qlc",
                    use_kernels: bool = False,
                    type_key_fn: Optional[Callable[[str], str]] = None,
                    whole_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
                    column=None, data_dims: Optional[Dict[str, int]] = None,
                    ) -> Tuple[Any, GroupWireCodec]:
    """Wire every eligible leaf of ``groups`` (serving launcher path).

    ``tables`` is a ``CodecTables`` or a ``CodecRegistry``; each leaf's
    codec resolves per tensor type (:func:`_entry_for`) and its
    scheme-id lands in the manifest. In ``"qlc"`` mode K1 encodes every
    chunk into worst-case slots, the capacity becomes ``ceil(max(nbits)
    / 32)`` and the words are cut to it, which is bit-equal to encoding
    straight into the exact capacity. In ``"e4m3"`` mode the symbols
    come from the plain block-32 quantize (the reference runs no kernel
    on this path either), equal to K1's. Scales are cast to bf16 with
    round-to-nearest-even. ``use_kernels`` is recorded, not routed on.
    ``whole_shapes`` (leaf path -> shape): the whole model's shapes when
    ``groups`` is one model rank's local tree, so that it wires the
    leaves the whole tree's wire would (their blocks), not those its
    own smaller blocks would. ``column`` (a ``launch.mesh.DataColumn``)
    with ``data_dims`` (leaf path -> FSDP dim): ``groups`` holds FSDP
    blocks; each wired leaf's blocks are gathered over the column into
    its model block, which is wired as above and cut by chunks to this
    rank's shard (:func:`shard_chunks`) before the next leaf, so the
    column holds the model-block wire once, as the reference's wire lies
    over its data axes.
    """
    from repro_torch.launch.mesh import gather_blocks
    _check_mode(mode)
    registry = registry_of(tables)
    meta: Dict[str, LeafMeta] = {}

    def wire(leaf, prefix):
        shape = leaf.shape if whole_shapes is None else whole_shapes[prefix]
        if not _eligible(shape):
            return leaf
        if column is None:
            return wire_block(leaf, prefix)
        dim = (data_dims or {}).get(prefix)
        block = leaf if dim is None else gather_blocks(leaf, dim, column)
        return shard_chunks(wire_block(block, prefix), column.index,
                            column.size)

    def wire_block(leaf, prefix):
        entry = _entry_for(registry, prefix, type_key_fn)
        g, n, padded, n_chunks = _geometry(leaf.shape)
        flat = leaf.reshape(g, n)
        if padded != n:
            flat = F.pad(flat.float(), (0, padded - n))
        if mode == "e4m3":
            codes, scales = e4m3.quantize_block32_pieces(flat.float())
            meta[prefix] = LeafMeta(tuple(leaf.shape[1:]), leaf.dtype, n,
                                    n_chunks, 0, "e4m3", entry.scheme_id)
            return {"codes": codes.reshape(g, n_chunks, CHUNK),
                    "scales": scales.to(torch.bfloat16)}
        words, nbits, scales = ops.quantize_encode(
            flat.reshape(g * n_chunks, CHUNK), entry.tables,
            codec.worst_case_words(CHUNK))
        cap = -(-int(nbits.max()) // 32)          # exact: 0 escapes
        words = words[:, :cap].contiguous()
        meta[prefix] = LeafMeta(tuple(leaf.shape[1:]), leaf.dtype, n,
                                n_chunks, cap, "qlc", entry.scheme_id)
        return {"words": words.reshape(g, n_chunks, cap),
                "scales": scales.reshape(g, padded // e4m3.BLOCK)
                .to(torch.bfloat16)}

    wired = _map_leaves(wire, groups)
    return wired, GroupWireCodec(meta=meta, registry=registry,
                                 use_kernels=use_kernels)


def wire_shape_structs(group_shapes, tables,
                       capacity_words: Union[int, Dict[str, int]],
                       mode: str = "qlc",
                       type_key_fn: Optional[Callable[[str], str]] = None,
                       whole_shapes: Optional[Dict[str, Tuple[int, ...]]]
                       = None):
    """Dry-run path: the wired tree's shapes and dtypes as ``meta``
    tensors (no data), for a tree of anything with ``.shape`` and
    ``.dtype``. ``capacity_words`` comes from the planner, or maps each
    leaf's path to its slot (a real wire's, :func:`wire_capacities`);
    ``whole_shapes`` as :func:`compress_groups`. The reference's GSPMD
    sharding annotations have no counterpart here: a rank's chunks of
    the wire over the data axes are :func:`shard_chunks`'s."""
    _check_mode(mode)
    registry = registry_of(tables)
    meta: Dict[str, LeafMeta] = {}

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def shape_struct(leaf, prefix):
        if not _eligible(leaf.shape if whole_shapes is None
                         else whole_shapes[prefix]):
            return leaf
        entry = _entry_for(registry, prefix, type_key_fn)
        g, n, padded, n_chunks = _geometry(tuple(leaf.shape))
        scales = empty((g, padded // e4m3.BLOCK), torch.bfloat16)
        cap = 0 if mode == "e4m3" else (
            capacity_words[prefix] if isinstance(capacity_words, dict)
            else capacity_words)
        meta[prefix] = LeafMeta(tuple(leaf.shape[1:]), leaf.dtype, n,
                                n_chunks, cap, mode, entry.scheme_id)
        if mode == "e4m3":
            return {"codes": empty((g, n_chunks, CHUNK), torch.uint8),
                    "scales": scales}
        return {"words": empty((g, n_chunks, cap), torch.int32),
                "scales": scales}

    wired = _map_leaves(shape_struct, group_shapes)
    return wired, GroupWireCodec(meta=meta, registry=registry)


def wire_capacities(wired) -> Dict[str, int]:
    """Each QLC-wired leaf's slot in words, by path: the map
    :func:`wire_shape_structs` takes to shape a real wire."""
    caps: Dict[str, int] = {}

    def visit(node, prefix):
        if _main_key(node) == "words":
            caps[prefix] = int(node["words"].shape[-1])
        return node

    _map_leaves(visit, wired)
    return caps
