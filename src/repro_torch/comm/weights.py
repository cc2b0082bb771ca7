"""QLC-compressed weight wire for serving (paper §7: per-tensor-type
LUTs).

Each large layer-stack leaf is stored as block-32 e4m3 symbols packed
into QLC slots of exactly the leaf's largest chunk (zero escapes), plus
bf16 block scales. Leaves keep their leading group dim: the wire of
``params["groups"]["l0"]["mixer"]["wq"]`` is ``{"words": [G, n_chunks,
cap], "scales": [G, padded/32]}``, the reference's layout with words as
int32 bit patterns. Compression runs through K1 and opening through K2
(``repro_torch.kernels.ops``); on the CPU both use their plain versions.

The chunk-sharded open, ``channel()`` and the JSON manifest come with
the collectives slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import codec
from repro_torch.core.registry import CodecRegistry, registry_of
from repro_torch.kernels import ops
from repro_torch.quant import e4m3

CHUNK = 1024
MIN_COMPRESS_SIZE = 1 << 16      # per-group; leave norms etc. alone

#: registry name used when the leaf's path has no entry of its own.
DEFAULT_TYPE = "default"


@dataclasses.dataclass(frozen=True)
class LeafMeta:
    group_shape: Tuple[int, ...]   # shape of ONE group's slice
    dtype: torch.dtype
    n_symbols: int                 # per group
    n_chunks: int                  # per group
    capacity_words: int
    mode: str                      # qlc
    scheme_id: int = 0             # registry id of the leaf's codec


def _is_wire(node) -> bool:
    return isinstance(node, dict) and set(node) == {"words", "scales"}


@dataclasses.dataclass
class GroupWireCodec:
    """Static recipe + per-leaf codecs to open wired group params.

    Works on a whole wired tree (leaves keep their leading group dim) or
    on one group's slice inside the layer loop (group dim indexed away):
    leading dims are preserved either way.
    """
    meta: Dict[str, LeafMeta]
    registry: CodecRegistry

    def open_group(self, pg):
        def walk(node, prefix):
            if _is_wire(node):
                return self._decode(node, self.meta[prefix])
            if isinstance(node, dict):
                return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                        for k, v in node.items()}
            return node
        return walk(pg, "")

    def _decode_flat(self, wire, m: LeafMeta, n_chunks: int
                     ) -> torch.Tensor:
        """Decode a wire dict to flat values ``[*lead, n_chunks*CHUNK]``
        (before the slice to ``n_symbols``) through K2, emitting the
        leaf's dtype straight from the kernel when it is f32 or bf16."""
        tables = self.registry.by_id(m.scheme_id).tables
        padded = n_chunks * CHUNK
        main = wire["words"]
        lead = tuple(main.shape[:-2])
        g = math.prod(lead)
        scales = wire["scales"].reshape(lead + (-1,))[..., :padded // e4m3.BLOCK]
        out_dt = m.dtype if m.dtype in (torch.bfloat16, torch.float32) \
            else torch.float32
        return ops.decode_dequantize(
            main.reshape(g * n_chunks, m.capacity_words),
            scales.float().reshape(g * n_chunks, CHUNK // e4m3.BLOCK),
            tables, CHUNK, out_dtype=out_dt).reshape(lead + (padded,))

    def _decode(self, wire, m: LeafMeta) -> torch.Tensor:
        vals = self._decode_flat(wire, m, m.n_chunks)
        lead = tuple(vals.shape[:-1])
        out = vals[..., :m.n_symbols].reshape(lead + m.group_shape)
        return out.to(m.dtype)


def _eligible(leaf_shape) -> bool:
    if len(leaf_shape) < 2:
        return False
    return math.prod(leaf_shape[1:]) >= MIN_COMPRESS_SIZE


def _geometry(leaf_shape):
    g = leaf_shape[0]
    n = math.prod(leaf_shape[1:])
    padded = -(-n // CHUNK) * CHUNK           # CHUNK % BLOCK == 0
    return g, n, padded, padded // CHUNK


def _entry_for(registry: CodecRegistry, prefix: str):
    """Resolve a leaf path to its registry entry: the path itself, else
    ``"default"``, else the first entry."""
    entry = registry.get(prefix, default=DEFAULT_TYPE)
    if entry is None:
        entries = registry.entries()
        if not entries:
            raise KeyError("empty codec registry")
        entry = entries[0]
    return entry


def compress_groups(groups, tables) -> Tuple[Any, GroupWireCodec]:
    """Wire every eligible leaf of ``groups`` (serving launcher path).

    ``tables`` is a ``CodecTables`` or a ``CodecRegistry``; each leaf's
    codec resolves by the leaf's path, else ``"default"``, else the
    first entry. K1
    encodes every chunk into worst-case slots, the capacity becomes
    ``ceil(max(nbits) / 32)`` and the words are cut to it, which is
    bit-equal to encoding straight into the exact capacity. Scales are
    cast to bf16 with round-to-nearest-even.
    """
    registry = registry_of(tables)
    meta: Dict[str, LeafMeta] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in node.items()}
        leaf = node
        if not _eligible(leaf.shape):
            return leaf
        entry = _entry_for(registry, prefix)
        g, n, padded, n_chunks = _geometry(leaf.shape)
        flat = leaf.reshape(g, n)
        if padded != n:
            flat = F.pad(flat.float(), (0, padded - n))
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

    wired = walk(groups, "")
    return wired, GroupWireCodec(meta=meta, registry=registry)
