"""Per-tensor-type codec registry (paper §7: "multiple LUTs, one for
each tensor type ... obtained apriori").

A :class:`CodecRegistry` maps tensor-type names ("default", "params/ffn1",
...) to :class:`CodecEntry` records (scheme, calibrated tables, wire
plan) under a stable small integer scheme-id. The scheme-id is what goes
on the wire, so a payload decodes from its bytes plus the registry.

Construction is calibration-driven and deterministic: identical
histograms and scheme give bit-identical tables on every host, and
entries whose tables come out bit-identical share one scheme-id. The
JSON form is the reference package's (version 1): a registry written by
either package loads in the other with the same scheme-ids and
bit-identical tables, the same autotuned-transport cache and the same
measured link constants (``Channel.autotune``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import adapt
from repro_torch.core.lut import CodecTables, build_tables
from repro_torch.core.schemes import NUM_SYMBOLS, QLCScheme

REGISTRY_VERSION = 1

#: scheme-id is carried in a u32 header field / u8 manifest fields.
MAX_SCHEME_ID = 0xFFFF

#: Field names of the autotuned-transport cache key, in key order.
TRANSPORT_CACHE_KEY = ("scheme_id", "axis", "payload_bucket", "is_reduce")


def payload_bucket(payload_bytes: int) -> int:
    """Power-of-two bucket of a payload size (``ceil(log2(bytes))``): the
    autotune cache keys tuned transports by ``(scheme_id, axis,
    payload_bucket, is_reduce)``, one measurement per size class."""
    return max(0, int(payload_bytes) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class CodecEntry:
    """One tensor type's codec: scheme + tables + wire plan, under a
    stable integer id."""

    name: str
    scheme_id: int
    tables: CodecTables
    plan: "CommPlan"               # repro_torch.comm.planner.CommPlan
    counts: np.ndarray             # [256] calibration histogram

    @property
    def scheme(self) -> QLCScheme:
        return self.tables.scheme

    def config(self, **overrides) -> "CommConfig":
        """The entry's wire format as a ``CommConfig`` (kwargs override)."""
        from repro_torch.comm.compressed import CommConfig
        return CommConfig.from_plan(self.plan, **overrides)

    def expected_bits(self) -> float:
        return self.plan.expected_bits_per_symbol


def _tables_digest(tables: CodecTables) -> str:
    """Content digest of everything that affects coded bits."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(tables.enc_code).tobytes())
    h.update(np.ascontiguousarray(tables.enc_len).tobytes())
    h.update(np.ascontiguousarray(tables.dec_lut).tobytes())
    h.update(bytes([tables.prefix_bits]))
    return h.hexdigest()


def _tables_from_order(order: np.ndarray, scheme: QLCScheme) -> CodecTables:
    """Rebuild tables from a serialized symbol ranking (``order[rank] =
    symbol``) through a tie-free synthetic histogram that sorts to it."""
    order = np.asarray(order, dtype=np.int64)
    if sorted(order.tolist()) != list(range(NUM_SYMBOLS)):
        raise ValueError("order must be a permutation of 0..255")
    rank_of = np.empty(NUM_SYMBOLS, dtype=np.float64)
    rank_of[order] = np.arange(NUM_SYMBOLS, dtype=np.float64)
    return build_tables(NUM_SYMBOLS - rank_of, scheme)


class CodecRegistry:
    """Named per-tensor-type codecs with stable scheme-ids.

    Names are aliases: two names whose calibrated tables come out
    bit-identical share one scheme-id. Scheme-ids are assigned densely
    in registration order unless pinned via ``scheme_id=``.
    """

    def __init__(self):
        self._by_name: Dict[str, CodecEntry] = {}
        self._by_id: Dict[int, CodecEntry] = {}
        self._digest_to_id: Dict[str, int] = {}
        self._transport_cache: Dict[Tuple[int, str, int, bool],
                                    "TransportConfig"] = {}
        self._link_cache: Dict[str, Dict] = {}

    # ---- registration ----------------------------------------------------

    def register(self, name: str, counts: np.ndarray,
                 scheme: Optional[QLCScheme] = None, *,
                 chunk_symbols: int = 1024,
                 target_escape_prob: float = 1e-6,
                 allow_search: bool = False,
                 pool_slots_per_1k: int = 8,
                 scheme_id: Optional[int] = None) -> CodecEntry:
        """Calibrate and register a codec for one tensor type from the
        256-bin histogram of its e4m3 symbols. The scheme is selected
        (Table 1 vs Table 2, or searched) unless given."""
        from repro_torch.comm.planner import plan_for_tables
        counts = np.maximum(
            np.asarray(counts, dtype=np.float64).reshape(NUM_SYMBOLS), 1e-6)
        if scheme is None:
            scheme = adapt.select_scheme(
                counts, allow_search=allow_search).scheme
        tables = build_tables(counts, scheme)
        plan = plan_for_tables(tables, counts, chunk_symbols=chunk_symbols,
                               target_escape_prob=target_escape_prob,
                               pool_slots_per_1k=pool_slots_per_1k)
        return self.register_tables(name, tables, plan, counts=counts,
                                    scheme_id=scheme_id)

    def register_tables(self, name: str, tables: CodecTables,
                        plan: "CommPlan", *,
                        counts: Optional[np.ndarray] = None,
                        scheme_id: Optional[int] = None,
                        rebind: bool = False) -> CodecEntry:
        """Register pre-built tables + plan under ``name``. ``rebind``
        lets ``name`` move to this entry (the old entry keeps its id)."""
        if counts is None:
            counts = np.full(NUM_SYMBOLS, 1.0)
        digest = _tables_digest(tables)
        existing_id = self._digest_to_id.get(digest)
        if existing_id is not None and scheme_id in (None, existing_id):
            entry = self._by_id[existing_id]
            if (name in self._by_name
                    and self._by_name[name].scheme_id != existing_id
                    and not rebind):
                raise ValueError(
                    f"name {name!r} already bound to scheme-id "
                    f"{self._by_name[name].scheme_id}")
            self._by_name[name] = entry
            return entry
        if name in self._by_name and not rebind:
            raise ValueError(f"name {name!r} already registered with "
                             "different tables")
        sid = self._next_id() if scheme_id is None else int(scheme_id)
        if not (0 <= sid <= MAX_SCHEME_ID):
            raise ValueError(f"scheme_id {sid} out of range")
        if sid in self._by_id:
            raise ValueError(f"scheme_id {sid} already taken by "
                             f"{self._by_id[sid].name!r}")
        entry = CodecEntry(name=name, scheme_id=sid, tables=tables,
                           plan=plan, counts=np.asarray(counts, np.float64))
        self._by_name[name] = entry
        self._by_id[sid] = entry
        self._digest_to_id[digest] = sid
        return entry

    def register_revision(self, name: str, tables: CodecTables,
                          plan: "CommPlan", *,
                          counts: Optional[np.ndarray] = None
                          ) -> CodecEntry:
        """Register a recalibrated codec for ``name`` under a fresh
        scheme-id and rebind the name to it (the hot-swap of
        ``repro_torch.adaptive``). The previous entry keeps its id and is
        never mutated, so containers written under it still decode. The
        same tables and plan as the current binding are a no-op returning
        it; otherwise a new id is taken even when the tables equal
        another entry's, since a revision may change only the plan."""
        cur = self._by_name.get(name)
        if cur is None:
            return self.register_tables(name, tables, plan, counts=counts)
        if (_tables_digest(tables) == _tables_digest(cur.tables)
                and plan == cur.plan):
            return cur
        return self.register_tables(name, tables, plan, counts=counts,
                                    scheme_id=self._next_id(), rebind=True)

    def _next_id(self) -> int:
        return max(self._by_id, default=-1) + 1

    # ---- lookup ----------------------------------------------------------

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __len__(self) -> int:
        return len(self._by_id)

    def __getitem__(self, name: str) -> CodecEntry:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(
                f"no codec registered for tensor type {name!r}; "
                f"have {sorted(self._by_name)}") from None

    def get(self, name: str,
            default: Union[str, CodecEntry, None] = None
            ) -> Optional[CodecEntry]:
        """Entry for ``name``, else ``default`` (another registry key, or
        an already-resolved entry returned as-is)."""
        e = self._by_name.get(name)
        if e is None and default is not None:
            if isinstance(default, CodecEntry):
                return default
            e = self._by_name.get(default)
        return e

    def by_id(self, scheme_id: int) -> CodecEntry:
        try:
            return self._by_id[int(scheme_id)]
        except KeyError:
            raise KeyError(
                f"no codec with scheme-id {scheme_id}; "
                f"have {sorted(self._by_id)}") from None

    def names(self) -> List[str]:
        return sorted(self._by_name)

    def entries(self) -> List[CodecEntry]:
        """Distinct entries, ordered by scheme-id."""
        return [self._by_id[i] for i in sorted(self._by_id)]

    def tables_for(self, name: str) -> CodecTables:
        return self[name].tables

    def config_for(self, name: str, **overrides) -> "CommConfig":
        return self[name].config(**overrides)

    # ---- autotuned transport cache (Channel.autotune) --------------------

    def cache_transport(self, scheme_id: int, axis: str,
                        payload_bytes: int, transport: "TransportConfig",
                        *, is_reduce: bool = False):
        """Record an autotuned transport for ``(scheme_id, axis, payload
        bucket, is_reduce)``, overwriting any earlier tuning of the key.
        Reduce-scatter tunings are keyed apart: the one-shot RS pays a
        decode dispatch per rank that the gather does not."""
        from repro_torch.comm.planner import TransportConfig
        if not isinstance(transport, TransportConfig):
            raise TypeError(f"expected TransportConfig, got "
                            f"{type(transport).__name__}")
        key = (int(scheme_id), str(axis), payload_bucket(payload_bytes),
               bool(is_reduce))
        self._transport_cache[key] = transport

    def cached_transport(self, scheme_id: int, axis: str,
                         payload_bytes: int, *, is_reduce: bool = False
                         ) -> Optional["TransportConfig"]:
        """Tuned transport for the payload's size class, or ``None``."""
        return self._transport_cache.get(
            (int(scheme_id), str(axis), payload_bucket(payload_bytes),
             bool(is_reduce)))

    def transport_cache(self) -> Dict[Tuple[int, str, int, bool],
                                      "TransportConfig"]:
        """A copy of the tuning cache."""
        return dict(self._transport_cache)

    # ---- measured per-link-class constants (Channel.autotune) ------------

    def cache_link_constants(self, axis: str, link: str, *,
                             wire_Bps: float,
                             alpha_s: Optional[float] = None):
        """Record measured constants for one axis (a process group's
        name): its link class (``planner.LINK_CLASSES``), the measured
        per-hop wire rate and optionally the per-message latency."""
        from repro_torch.comm.planner import LINK_CLASSES
        if link not in LINK_CLASSES:
            raise ValueError(f"unknown link class {link!r}; "
                             f"valid classes: {LINK_CLASSES}")
        wire_Bps = float(wire_Bps)
        if not wire_Bps > 0:
            raise ValueError(f"wire_Bps must be positive, got {wire_Bps}")
        self._link_cache[str(axis)] = {
            "link": link, "wire_Bps": wire_Bps,
            "alpha_s": None if alpha_s is None else float(alpha_s)}

    def cached_link_constants(self, axis: str) -> Optional[Dict]:
        """``{"link", "wire_Bps", "alpha_s"}`` of ``axis``, or ``None``
        when it was never probed."""
        e = self._link_cache.get(str(axis))
        return None if e is None else dict(e)

    def link_cache(self) -> Dict[str, Dict]:
        """A copy of the per-axis link cache."""
        return {a: dict(e) for a, e in self._link_cache.items()}

    # ---- multi-LUT batched decode operands -------------------------------

    def stacked_decode_tables(
            self, scheme_ids: Optional[Sequence[int]] = None
            ) -> Tuple[List[CodecTables], np.ndarray]:
        """Decode-LUT operand set for multi-scheme batched decode.

        Returns ``(tables_list, id_map)``: ``tables_list[j]`` is the
        tables stacked at slot ``j`` and ``id_map[scheme_id] = j`` maps
        wire scheme-ids to slots (-1 for absent ids). With ``scheme_ids``
        given, only those schemes are stacked.
        """
        ids = sorted(self._by_id) if scheme_ids is None \
            else sorted(set(int(s) for s in scheme_ids))
        tables_list = [self._by_id[i].tables for i in ids]
        id_map = np.full(max(ids, default=0) + 1, -1, dtype=np.int32)
        for j, i in enumerate(ids):
            id_map[i] = j
        return tables_list, id_map

    # ---- (de)serialization ----------------------------------------------

    def to_json_dict(self) -> Dict:
        entries = []
        for entry in self.entries():
            aliases = sorted(n for n, e in self._by_name.items()
                             if e.scheme_id == entry.scheme_id)
            entries.append({
                "name": entry.name,
                "aliases": aliases,
                "scheme_id": entry.scheme_id,
                "areas": [list(a) for a in entry.scheme.areas],
                "prefix_bits": entry.scheme.prefix_bits,
                "order": entry.tables.dec_lut.astype(int).tolist(),
                "digest": _tables_digest(entry.tables),
                "counts": np.asarray(entry.counts, np.float64).tolist(),
                "plan": dataclasses.asdict(entry.plan),
            })
        out = {"version": REGISTRY_VERSION, "entries": entries}
        if self._transport_cache:
            out["transport_cache"] = [
                {"scheme_id": sid, "axis": axis, "bucket": bucket,
                 "is_reduce": red, "kind": t.kind,
                 "hop_chunks": t.hop_chunks}
                for (sid, axis, bucket, red), t
                in sorted(self._transport_cache.items())]
        if self._link_cache:
            out["link_cache"] = [
                {"axis": axis, **e}
                for axis, e in sorted(self._link_cache.items())]
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict())

    @classmethod
    def from_json_dict(cls, d: Dict) -> "CodecRegistry":
        if d.get("version") != REGISTRY_VERSION:
            raise ValueError(f"unsupported registry version "
                             f"{d.get('version')!r}")
        from repro_torch.comm.planner import CommPlan, TransportConfig
        reg = cls()
        for e in d["entries"]:
            scheme = QLCScheme(
                areas=tuple(tuple(a) for a in e["areas"]),
                prefix_bits=int(e["prefix_bits"]))
            counts = np.asarray(e["counts"], np.float64)
            tables = _tables_from_order(np.asarray(e["order"]), scheme)
            if e.get("digest") not in (None, _tables_digest(tables)):
                raise ValueError(
                    f"registry entry {e['name']!r}: rebuilt tables do "
                    "not match the recorded digest (corrupt registry?)")
            plan = CommPlan(**e["plan"])
            # Replayed in ascending scheme-id order, so a revised name
            # lands on its newest revision.
            entry = reg.register_tables(e["name"], tables, plan,
                                        counts=counts,
                                        scheme_id=int(e["scheme_id"]),
                                        rebind=True)
            for alias in e.get("aliases", []):
                reg._by_name[alias] = entry
        for c in d.get("transport_cache", []):
            reg._transport_cache[
                (int(c["scheme_id"]), str(c["axis"]), int(c["bucket"]),
                 bool(c.get("is_reduce", False)))] = TransportConfig(
                    kind=c["kind"], hop_chunks=int(c.get("hop_chunks", 1)))
        for c in d.get("link_cache", []):
            reg.cache_link_constants(c["axis"], c["link"],
                                     wire_Bps=c["wire_Bps"],
                                     alpha_s=c.get("alpha_s"))
        return reg

    @classmethod
    def from_json(cls, s: str) -> "CodecRegistry":
        return cls.from_json_dict(json.loads(s))

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json_dict(), f)

    @classmethod
    def load(cls, path: str) -> "CodecRegistry":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))


def registry_of(obj, name: str = "default") -> CodecRegistry:
    """Wrap bare ``CodecTables`` into a one-entry registry; pass a
    ``CodecRegistry`` through unchanged."""
    if isinstance(obj, CodecRegistry):
        return obj
    if isinstance(obj, CodecTables):
        from repro_torch.comm.planner import plan_for_tables
        reg = CodecRegistry()
        counts = np.full(NUM_SYMBOLS, 1.0)
        reg.register_tables(name, obj, plan_for_tables(obj, counts),
                            counts=counts)
        return reg
    raise TypeError(f"expected CodecRegistry or CodecTables, got "
                    f"{type(obj).__name__}")
