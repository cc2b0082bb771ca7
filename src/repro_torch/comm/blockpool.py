"""Digest-addressed pool of compressed cache blocks (serving tentpole).

The continuous-batching engine (``repro_torch.serving.scheduler``) keeps
every resident sequence's cold KV blocks in ONE global pool whose
capacity is measured in **compressed bytes** — blocks are QLC containers
(``repro_torch.comm.container``), so the capacity lever is exactly the
codec's compression ratio (lossless compression as serving memory
capacity).

Content addressing reuses the registry's digest trick
(``repro_torch.core.registry._tables_digest``): a block's address is the
sha256 of its container words plus its geometry salt. Two sequences
whose prompts share a prefix produce **bit-identical** containers for
every block fully inside the shared prefix (the cache content at token
*t* depends only on tokens ``<= t``), so ``put`` dedups them onto one
refcounted entry — prefix sharing with zero coordination. Blocks are
immutable; a sequence diverging past the shared prefix simply writes
NEW blocks under new digests while the shared entry's refcount keeps it
alive for the other sequences — copy-on-write without ever copying.

Pressure handling (graceful degradation, never OOM):

* zero-ref entries (finished sequences' blocks, kept as a reclaimable
  prefix cache) are dropped first, in LRU order;
* referenced entries spill to an unbounded host tier (``spill_host``,
  default) and are promoted back on access (``get`` counts the fetch);
* when a block can never fit — spill disabled, or the block alone
  exceeds capacity — :class:`PoolExhausted` is raised and the engine
  rejects that request with a typed error instead of corrupting its
  neighbours.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch


class PoolExhausted(RuntimeError):
    """The block pool cannot hold a block: device capacity is exhausted
    and host spill is disabled (or one block alone exceeds capacity).
    The serving engine turns this into a typed request rejection."""


class ArenaExhausted(RuntimeError):
    """The device block arena has no free slot. Callers fall back to
    the host-framed sync paging path (never a crash)."""


class ArenaStale(RuntimeError):
    """An arena slot's generation moved between a read being scheduled
    and its result being consumed — the slot was freed (and possibly
    rewritten) in between. Consuming the result would hand out stale
    container words, so the arena refuses with this typed error."""


class BlockArena:
    """Device-resident container arena: one fixed-geometry int32 (u32 bit
    patterns) buffer of ``n_slots`` x ``slot_words``, indexed by slot id,
    on ``device`` (the card unless the caller says otherwise).

    This is the HBM home of cold KV blocks under async paging
    (``repro_torch.serving``): container words are written once at
    eviction (``write`` — a device copy, no host round trip) and read
    back as device slices for the prefetch decode, K5
    (``kernels.ops.decode_block_async``). The host side keeps only a free
    list and a per-slot **generation counter**: every ``free`` bumps the
    slot's generation, so a decode scheduled against ``(slot, gen)``
    and consumed after the slot was reclaimed surfaces a typed
    :class:`ArenaStale` instead of silently decoding whatever block
    reused the slot.

    The arena does NOT know about digests or refcounts — the
    :class:`BlockPool` owns those and holds the arena view (slot + gen
    per entry), releasing slots when entries are reclaimed.
    """

    def __init__(self, n_slots: int, slot_words: int, device="cuda"):
        if n_slots < 1 or slot_words < 1:
            raise ValueError(f"bad arena geometry ({n_slots} slots x "
                             f"{slot_words} words)")
        from repro_torch.models.transformer import resolve_device
        self.n_slots = int(n_slots)
        self.slot_words = int(slot_words)
        self._buf = torch.zeros((self.n_slots, self.slot_words),
                                dtype=torch.int32,
                                device=resolve_device(device))
        self._free = list(range(self.n_slots - 1, -1, -1))
        self._gen = [0] * self.n_slots
        self._used_words = [0] * self.n_slots
        self.writes = 0
        self.reads = 0
        self.frees = 0
        self.stale_reads = 0

    @property
    def buffer(self):
        """The arena's device buffer ``int32 [n_slots, slot_words]`` —
        the prefetch kernel's source."""
        return self._buf

    def alloc(self) -> Tuple[int, int]:
        """Claim a free slot; returns ``(slot, generation)``."""
        if not self._free:
            raise ArenaExhausted(
                f"all {self.n_slots} arena slots are live")
        slot = self._free.pop()
        return slot, self._gen[slot]

    def write(self, slot: int, words) -> int:
        """Store one container's words into ``slot`` (a device copy on
        the current stream; ``words`` stays on device). Returns the
        slot's generation."""
        n = int(words.shape[0])
        if n > self.slot_words:
            raise ValueError(f"container of {n} words exceeds the "
                             f"{self.slot_words}-word arena slot")
        self._buf[slot, :n].copy_(words)
        self._used_words[slot] = n
        self.writes += 1
        return self._gen[slot]

    def read(self, slot: int, gen: int, n_words: Optional[int] = None):
        """Device slice (a view) of a slot's words, validated against
        the generation the caller allocated under."""
        self.check(slot, gen)
        self.reads += 1
        n = self._used_words[slot] if n_words is None else int(n_words)
        return self._buf[slot, :n]

    def check(self, slot: int, gen: int):
        """Raise :class:`ArenaStale` when ``slot`` was freed (and
        possibly reused) since generation ``gen``."""
        if self._gen[slot] != gen:
            self.stale_reads += 1
            raise ArenaStale(
                f"arena slot {slot} is at generation {self._gen[slot]}, "
                f"but the access was scheduled at generation {gen} — "
                "the block was evicted in between")

    def free(self, slot: int):
        """Return a slot to the free list and invalidate outstanding
        ``(slot, gen)`` references by bumping the generation."""
        if slot in self._free:
            raise ValueError(f"double free of arena slot {slot}")
        self._gen[slot] += 1
        self._used_words[slot] = 0
        self._free.append(slot)
        self.frees += 1

    def stats(self) -> Dict[str, int]:
        return {
            "n_slots": self.n_slots,
            "slot_words": self.slot_words,
            "live_slots": self.n_slots - len(self._free),
            "writes": self.writes,
            "reads": self.reads,
            "frees": self.frees,
            "stale_reads": self.stale_reads,
        }


def container_digest(container, *salt) -> str:
    """Content address of a container: sha256 over its words plus any
    geometry salt (layer key, block start, shapes, ...). Bit-identical
    containers — e.g. the same prompt-prefix block encoded by two
    different sequences — collide on purpose; that collision IS the
    prefix-sharing dedup."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(
        np.asarray(container, np.uint32)).tobytes())
    for s in salt:
        h.update(repr(s).encode())
    return h.hexdigest()[:32]


@dataclasses.dataclass
class _Entry:
    block: object            # duck-typed: .container u32 words, .wire_bytes
    wire_bytes: int
    refs: int
    tier: str                # "device" | "host"
    stamp: int               # LRU clock at last touch
    arena_slot: Optional[int] = None   # device-arena residency (async)
    arena_gen: int = 0


class BlockPool:
    """Refcounted, digest-addressed store of compressed blocks with a
    byte-measured device tier and an unbounded host spill tier.

    Blocks are duck-typed (anything with ``.container`` u32 words and
    an integer ``.wire_bytes`` — e.g.
    :class:`repro_torch.serving.kv_cache.KVBlock`) so the pool lives in
    ``comm`` without importing serving.
    """

    def __init__(self, capacity_bytes: int, *, spill_host: bool = True,
                 arena: Optional[BlockArena] = None):
        if capacity_bytes < 1:
            raise ValueError(f"capacity_bytes must be >= 1, got "
                             f"{capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self.spill_host = bool(spill_host)
        self.arena = arena
        self._entries: Dict[str, _Entry] = {}
        self._clock = 0
        # accounting
        self.resident_bytes = 0        # device tier
        self.host_bytes = 0
        self.logical_bytes = 0         # sum(refs * wire): the no-dedup cost
        self.referenced_bytes = 0      # unique bytes pinned by refs > 0
        self.peak_resident_bytes = 0
        self.peak_logical_bytes = 0
        self.peak_referenced_bytes = 0
        self.dedup_hits = 0
        self.spills = 0
        self.reclaims = 0
        self.host_fetches = 0
        self._unique_puts = 0
        self._unique_put_bytes = 0

    # ---- core ------------------------------------------------------------

    def digest_of(self, block) -> str:
        return container_digest(
            block.container, getattr(block, "layer", None),
            getattr(block, "start", None), getattr(block, "tokens", None),
            getattr(block, "shapes", None), getattr(block, "dtypes", None))

    def put(self, block) -> str:
        """Admit a block (or take another reference on an identical
        one). Returns its digest. Raises :class:`PoolExhausted` when it
        cannot be made resident."""
        digest = self.digest_of(block)
        e = self._entries.get(digest)
        if e is not None:
            # live entry OR zero-ref cache revival (a finished
            # sequence's block re-referenced by a shared-prefix request)
            self.dedup_hits += 1
            e.refs += 1
            if e.refs == 1:
                self._bump_referenced(e.wire_bytes)
            self._bump_logical(e.wire_bytes)
            self._touch(e)
            return digest
        wire = int(block.wire_bytes)
        if wire > self.capacity_bytes:
            raise PoolExhausted(
                f"block of {wire} compressed bytes exceeds the pool's "
                f"{self.capacity_bytes}-byte device capacity")
        self._make_room(wire)
        self._clock += 1
        self._entries[digest] = _Entry(block=block, wire_bytes=wire,
                                       refs=1, tier="device",
                                       stamp=self._clock)
        self.resident_bytes += wire
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       self.resident_bytes)
        self._bump_logical(wire)
        self._bump_referenced(wire)
        self._unique_puts += 1
        self._unique_put_bytes += wire
        return digest

    def get(self, digest: str):
        """The canonical block for a digest — promoted back to the
        device tier first if pressure spilled it to host (counted in
        ``host_fetches``)."""
        e = self._entries[digest]
        if e.tier == "host":
            self._make_room(e.wire_bytes)
            e.tier = "device"
            self.host_bytes -= e.wire_bytes
            self.resident_bytes += e.wire_bytes
            self.peak_resident_bytes = max(self.peak_resident_bytes,
                                           self.resident_bytes)
            self.host_fetches += 1
        self._touch(e)
        return e.block

    def release(self, digest: str):
        """Drop one reference. Zero-ref entries STAY cached (dropped
        lazily under pressure) so a later identical prompt prefix still
        dedups against them."""
        e = self._entries[digest]
        if e.refs <= 0:
            raise ValueError(f"release of unreferenced block {digest}")
        e.refs -= 1
        self.logical_bytes -= e.wire_bytes
        if e.refs == 0:
            self.referenced_bytes -= e.wire_bytes

    # ---- device-arena view (async paging) -------------------------------

    def attach_arena_slot(self, digest: str, slot: int, gen: int) -> bool:
        """Record that ``digest``'s container words live in the bound
        arena at ``(slot, gen)``. Returns False (caller should free its
        slot) when the entry already has one — the dedup twin of
        ``put``: two sequences framing the same prefix block keep ONE
        arena copy."""
        e = self._entries[digest]
        if e.arena_slot is not None:
            return False
        e.arena_slot, e.arena_gen = int(slot), int(gen)
        return True

    def _drop_arena_slot(self, e: _Entry):
        if e.arena_slot is not None and self.arena is not None:
            self.arena.free(e.arena_slot)
        e.arena_slot = None

    # ---- admission / pressure -------------------------------------------

    def check_admission(self, projected_bytes: int):
        """Raise :class:`PoolExhausted` when a request projected to pool
        ``projected_bytes`` of compressed blocks could never run to
        completion: with host spill the device tier degrades instead of
        filling, so admission always passes; without it the projection
        must fit next to the bytes pinned by running sequences."""
        if self.spill_host:
            return
        pinned = sum(e.wire_bytes for e in self._entries.values()
                     if e.refs > 0 and e.tier == "device")
        if int(projected_bytes) + pinned > self.capacity_bytes:
            raise PoolExhausted(
                f"projected {int(projected_bytes)} compressed bytes do "
                f"not fit: {pinned} already pinned of "
                f"{self.capacity_bytes} (spill_host=False)")

    def mean_block_bytes(self) -> float:
        """Measured mean compressed bytes per unique block (0.0 before
        the first put) — the engine's admission-projection unit."""
        if not self._unique_puts:
            return 0.0
        return self._unique_put_bytes / self._unique_puts

    def _touch(self, e: _Entry):
        self._clock += 1
        e.stamp = self._clock

    def _make_room(self, need: int):
        """Evict until ``need`` device bytes fit: zero-ref cache entries
        drop first (LRU), then referenced entries spill to host (LRU);
        raises :class:`PoolExhausted` when spill is disabled and only
        referenced entries remain."""
        while self.resident_bytes + need > self.capacity_bytes:
            victims = [(e.stamp, d) for d, e in self._entries.items()
                       if e.tier == "device"
                       and (e.refs == 0 or self.spill_host)]
            # zero-ref entries strictly before referenced spills
            free = [v for v in victims
                    if self._entries[v[1]].refs == 0]
            pick = min(free) if free else (min(victims) if victims
                                           else None)
            if pick is None:
                raise PoolExhausted(
                    f"need {need} compressed bytes but "
                    f"{self.resident_bytes} of {self.capacity_bytes} "
                    "are pinned by running sequences "
                    "(spill_host=False)")
            e = self._entries[pick[1]]
            if e.refs == 0:
                del self._entries[pick[1]]
                self._drop_arena_slot(e)
                self.resident_bytes -= e.wire_bytes
                self.reclaims += 1
            else:
                e.tier = "host"
                self.resident_bytes -= e.wire_bytes
                self.host_bytes += e.wire_bytes
                self.spills += 1

    def _bump_logical(self, wire: int):
        self.logical_bytes += wire
        self.peak_logical_bytes = max(self.peak_logical_bytes,
                                      self.logical_bytes)

    def _bump_referenced(self, wire: int):
        self.referenced_bytes += wire
        self.peak_referenced_bytes = max(self.peak_referenced_bytes,
                                         self.referenced_bytes)

    # ---- accounting ------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Byte-level accounting. ``peak_logical_bytes`` is what a pool
        WITHOUT digest dedup would have held at its high-water mark —
        ``peak_logical / peak_resident`` is the prefix-sharing win on
        top of the codec's compression ratio."""
        dev = [e for e in self._entries.values() if e.tier == "device"]
        host = [e for e in self._entries.values() if e.tier == "host"]
        return {
            "capacity_bytes": self.capacity_bytes,
            "resident_bytes": self.resident_bytes,
            "host_bytes": self.host_bytes,
            "resident_blocks": len(dev),
            "host_blocks": len(host),
            "logical_bytes": self.logical_bytes,
            "referenced_bytes": self.referenced_bytes,
            "peak_resident_bytes": self.peak_resident_bytes,
            "peak_logical_bytes": self.peak_logical_bytes,
            "peak_referenced_bytes": self.peak_referenced_bytes,
            "dedup_hits": self.dedup_hits,
            "spills": self.spills,
            "reclaims": self.reclaims,
            "host_fetches": self.host_fetches,
            "unique_blocks": self._unique_puts,
            "mean_block_bytes": self.mean_block_bytes(),
        }
