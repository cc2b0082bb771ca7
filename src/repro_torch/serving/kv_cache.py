"""Compressed block-paged KV / SSM-state cache for decode-step serving.

The decode states of a resident sequence are paged a block of tokens at
a time:

    dense window ──evict──▶ byte (or e4m3) symbols ──QLC──▶
    self-describing container (cold block) ──decode on access──▶
    dense values the decode step attends over

* :class:`KVCacheSpec` declares the paging policy: tokens per block,
  symbol mode, codec prefix, chunk size, capacity policy.
* :class:`PagedKVCache` is the block codec. It encodes a completed
  block's state (an attention layer's K/V slice,
  ``models.attention.kv_block_slice``; a recurrent layer's whole carried
  state, ``models.ssm.state_snapshot``) through its layer's bound
  channel into a container and decodes it back, so the model only reads
  values that went through the wire.
* :class:`SSMBoundaryTracker` keeps each sequence's recurrent states at
  block boundaries, so that with ``KVCacheSpec.ssm_rebase`` a block's
  eviction encodes the state at its end boundary, which depends only on
  the tokens before it: requests sharing a prompt prefix of whole blocks
  give byte-identical snapshot containers, which the pool deduplicates.

Symbol modes (``comm.calibrate.kv_symbol_stream``): ``"qlc"`` (default,
lossless) codes the states' bytes, one container per byte plane, so
serving is token-identical to a dense cache; ``"e4m3"`` block-32
quantizes on eviction and codes the e4m3 symbols (lossy once, the
fp8-cache trade).

Two halves:

* **host framing (sync paging)**: the block is encoded on the card (K3)
  and framed there, the container goes to the host once
  (:meth:`PagedKVCache.encode_block_arrays`), and a decode uploads it
  once and decodes every coded section in one K4 launch
  (:meth:`PagedKVCache.decode_block_arrays`).
* **device framing (async paging)**: with the plan's fixed geometry
  (``exact_capacity=False``) every container header is known ahead, so
  :meth:`PagedKVCache.encode_block_device` frames the block on the card
  byte-identically to the host path, the words go to the
  ``BlockArena``, and :class:`BlockPrefetcher` decodes them through K5
  on a side CUDA stream, ordered after the arena write by an event and
  consumed after the next decode window through another.

Over a model row (``PagedKVCache(mesh=)``) the channels bind the group
of ``KVCacheSpec.axis``; the codecs are calibrated on the row's gathered
first prefill (:func:`calibrate_cache` with the mesh: identical on every
rank), each rank pages the blocks of its own part of the decode states
(its KV heads, or under a sequence split its range of positions, in
blocks whole on each rank: ``serving.scheduler.Engine`` rounds
``max_seq_len`` so), and a cold block's container words migrate over
the axis (:meth:`PagedKVCache.block_wire`, :func:`all_gather_block_wire`).

Escape-pool overflow never corrupts a block: an overflowing encode
falls back to a raw container (``stats()["overflow_sections"]``), and a
coded container whose pool overflowed raises
:class:`KVCacheOverflowError` at decode. An MoE model pages like a dense
one: its FFNs hold no decode state. Entry points run on the card unless
``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm import container as qc
from repro_torch.comm.blockpool import BlockArena
from repro_torch.comm.calibrate import (_layer_index, byte_planes,
                                        calibrate_kv_entries,
                                        kv_symbol_stream)
from repro_torch.comm.compressed import (WirePayload, _compress_codes,
                                         _decompress_codes, _quantize,
                                         pad_to_multiple)
from repro_torch.configs.base import ModelConfig
from repro_torch.core import codec as _codec
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.transformer import resolve_device


class KVCacheOverflowError(RuntimeError):
    """A coded cache block's escape pool overflowed — decoding it would
    silently corrupt the cache, so the paged cache refuses."""


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Paging policy of a :class:`PagedKVCache`.

    ``block_tokens``: tokens per cold block (the encode/evict unit).
    ``hot_blocks``: extra completed blocks kept dense behind the write
    head. ``mode``: ``"qlc"`` (lossless byte symbols) or ``"e4m3"``.
    ``use_kernels``: kept for the reference's JSON and manifests; the
    kernels run wherever the states are on the card. ``codec_prefix``:
    layer *i*'s codecs are ``f"{codec_prefix}/layer{i}..."``.
    ``chunk_symbols``: KV codec chunk size. ``exact_capacity``: size
    each block's slots from its own longest chunk (zero escapes); False
    uses the calibrated plan capacity + escape pool, which async paging
    needs. ``ssm_rebase``: a recurrent layer's eviction of block ``[t0,
    t1)`` encodes its state at boundary ``t1`` rather than the live
    state (:class:`SSMBoundaryTracker`); lossless (``"qlc"``) mode only,
    forced off under ``"e4m3"``, where the live state must round-trip
    the quantizer to stay the serving path's single source of truth.
    ``axis``: the mesh axis whose group a mesh-bound cache's channels
    bind (``PagedKVCache(mesh=)``), which cold blocks migrate over
    (:func:`all_gather_block_wire`).
    """
    block_tokens: int = 128
    hot_blocks: int = 0
    mode: str = "qlc"
    use_kernels: bool = False
    codec_prefix: str = "kv"
    chunk_symbols: int = 256
    exact_capacity: bool = True
    ssm_rebase: bool = True
    axis: Optional[str] = None

    def __post_init__(self):
        if self.block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got "
                             f"{self.block_tokens}")
        if self.mode not in ("qlc", "e4m3"):
            raise ValueError(f"unknown KV cache mode {self.mode!r}")
        if self.mode != "qlc" and self.ssm_rebase:
            object.__setattr__(self, "ssm_rebase", False)

    def layer_codec(self, i: int) -> str:
        return f"{self.codec_prefix}/layer{i}"

    def to_json(self) -> Dict:
        return {"block_tokens": self.block_tokens,
                "hot_blocks": self.hot_blocks,
                "mode": self.mode,
                "use_kernels": self.use_kernels,
                "codec_prefix": self.codec_prefix,
                "chunk_symbols": self.chunk_symbols,
                "exact_capacity": self.exact_capacity,
                "ssm_rebase": self.ssm_rebase,
                "axis": self.axis}

    @classmethod
    def from_json(cls, d: Dict) -> "KVCacheSpec":
        return cls(block_tokens=int(d["block_tokens"]),
                   hot_blocks=int(d.get("hot_blocks", 0)),
                   mode=d.get("mode", "qlc"),
                   use_kernels=bool(d.get("use_kernels", False)),
                   codec_prefix=d.get("codec_prefix", "kv"),
                   chunk_symbols=int(d.get("chunk_symbols", 256)),
                   exact_capacity=bool(d.get("exact_capacity", True)),
                   ssm_rebase=bool(d.get("ssm_rebase", True)),
                   axis=d.get("axis"))


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class KVBlock:
    """One cold block: a self-describing container (host numpy u32) plus
    the geometry to rebuild its tensors."""
    layer: str                      # state slot key ("l0", "l1", ...)
    start: int                      # first token of the block
    tokens: int                     # tokens covered
    container: np.ndarray           # uint32 container words
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]         # "bfloat16", "float32", ...
    coded: bool                     # any section QLC-coded

    @property
    def wire_bytes(self) -> int:
        return qc.container_bytes(self.container)

    @property
    def dense_bytes(self) -> int:
        return int(sum(math.prod(s) * _torch_dtype(d).itemsize
                       for s, d in zip(self.shapes, self.dtypes)))


# --------------------------------------------------------------------------
# Device-resident framing (async paging): static frame plans
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SectionPlan:
    """Static geometry of ONE container section of a layer's block under
    the plan config: the header is known ahead, so the decode slices the
    section out of the arena words at a fixed offset."""
    name: str                         # registry/channel name
    plane: Optional[Tuple[int, int]]  # (itemsize, byte) or None
    offset: int                       # word offset within the block
    header: qc.ContainerHeader
    cfg: Any                          # CommConfig of the wire form


@dataclasses.dataclass(frozen=True)
class LayerFramePlan:
    """Fixed container geometry of one layer's block; ``total_words``
    sizes the arena slot."""
    name: str
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    split: bool
    sections: Tuple[SectionPlan, ...]
    total_words: int


@dataclasses.dataclass
class DeviceBlock:
    """A block framed on the card: container words on the device (and,
    once written, in the ``BlockArena``)."""
    layer: str
    start: int
    tokens: int
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    plan: LayerFramePlan
    words: torch.Tensor             # int32 [plan.total_words], device
    coded: bool
    slot: Optional[int] = None      # arena slot once written
    gen: int = 0
    #: pinned host copy of ``words``, filled on the prefetch stream
    host_words: Optional[torch.Tensor] = None

    def host_block(self) -> KVBlock:
        """The host :class:`KVBlock` (pool accounting / digests). On the
        card, call after the prefetch was consumed: its copy to the host
        was issued at schedule time."""
        host = self.words if self.host_words is None else self.host_words
        return KVBlock(layer=self.layer, start=self.start,
                       tokens=self.tokens,
                       container=host.cpu().numpy().view(np.uint32),
                       shapes=self.shapes, dtypes=self.dtypes,
                       coded=self.coded)


def _unplane(planes, shapes, dtypes) -> List[torch.Tensor]:
    """Inverse of ``byte_planes``: {(itemsize, j): u8 plane} -> tensors."""
    mats, cursor = {}, {}
    for isz in sorted({_torch_dtype(d).itemsize for d in dtypes}):
        n = sum(math.prod(s) for s, d in zip(shapes, dtypes)
                if _torch_dtype(d).itemsize == isz)
        mats[isz] = torch.stack([planes[(isz, j)][:n] for j in range(isz)],
                                dim=1)
        cursor[isz] = 0
    out = []
    for s, d in zip(shapes, dtypes):
        dt = _torch_dtype(d)
        n = math.prod(s)
        c = cursor[dt.itemsize]
        cursor[dt.itemsize] = c + n
        out.append(mats[dt.itemsize][c:c + n].view(dt).reshape(s))
    return out


def _split_bytes(raw: torch.Tensor, shapes, dtypes) -> List[torch.Tensor]:
    """One interleaved byte stream -> tensors (copies, never views)."""
    out, pos = [], 0
    for s, d in zip(shapes, dtypes):
        dt = _torch_dtype(d)
        nb = math.prod(s) * dt.itemsize
        out.append(raw[pos:pos + nb].clone().view(dt).reshape(s))
        pos += nb
    return out


@dataclasses.dataclass
class PrefetchHandle:
    """One scheduled async block decode (schedule -> consume)."""
    block: DeviceBlock
    arrays: List[torch.Tensor]
    oks: Any                        # device bools (CPU) or pinned bools
    t_sched: float
    done: Optional[Any] = None      # torch.cuda.Event on the side stream


class BlockPrefetcher:
    """Schedule/consume tracking for async block decodes — overlap is
    measured here, not assumed.

    ``schedule`` issues a block's decode (K5 on the cache's side stream,
    after an event recorded on the current stream once the arena write
    was issued) and the copy of its words to pinned host memory, then
    records a done event. ``consume`` validates the result at its use
    point: the arena generation first (a block evicted in between raises
    ``ArenaStale``, never returns stale words), then whether the done
    event had already fired (hit) or had to be waited on (stall), then
    the escape-pool ok flags (:class:`KVCacheOverflowError`). The current
    stream waits on the done event, and the decoded tensors are recorded
    on it, so they are neither read early nor freed early. The cache is
    held through a weak proxy: the cache owns its prefetcher, and a
    strong reference back would keep both, with the arena, alive until
    the cycle collector ran."""

    def __init__(self, cache: "PagedKVCache"):
        self.cache = weakref.proxy(cache)
        self.scheduled = 0
        self.hits = 0
        self.stalled = 0
        self.misses = 0              # fell back to the host sync path
        self.bytes_prefetched = 0
        self.hidden_s = 0.0
        self.stall_s = 0.0

    def schedule(self, block: DeviceBlock) -> PrefetchHandle:
        cache = self.cache
        words = block.words
        if cache.arena is not None and block.slot is not None:
            words = cache.arena.read(block.slot, block.gen,
                                     n_words=block.words.shape[0])
        side = cache.side_stream()
        if side is None:
            arrays, oks = cache.decode_block_device(block.plan, words)
            done = None
        else:
            written = torch.cuda.Event()
            written.record()                 # after the arena write
            side.wait_event(written)
            with torch.cuda.stream(side):
                arrays, oks = cache.decode_block_device(block.plan, words)
                block.host_words = torch.empty(block.words.shape,
                                               dtype=torch.int32,
                                               pin_memory=True)
                block.host_words.copy_(block.words, non_blocking=True)
                ok_host = torch.ones(len(oks), dtype=torch.bool,
                                     pin_memory=True)
                if oks:
                    ok_host.copy_(torch.stack(oks), non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            for t in (words, block.words):
                t.record_stream(side)
            oks = ok_host
        self.scheduled += 1
        self.bytes_prefetched += int(block.words.shape[0]) * 4
        return PrefetchHandle(block=block, arrays=arrays, oks=oks,
                              t_sched=time.perf_counter(), done=done)

    def consume(self, handle: PrefetchHandle) -> List[torch.Tensor]:
        block = handle.block
        if self.cache.arena is not None and block.slot is not None:
            self.cache.arena.check(block.slot, block.gen)   # ArenaStale
        t0 = time.perf_counter()
        ready = handle.done is None or handle.done.query()
        if ready:
            self.hits += 1
        else:
            self.stalled += 1
        if handle.done is not None:
            handle.done.synchronize()
            current = torch.cuda.current_stream(handle.arrays[0].device)
            current.wait_event(handle.done)
            for a in handle.arrays:
                a.record_stream(current)
        t1 = time.perf_counter()
        self.stall_s += t1 - t0
        self.hidden_s += max(0.0, t0 - handle.t_sched)
        if not all(bool(ok) for ok in handle.oks):
            raise KVCacheOverflowError(
                f"block {block.layer}@{block.start}: escape pool overflow")
        return handle.arrays

    def miss(self):
        self.misses += 1

    def overlap_fraction(self) -> float:
        tot = self.hidden_s + self.stall_s
        return (self.hidden_s / tot) if tot > 0 else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "scheduled": self.scheduled,
            "hits": self.hits,
            "misses": self.misses,
            "stalled": self.stalled,
            "bytes_prefetched": self.bytes_prefetched,
            "hidden_ms": 1e3 * self.hidden_s,
            "stall_ms": 1e3 * self.stall_s,
            "overlap_fraction": self.overlap_fraction(),
        }


class SSMBoundaryTracker:
    """Per-slot block-boundary snapshots for segment-local SSM state
    re-basing (``KVCacheSpec.ssm_rebase``).

    The engine records each recurrent layer's state tensors whenever a
    sequence's absorbed-token count lands on a ``block_tokens`` boundary
    (during segmented prefill and between decode steps or windows).
    Eviction of block ``[t0, t1)`` then encodes the ``t1`` snapshot,
    whose bytes depend only on tokens ``< t1``, instead of the
    cumulative live state, so two requests sharing a prompt prefix give
    byte-identical snapshot containers, which dedup in the pool. The
    live state is never rewritten from a re-based snapshot: it has
    absorbed tokens past the boundary that the snapshot excludes."""

    def __init__(self):
        #: request -> boundary t -> {layer key: tuple of state tensors}
        self._by_seq: Dict[str, Dict[int, Dict[str, tuple]]] = {}

    def record(self, seq: str, t: int, layer_arrays: Dict[str, tuple]):
        self._by_seq.setdefault(seq, {})[t] = layer_arrays

    def take(self, seq: str, t: int) -> Optional[Dict[str, tuple]]:
        """Pop the boundary-``t`` snapshot and drop any older ones: a
        block's eviction retires every earlier boundary."""
        snaps = self._by_seq.get(seq)
        if snaps is None:
            return None
        out = snaps.pop(t, None)
        for older in [b for b in snaps if b < t]:
            del snaps[older]
        return out

    def drop(self, seq: str):
        self._by_seq.pop(seq, None)


def codec_wins(entry) -> bool:
    """Whether a calibrated KV entry beats the raw wire: a stream that
    calibrates to >= 8 expected bits/symbol, or to an escape bound so
    large the pool stops being an exception path, is wired raw."""
    plan = entry.plan
    return (plan.expected_bits_per_symbol < 8.0
            and plan.escape_prob_bound < 0.25)


def open_kv_channels(registry, mesh=None, *, prefix: str = "kv",
                     axis: Optional[str] = None,
                     use_kernels: Optional[bool] = None) -> Dict[str, Any]:
    """One channel per ``f"{prefix}/..."`` registry entry, bound to the
    group of ``mesh``'s ``axis`` (``comm.channel.axis_group``; with
    ``axis`` alone, the mesh in scope's), or local with neither."""
    from repro_torch.comm.channel import open_channels
    chans = open_channels(registry, mesh, axis=axis, use_kernels=use_kernels)
    return {n: c for n, c in chans.items() if n.startswith(prefix + "/")}


def all_gather_block_wire(words, channel) -> torch.Tensor:
    """Cross-rank cache migration: one cold block's container words from
    every rank of the channel's group, ``u32 [W] -> u32 [D, W]``, carried
    as the int32 bit pattern (``PagedKVCache.block_wire``) on the words'
    device. The compressed bytes are what cross the wire; each gathered
    row decodes on the receiver from the registry alone
    (:meth:`PagedKVCache.decode_block_arrays`).

    Block geometry must be the same on every rank, for the gather's
    shape: the same spec, the same calibrated plan, and
    ``KVCacheSpec(exact_capacity=False)``, whose plan capacity does not
    depend on the block."""
    if channel.axis is None:
        raise ValueError("cache migration needs a channel with a mesh "
                         "axis; pass KVCacheSpec(axis=...)")
    import torch.distributed as dist
    w = torch.as_tensor(np.asarray(words).view(np.int32)
                        if isinstance(words, np.ndarray) else words)
    w = w.reshape(-1).contiguous()
    rows = [torch.empty_like(w)
            for _ in range(dist.get_world_size(channel.group))]
    dist.all_gather(rows, w, group=channel.group)
    return torch.stack(rows)


class PagedKVCache:
    """Block codec of the paged compressed KV cache (see the module
    docstring). ``registry`` must already hold the per-layer entries
    (:func:`calibrate_cache`); ``channels`` defaults to
    :func:`open_kv_channels` over them. Decoded tensors land on
    ``device``.

    ``mesh`` (a ``launch.mesh.Mesh``): the channels bind the group of
    its ``spec.axis``, over which :meth:`block_wire` payloads migrate
    (:func:`all_gather_block_wire`); over a model row each rank pages
    the blocks of its own part of the decode states with the row's
    codecs (:func:`calibrate_cache` with the mesh). None: local
    channels.

    ``monitor`` (a ``repro_torch.adaptive.TrafficMonitor``): every
    section that :meth:`encode_block_arrays` encodes files its symbol
    histogram (K6 on the card, over the section's valid symbols), its
    escaped chunks, chunk count and pool overflow under the section's
    ``(name, scheme_id)``. A hot-swap reaches the cache through
    ``channels`` (wrap them in ``AdaptiveChannel``); old blocks keep
    decoding, their containers carry the old scheme-id."""

    def __init__(self, spec: KVCacheSpec, cfg: ModelConfig, registry,
                 channels: Optional[Dict[str, Any]] = None,
                 arena: Optional[BlockArena] = None, device="cuda",
                 monitor=None, mesh=None):
        self.spec = spec
        self.arena = arena
        self.cfg = cfg
        self.registry = registry
        self.monitor = monitor
        self.mesh = mesh
        self.device = resolve_device(device)
        self.kinds = cfg.layer_kinds()
        if channels is None:
            channels = open_kv_channels(
                registry, mesh, prefix=spec.codec_prefix,
                axis=spec.axis if mesh is not None else None,
                use_kernels=spec.use_kernels)
        self.channels = channels
        for i in range(len(self.kinds)):
            base = spec.layer_codec(i)
            if not any(n == base or n.startswith(base + "/")
                       for n in channels):
                raise KeyError(f"no channel for {base!r}; calibrate the "
                               "registry first (calibrate_cache)")
        self.overflow_sections = 0             # pool overflows (-> raw)
        self.raw_sections = 0                  # calibration said raw wins
        self._split_cache: Dict[str, bool] = {}
        self._plans: Dict[Tuple, LayerFramePlan] = {}
        self._side: Optional[torch.cuda.Stream] = None
        self.prefetcher = BlockPrefetcher(self)

    def side_stream(self):
        """The CUDA stream prefetch decodes run on (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    # ---- block codec (host framing: sync paging) -------------------------

    def encode_block_arrays(self, name: str, layer: str,
                            arrays: Sequence[torch.Tensor], *, start: int,
                            tokens: int) -> KVBlock:
        """Encode one block's tensors into a self-describing container
        through the layer's bound channel(s), on their device; the
        container comes to the host in one copy."""
        shapes = tuple(tuple(int(d) for d in a.shape) for a in arrays)
        dtypes = tuple(_dtype_name(a.dtype) for a in arrays)
        if self.spec.mode == "e4m3":
            ch = self.channels[name]
            flat = torch.cat([a.float().reshape(-1) for a in arrays])
            padded, n = pad_to_multiple(flat, ch.cfg.chunk_symbols)
            codes, scales = _quantize(padded, ch.cfg)
            words, coded = self._encode_section(name, codes, scales, n)
        elif self._plane_split(name):
            # One container per byte plane (a mixed-scheme stream).
            parts, coded = [], False
            for (isz, j), plane in byte_planes(arrays).items():
                pname = f"{name}/w{isz}b{j}"
                codes, n = pad_to_multiple(
                    plane, self.channels[pname].cfg.chunk_symbols)
                w, c = self._encode_section(pname, codes, None, n)
                parts.append(w)
                coded = coded or c
            words = torch.cat(parts)
        else:
            # tiny layer: one interleaved byte stream
            codes, n = pad_to_multiple(kv_symbol_stream(arrays, "qlc"),
                                       self.channels[name].cfg.chunk_symbols)
            words, coded = self._encode_section(name, codes, None, n)
        return KVBlock(layer=layer, start=start, tokens=tokens,
                       container=qc._host_words(words), shapes=shapes,
                       dtypes=dtypes, coded=coded)

    def _plane_split(self, base: str) -> bool:
        """Whether calibration chose per-plane codecs for this layer
        (recorded by which registry names exist)."""
        cached = self._split_cache.get(base)
        if cached is None:
            cached = any(n.startswith(base + "/w")
                         for n in self.registry.names())
            self._split_cache[base] = cached
        return cached

    def _encode_section(self, name: str, codes: torch.Tensor, scales,
                        n_valid: int) -> Tuple[torch.Tensor, bool]:
        """One symbol stream -> framed container words on its device. A
        section is coded only when that shrinks it: the calibration
        verdict (:func:`codec_wins`) first, then this block's slot
        capacity against the raw wire."""
        ch = self.channels[name]
        entry = self.registry[name]
        k = ch.cfg.chunk_symbols
        n_chunks = codes.numel() // k
        overflows0 = self.overflow_sections
        coded = codec_wins(entry)
        if coded:
            cfg = self._block_cfg(ch, codes)
            coded_words = (n_chunks * cfg.capacity_words
                           + cfg.pool_slots(n_chunks) * (k // 4))
            coded = coded_words < n_chunks * (k // 4)
        if coded:
            payload = _compress_codes(codes, ch.tables, cfg)
            coded, payload, cfg = self._overflow_fallback(
                payload, cfg, ch=ch, codes=codes)
        else:
            self.raw_sections += 1
            coded, payload, cfg = self._raw_wire(ch, codes)
        if self.monitor is not None:
            self._observe(name, entry.scheme_id, codes, n_valid, n_chunks,
                          payload if coded else None,
                          self.overflow_sections > overflows0)
        return qc.frame_block_device(
            payload, scales, scheme_id=entry.scheme_id, cfg=cfg,
            n_valid=n_valid, prefix_bits=entry.tables.prefix_bits), coded

    def _observe(self, name: str, scheme_id: int, codes: torch.Tensor,
                 n_valid: int, n_chunks: int,
                 payload: Optional[WirePayload], overflowed: bool):
        """File one section with the monitor: its valid symbols' counts
        and, when coded, its escaped chunks, in one device-to-host
        read."""
        counts = ops.histogram(codes.reshape(-1)[:n_valid])
        if payload is not None:
            escaped = payload.pool_count.reshape(-1).sum(dtype=torch.int32)
            counts = torch.cat([counts, escaped.reshape(1)])
        host = counts.cpu().numpy()
        self.monitor.observe(
            name, host[:256],
            escaped_chunks=float(host[256]) if payload is not None else 0.0,
            chunks=n_chunks, overflow=overflowed, containers=1.0,
            scheme_id=scheme_id)

    def _block_cfg(self, ch, codes: torch.Tensor):
        """Wire config of one coded block: with ``exact_capacity`` the
        slot is this block's longest chunk (zero escapes, one host read
        of the maximum); otherwise the calibrated plan capacity + pool."""
        if not self.spec.exact_capacity:
            return ch.cfg
        nbits = _codec.encode_chunk_bits(
            codes.reshape(-1, ch.cfg.chunk_symbols), ch.tables.enc_len)
        cap = max(1, -(-int(nbits.max()) // 32))
        return dataclasses.replace(ch.cfg, capacity_words=cap,
                                   pool_slots_per_1k=1)

    def _raw_wire(self, ch, codes: torch.Tensor):
        """Uncoded (``enabled=False``) wire form; the raw decode never
        reads the pool, so the container carries zero pool slots."""
        raw_cfg = dataclasses.replace(ch.cfg, enabled=False)
        payload = _compress_codes(codes, ch.tables, raw_cfg)
        payload = payload._replace(pool=payload.pool[..., :0, :])
        return False, payload, raw_cfg

    def _overflow_fallback(self, payload: WirePayload, cfg, *, ch, codes):
        """ok-check one encoded payload; on pool overflow re-wire the
        block raw instead of dropping escapes."""
        if int(payload.pool_count.reshape(-1)[0]) <= payload.pool.shape[-2]:
            return True, payload, cfg
        self.overflow_sections += 1
        return self._raw_wire(ch, codes)

    def decode_block_arrays(self, block: KVBlock,
                            prefetch: bool = False) -> List[torch.Tensor]:
        """Container stream -> the block's tensors on the cache's device,
        exactly as encoded (byte planes in ``"qlc"`` mode, dequantized
        e4m3 values in ``"e4m3"``). The container is uploaded once, and
        every coded section decodes in one launch (K4, or K5 with
        ``prefetch``, bit-identical). Raises :class:`KVCacheOverflowError` when a coded
        section's escape pool overflowed."""
        if self.spec.mode == "e4m3":
            vals, ok, _ = qc.decode_values(block.container, self.registry,
                                           prefetch=prefetch,
                                           device=self.device)
            if not ok:
                raise KVCacheOverflowError(
                    f"block {block.layer}@{block.start}: escape pool "
                    "overflow")
            out, pos = [], 0
            for s, d in zip(block.shapes, block.dtypes):
                n = math.prod(s)
                out.append(vals[pos:pos + n].to(_torch_dtype(d)).reshape(s))
                pos += n
            return out
        sections = qc.decode_codes_stream(block.container, self.registry,
                                          prefetch=prefetch,
                                          device=self.device)
        base = self.spec.layer_codec(_layer_index(block.layer))
        if not self._plane_split(base):
            syms, ok = sections[0]
            if not ok:
                raise KVCacheOverflowError(
                    f"block {block.layer}@{block.start}: escape pool "
                    "overflow")
            return _split_bytes(syms, block.shapes, block.dtypes)
        # Plane-split layer: one section per byte plane, in byte_planes
        # order (itemsize ascending, then byte index).
        order = self._plane_order(block.dtypes)
        if len(sections) != len(order):
            raise ValueError(f"block {block.layer}@{block.start}: "
                             f"{len(sections)} sections for "
                             f"{len(order)} byte planes")
        planes = {}
        for (isz, j), (syms, ok) in zip(order, sections):
            if not ok:
                raise KVCacheOverflowError(
                    f"block {block.layer}@{block.start} plane "
                    f"w{isz}b{j}: escape pool overflow")
            planes[(isz, j)] = syms
        return _unplane(planes, block.shapes, block.dtypes)

    @staticmethod
    def _plane_order(dtypes) -> List[Tuple[int, int]]:
        sizes = sorted({_torch_dtype(d).itemsize for d in dtypes})
        return [(isz, j) for isz in sizes for j in range(isz)]

    # ---- device framing (async paging) -----------------------------------

    def frame_plan(self, name: str, shapes, dtypes) -> LayerFramePlan:
        """The static container geometry of one layer's block, cached per
        (layer, shapes, dtypes). Needs ``KVCacheSpec(mode="qlc",
        exact_capacity=False)``: the plan geometry is what fixes every
        section's header ahead."""
        shapes = tuple(tuple(int(d) for d in s) for s in shapes)
        dtypes = tuple(dtypes)
        key = (name, shapes, dtypes)
        cached = self._plans.get(key)
        if cached is not None:
            return cached
        if self.spec.mode != "qlc" or self.spec.exact_capacity:
            raise ValueError(
                "device framing needs KVCacheSpec(mode='qlc', "
                "exact_capacity=False): fixed plan geometry is what "
                "fixes the container headers ahead")
        split = self._plane_split(name)
        sections: List[SectionPlan] = []
        offset = 0
        if split:
            per_isz: Dict[int, int] = {}
            for s, d in zip(shapes, dtypes):
                isz = _torch_dtype(d).itemsize
                per_isz[isz] = per_isz.get(isz, 0) + math.prod(s)
            for isz, j in self._plane_order(dtypes):
                sp = self._section_plan(f"{name}/w{isz}b{j}", (isz, j),
                                        per_isz[isz], offset)
                sections.append(sp)
                offset += sp.header.total_words
        else:
            n = sum(math.prod(s) * _torch_dtype(d).itemsize
                    for s, d in zip(shapes, dtypes))
            sp = self._section_plan(name, None, n, 0)
            sections.append(sp)
            offset = sp.header.total_words
        plan = LayerFramePlan(name=name, shapes=shapes, dtypes=dtypes,
                              split=split, sections=tuple(sections),
                              total_words=offset)
        self._plans[key] = plan
        return plan

    def _section_plan(self, pname: str, plane, n_valid: int,
                      offset: int) -> SectionPlan:
        """The coded/raw verdict and wire config the host path reaches
        under ``exact_capacity=False``, from the symbol count alone."""
        ch = self.channels[pname]
        entry = self.registry[pname]
        k = ch.cfg.chunk_symbols
        n_chunks = max(1, -(-n_valid // k))
        coded = codec_wins(entry)
        if coded:
            coded_words = (n_chunks * ch.cfg.capacity_words
                           + ch.cfg.pool_slots(n_chunks) * (k // 4))
            coded = coded_words < n_chunks * (k // 4)
        cfg = ch.cfg if coded else dataclasses.replace(ch.cfg,
                                                       enabled=False)
        h = qc.ContainerHeader(
            scheme_id=entry.scheme_id, coded=coded, chunk_symbols=k,
            capacity_words=ch.cfg.capacity_words if coded else k // 4,
            n_chunks=n_chunks,
            pool_slots=ch.cfg.pool_slots(n_chunks) if coded else 0,
            n_valid=n_valid, scale_dtype=None, n_scales=0,
            prefix_bits=entry.tables.prefix_bits)
        return SectionPlan(name=pname, plane=plane, offset=offset,
                           header=h, cfg=cfg)

    def encode_block_device(self, name: str, layer: str,
                            arrays: Sequence[torch.Tensor], *, start: int,
                            tokens: int) -> Optional[DeviceBlock]:
        """Frame one block on its device: byte planes by view, K3 per
        coded section, device framing — byte-identical to the host path.
        One host read: the coded sections' escape counts. Returns
        ``None`` when a coded section's pool overflowed under the plan
        capacity (the caller redoes the block on the host path, which
        wires it raw and counts the overflow)."""
        shapes = tuple(tuple(int(d) for d in a.shape) for a in arrays)
        dtypes = tuple(_dtype_name(a.dtype) for a in arrays)
        plan = self.frame_plan(name, shapes, dtypes)
        planes = byte_planes(arrays) if plan.split else None
        bufs, counts, slots = [], [], []
        raw_in_block = 0
        for sp in plan.sections:
            stream = (planes[sp.plane] if plan.split
                      else kv_symbol_stream(arrays, "qlc"))
            codes, _ = pad_to_multiple(stream, sp.cfg.chunk_symbols)
            payload = _compress_codes(codes, self.channels[sp.name].tables,
                                      sp.cfg)
            if sp.header.coded:
                counts.append(payload.pool_count.reshape(-1)[:1])
                slots.append(sp.header.pool_slots)
            else:
                raw_in_block += 1
                payload = payload._replace(pool=payload.pool[..., :0, :])
            bufs.append(qc.frame_block_device(
                payload, None, scheme_id=sp.header.scheme_id, cfg=sp.cfg,
                n_valid=sp.header.n_valid,
                prefix_bits=sp.header.prefix_bits))
        if counts and any(int(c) > s for c, s in
                          zip(torch.cat(counts).cpu(), slots)):
            return None
        self.raw_sections += raw_in_block
        return DeviceBlock(layer=layer, start=start, tokens=tokens,
                           shapes=shapes, dtypes=dtypes, plan=plan,
                           words=bufs[0] if len(bufs) == 1
                           else torch.cat(bufs),
                           coded=bool(counts))

    def decode_block_device(self, plan: LayerFramePlan, words: torch.Tensor
                            ) -> Tuple[List[torch.Tensor],
                                       List[torch.Tensor]]:
        """Decode a device-framed block straight from its (arena) words at
        the plan's fixed offsets, coded sections through K5. Returns the
        block's tensors and the coded sections' device ok flags."""
        streams: Dict[Any, torch.Tensor] = {}
        oks: List[torch.Tensor] = []
        for sp in plan.sections:
            h = sp.header
            payload, _ = qc._slice_payload(h, words,
                                           sp.offset + qc.HEADER_WORDS)
            if h.coded:
                codes, ok = _decompress_codes(
                    payload, self.channels[sp.name].tables, sp.cfg,
                    decode_fn=qc._prefetch_decode_fn())
                oks.append(ok)
            else:
                codes, _ = _decompress_codes(payload, None, sp.cfg)
            streams[sp.plane] = codes[:h.n_valid]
        if plan.split:
            return _unplane(streams, plan.shapes, plan.dtypes), oks
        return _split_bytes(streams[None], plan.shapes, plan.dtypes), oks

    # ---- accounting ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {"overflow_sections": self.overflow_sections,
                "raw_sections": self.raw_sections,
                "prefetch": self.prefetcher.stats()}

    def block_wire(self, block: KVBlock) -> torch.Tensor:
        """A cold block's container words on the cache's device (the u32
        bit pattern as int32): the migration payload of
        :func:`all_gather_block_wire`."""
        return torch.from_numpy(np.ascontiguousarray(
            block.container).view(np.int32)).to(self.device)


# --------------------------------------------------------------------------
# Calibration glue (decode states -> per-layer registry entries)
# --------------------------------------------------------------------------

def calibration_arrays(cfg: ModelConfig, states, tokens: int
                       ) -> Dict[str, List[torch.Tensor]]:
    """Per-layer-slot state tensors of a decode-states snapshot (e.g. a
    prefill), the histogram source for ``calibrate_kv_entries``: the
    filled ``[0, tokens)`` K/V slice of each attention slot, the whole
    carried state of each recurrent slot."""
    out: Dict[str, List[torch.Tensor]] = {}
    for i, kind in enumerate(cfg.layer_kinds()):
        st = states[f"l{i}"]
        if kind == "attention":
            out[f"l{i}"] = list(attn.kv_block_slice(st, 0, tokens))
        else:
            out[f"l{i}"] = list(ssm.state_snapshot(st))
    return out


def gather_row_states(cfg: ModelConfig, states, tokens: int, row):
    """The whole model's decode states over their first ``tokens``
    positions, on every rank of the model ``row`` (None: ``states``
    are whole), from each rank's part (``models.init_decode_states``
    with the row): each cut leaf
    all-gathered over the row (padded to the row's largest part, as the
    ranks' KV heads may differ in number), then joined by
    ``convert.gather_decode_states``, which takes each KV head once."""
    import torch.distributed as dist
    from repro_torch.convert import _whole_state_shapes, gather_decode_states
    from repro_torch.models.transformer import decode_state_cut
    trimmed = {key: st._replace(k=st.k.narrow(2, 0, tokens),
                                v=st.v.narrow(2, 0, tokens))
               if isinstance(st, attn.KVCache) else st
               for key, st in states.items()}
    if row is None:
        return trimmed
    whole = _whole_state_shapes(trimmed, cfg)
    cuts = [decode_state_cut(cfg, m, row.size, whole)
            for m in range(row.size)]
    parts = [{} for _ in range(row.size)]
    for key, st in trimmed.items():
        fields = [[] for _ in range(row.size)]
        for f, a in enumerate(st):
            if cuts[0][key][f] is None:
                for m in range(row.size):
                    fields[m].append(a)
                continue
            dim = cuts[0][key][f][0]
            most = max(c[key][f][2] for c in cuts)
            pad = list(a.shape)
            pad[dim] = most - a.shape[dim]
            mine = torch.cat([a, a.new_zeros(pad)], dim=dim).contiguous()
            mine = mine.view(torch.uint8)       # what every backend gathers
            got = [torch.empty_like(mine) for _ in range(row.size)]
            dist.all_gather(got, mine, group=row.group)
            for m in range(row.size):
                fields[m].append(got[m].view(a.dtype).narrow(
                    dim, 0, cuts[m][key][f][2]))
        for m in range(row.size):
            parts[m][key] = type(st)(*fields[m])
    return gather_decode_states(parts, cfg)


def calibrate_cache(registry, cfg: ModelConfig, states, tokens: int,
                    spec: KVCacheSpec, mesh=None, **kw):
    """Calibrate ``kv/layer{i}`` codecs for a model's decode states into
    ``registry``. Returns ``{name: CodecEntry}``. Over the model row of
    ``mesh``, ``states`` is this rank's part: the row's parts are
    gathered (:func:`gather_row_states`) and every rank calibrates the
    whole model's arrays, so the row's registries are identical, entry
    for entry (the symbol streams' chunks size each plan, which summed
    histograms could not)."""
    from repro_torch.launch.mesh import model_row
    row = model_row(mesh) if mesh is not None else None
    if row is not None:
        states = gather_row_states(cfg, states, tokens, row)
    kw.setdefault("chunk_symbols", spec.chunk_symbols)
    return calibrate_kv_entries(
        registry, calibration_arrays(cfg, states, tokens),
        mode=spec.mode, prefix=spec.codec_prefix, **kw)


def broadcast_kv_entries(registry, prefix: str, mesh, owner: int):
    """Data replica ``owner``'s ``f"{prefix}/..."`` registry entries,
    registered under the same scheme-ids in the registry of every rank
    of its data column of ``mesh``, so the column's registries hold the
    same codecs (the owner calibrated them from a prefill the others did
    not run). A host-side broadcast of the owner's registry JSON; every
    rank of the column calls it."""
    import torch.distributed as dist
    from repro_torch.core import CodecRegistry
    src = owner * mesh.model + mesh.coords[1]
    text = registry.to_json().encode() if mesh.rank == src else b""
    n = torch.tensor([len(text)], dtype=torch.int64)
    dist.broadcast(n, src=src, group=mesh.data_group)
    buf = (torch.frombuffer(bytearray(text), dtype=torch.uint8)
           if mesh.rank == src else torch.empty(int(n), dtype=torch.uint8))
    dist.broadcast(buf, src=src, group=mesh.data_group)
    if mesh.rank == src:
        return
    theirs = CodecRegistry.from_json(bytes(buf.numpy()).decode())
    for name in sorted(theirs.names()):
        if name.startswith(prefix + "/") and name not in registry:
            e = theirs[name]
            registry.register_tables(name, e.tables, e.plan, counts=e.counts,
                                     scheme_id=e.scheme_id)


# --------------------------------------------------------------------------
# Manifest round-trip (serving handoff, next to the weight placement)
# --------------------------------------------------------------------------

def kv_cache_manifest(spec: KVCacheSpec, registry) -> Dict:
    """JSON-able KV recipe: the paging spec + per-layer scheme-ids (the
    tables ride the registry JSON)."""
    names = sorted(n for n in registry.names()
                   if n.startswith(spec.codec_prefix + "/"))
    return {"spec": spec.to_json(),
            "scheme_ids": {n: registry[n].scheme_id for n in names}}


def kv_spec_from_manifest(d: Dict) -> Tuple[KVCacheSpec, Dict[str, int]]:
    """Inverse of :func:`kv_cache_manifest`."""
    return (KVCacheSpec.from_json(d["spec"]),
            {str(k): int(v) for k, v in d.get("scheme_ids", {}).items()})
