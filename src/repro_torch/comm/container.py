"""Self-describing QLC container format (byte-compatible both ways with
the reference's ``comm/container.py`` and ``docs/wire-format.md``).

A **container** frames one compressed payload with a fixed 16-word
packed header, so the payload decodes from the bytes plus a
``CodecRegistry`` alone. A stream concatenates containers ("sections"),
each with its own scheme-id.

Header layout (16 little-endian uint32 words)::

    word  0  magic            0x514C4331 ("QLC1")
    word  1  version          1
    word  2  scheme_id        registry id of the coding scheme
    word  3  flags            bit 0: QLC-coded (0 = raw e4m3 words)
    word  4  chunk_symbols    K, symbols per chunk
    word  5  capacity_words   32-bit words per chunk slot
    word  6  n_chunks         chunks in the payload
    word  7  pool_slots       escape-pool rows
    word  8  n_valid (lo32)   valid symbols (trailing pad dropped)
    word  9  n_valid (hi32)
    word 10  scale_dtype      0 none | 1 bfloat16 | 2 float32
    word 11  n_scales         block-32 scale count
    word 12  prefix_bits      area-code bits of the scheme (sanity)
    word 13  reserved         0
    word 14  reserved         0
    word 15  crc32            of words 0..14 (little-endian bytes)

Sections follow the header back to back, all as uint32 words:
``words [n_chunks * capacity_words]``, ``flags [ceil(n_chunks/4)]``
(packed uint8), ``pool [pool_slots * chunk_symbols/4]``, ``pool_count
[1]``, ``scales`` (bf16 packed 2-per-word, or f32 1-per-word).

Containers at rest are numpy ``uint32`` arrays. Headers are parsed on
the host. Framing runs on the payload's device
(:func:`frame_block_device`; :func:`pack_payload` is that plus one copy
to the host), and a decode uploads the container once and slices its
sections there. Coded slots decode through ``kernels.ops``: K4, or K5
with ``prefetch=True``; :func:`decode_codes_stream` decodes every coded
section of a mixed-scheme stream in one multi-LUT launch. The decode
entry points run on the card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.comm.compressed import (CommConfig, WirePayload,
                                         _compress_codes, _decompress_codes,
                                         _dequantize, _gather_pool_raw,
                                         pad_to_multiple)
from repro_torch.core.registry import CodecEntry, CodecRegistry
from repro_torch.kernels import ops
from repro_torch.models.transformer import resolve_device

MAGIC = 0x514C4331           # "QLC1"
CONTAINER_VERSION = 1
HEADER_WORDS = 16

_SCALE_DTYPES = {0: None, 1: "bfloat16", 2: "float32"}
_SCALE_CODES = {v: k for k, v in _SCALE_DTYPES.items()}
FLAG_CODED = 1


@dataclasses.dataclass(frozen=True)
class ContainerHeader:
    """Parsed container header — everything needed to slice the
    sections and rebuild the wire config."""
    scheme_id: int
    coded: bool                  # False => raw e4m3 words on the wire
    chunk_symbols: int
    capacity_words: int
    n_chunks: int
    pool_slots: int
    n_valid: int
    scale_dtype: Optional[str]   # None | "bfloat16" | "float32"
    n_scales: int
    prefix_bits: int

    # ---- section geometry (in u32 words) --------------------------------

    @property
    def words_len(self) -> int:
        return self.n_chunks * self.capacity_words

    @property
    def flags_len(self) -> int:
        return -(-self.n_chunks // 4)

    @property
    def pool_len(self) -> int:
        return self.pool_slots * (self.chunk_symbols // 4)

    @property
    def scales_len(self) -> int:
        if self.scale_dtype is None:
            return 0
        per_word = 2 if self.scale_dtype == "bfloat16" else 1
        return -(-self.n_scales // per_word)

    @property
    def body_words(self) -> int:
        return (self.words_len + self.flags_len + self.pool_len + 1
                + self.scales_len)

    @property
    def total_words(self) -> int:
        return HEADER_WORDS + self.body_words

    def comm_config(self, **overrides) -> CommConfig:
        """A wire config sufficient to DECODE this payload. The pool size
        comes from word 7; ``pool_slots_per_1k`` here is only a
        ceil-rounded back-derivation, so new payloads should use the
        registry entry's plan instead."""
        pool_per_1k = max(1, math.ceil(
            self.pool_slots * 1024 / max(self.n_chunks, 1)))
        kw = dict(enabled=self.coded,
                  chunk_symbols=self.chunk_symbols,
                  capacity_words=self.capacity_words,
                  pool_slots_per_1k=pool_per_1k,
                  scale_dtype=self.scale_dtype or "bfloat16")
        kw.update(overrides)
        return CommConfig(**kw)


def pack_header(h: ContainerHeader) -> np.ndarray:
    w = np.zeros(HEADER_WORDS, dtype=np.uint32)
    w[0] = MAGIC
    w[1] = CONTAINER_VERSION
    w[2] = h.scheme_id
    w[3] = FLAG_CODED if h.coded else 0
    w[4] = h.chunk_symbols
    w[5] = h.capacity_words
    w[6] = h.n_chunks
    w[7] = h.pool_slots
    w[8] = h.n_valid & 0xFFFFFFFF
    w[9] = (h.n_valid >> 32) & 0xFFFFFFFF
    w[10] = _SCALE_CODES[h.scale_dtype]
    w[11] = h.n_scales
    w[12] = h.prefix_bits
    w[15] = zlib.crc32(w[:15].tobytes())
    return w


def parse_header(buf: np.ndarray, offset: int = 0) -> ContainerHeader:
    """Parse and validate one header at ``offset`` (in u32 words)."""
    buf = np.asarray(buf, dtype=np.uint32).reshape(-1)
    if buf.size - offset < HEADER_WORDS:
        raise ValueError(
            f"truncated container: {buf.size - offset} words < header")
    w = buf[offset:offset + HEADER_WORDS]
    if int(w[0]) != MAGIC:
        raise ValueError(f"bad container magic 0x{int(w[0]):08x}")
    if int(w[1]) != CONTAINER_VERSION:
        raise ValueError(f"unsupported container version {int(w[1])}")
    if int(w[15]) != zlib.crc32(w[:15].tobytes()):
        raise ValueError("container header CRC mismatch")
    code = int(w[10])
    if code not in _SCALE_DTYPES:
        raise ValueError(f"unknown scale dtype code {code}")
    h = ContainerHeader(
        scheme_id=int(w[2]),
        coded=bool(int(w[3]) & FLAG_CODED),
        chunk_symbols=int(w[4]),
        capacity_words=int(w[5]),
        n_chunks=int(w[6]),
        pool_slots=int(w[7]),
        n_valid=int(w[8]) | (int(w[9]) << 32),
        scale_dtype=_SCALE_DTYPES[code],
        n_scales=int(w[11]),
        prefix_bits=int(w[12]),
    )
    if h.chunk_symbols <= 0 or h.chunk_symbols % 4:
        raise ValueError(f"bad chunk_symbols {h.chunk_symbols}")
    if h.n_valid > h.n_chunks * h.chunk_symbols:
        raise ValueError("n_valid exceeds payload capacity")
    if buf.size - offset < h.total_words:
        raise ValueError(
            f"truncated container: {buf.size - offset} words < "
            f"{h.total_words}")
    return h


# --------------------------------------------------------------------------
# Payload <-> words
# --------------------------------------------------------------------------

def _u8_words(a: torch.Tensor) -> torch.Tensor:
    """u8 flags -> packed int32 words, little-endian, zero-padded."""
    a = a.reshape(-1).to(torch.uint8)
    pad = (-a.shape[0]) % 4
    if pad:
        a = F.pad(a, (0, pad))
    return a.contiguous().view(torch.int32)


def _scales_words(scales: Optional[torch.Tensor], dtype: Optional[str],
                  device) -> torch.Tensor:
    if dtype is None:
        return torch.zeros(0, dtype=torch.int32, device=device)
    s = scales.reshape(-1)
    if dtype == "bfloat16":
        u16 = s.to(torch.bfloat16).contiguous().view(torch.int16)
        if u16.shape[0] % 2:
            u16 = F.pad(u16, (0, 1))
        return u16.view(torch.int32)
    return s.to(torch.float32).contiguous().view(torch.int32)


_HEADER_CACHE: Dict[Tuple[bytes, str], torch.Tensor] = {}


def _header_tensor(h: ContainerHeader, device) -> torch.Tensor:
    """The packed header on ``device``, kept per content: framing a block
    of a fixed geometry uploads its headers once."""
    words = pack_header(h)
    key = (words.tobytes(), str(device))
    t = _HEADER_CACHE.get(key)
    if t is None:
        t = torch.from_numpy(words.view(np.int32).copy()).to(device)
        if len(_HEADER_CACHE) < 1024:      # never dropped, as ops' LUTs
            _HEADER_CACHE[key] = t
    return t


def frame_block_device(payload: WirePayload, scales, *, scheme_id: int,
                       cfg: CommConfig, n_valid: int,
                       prefix_bits: int = 3) -> torch.Tensor:
    """Frame one (payload, scales) pair as container words (int32, u32
    bit patterns) on the payload's device, without a host round trip:
    the header depends only on the geometry, and the sections are device
    copies."""
    words = payload.words
    n_chunks, capacity_words = words.shape[-2], words.shape[-1]
    scale_dtype = None if scales is None else cfg.scale_dtype
    h = ContainerHeader(
        scheme_id=scheme_id,
        coded=cfg.enabled,
        chunk_symbols=cfg.chunk_symbols,
        capacity_words=capacity_words,
        n_chunks=n_chunks,
        pool_slots=payload.pool.shape[-2],
        n_valid=int(n_valid),
        scale_dtype=scale_dtype,
        n_scales=0 if scales is None else int(scales.numel()),
        prefix_bits=prefix_bits,
    )
    dev = words.device
    return torch.cat([
        _header_tensor(h, dev),
        words.reshape(-1),
        _u8_words(payload.flags),
        payload.pool.reshape(-1),
        payload.pool_count.reshape(-1)[:1].to(torch.int32),
        _scales_words(scales, scale_dtype, dev),
    ])


def _host_words(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def pack_payload(payload: WirePayload, scales, *, scheme_id: int,
                 cfg: CommConfig, n_valid: int,
                 prefix_bits: int = 3) -> np.ndarray:
    """Frame one (payload, scales) pair as a container word array (numpy
    uint32 on the host)."""
    return _host_words(frame_block_device(
        payload, scales, scheme_id=scheme_id, cfg=cfg, n_valid=n_valid,
        prefix_bits=prefix_bits))


def _upload(buf: np.ndarray, device) -> torch.Tensor:
    """A container or stream as one int32 tensor on ``device``: one copy
    (also on the CPU, so decoded views never alias the caller's bytes)."""
    return torch.from_numpy(np.ascontiguousarray(buf).view(np.int32)
                            ).to(resolve_device(device), copy=True)


def _slice_payload(h: ContainerHeader, words: torch.Tensor, pos: int):
    """Sections of the container whose body starts at ``pos`` of the
    int32 tensor ``words`` -> (WirePayload, scales or None), as views."""
    def take(n):
        nonlocal pos
        out = words[pos:pos + n]
        pos += n
        return out

    w = take(h.words_len).reshape(h.n_chunks, h.capacity_words)
    flags = take(h.flags_len).view(torch.uint8)[:h.n_chunks]
    pool = take(h.pool_len).reshape(h.pool_slots, h.chunk_symbols // 4)
    pool_count = take(1)
    sw = take(h.scales_len)
    scales = None
    if h.scale_dtype == "bfloat16":
        scales = sw.view(torch.bfloat16)[:h.n_scales]
    elif h.scale_dtype == "float32":
        scales = sw.view(torch.float32)[:h.n_scales]
    return WirePayload(words=w, flags=flags, pool=pool,
                       pool_count=pool_count), scales


def unpack_payload(buf: np.ndarray, offset: int = 0, *, device="cuda"
                   ) -> Tuple[ContainerHeader, WirePayload,
                              Optional[torch.Tensor], int]:
    """Slice one container back into (header, WirePayload, scales,
    next_offset), its sections on ``device``."""
    buf = np.asarray(buf, dtype=np.uint32).reshape(-1)
    h = parse_header(buf, offset)
    words = _upload(buf[offset:offset + h.total_words], device)
    payload, scales = _slice_payload(h, words, HEADER_WORDS)
    return h, payload, scales, offset + h.total_words


def _tables_for(h: ContainerHeader, registry: CodecRegistry):
    """Registry lookup plus the header's sanity check: the scheme behind
    the wire scheme-id must have the geometry the payload was coded
    with, or decode would silently corrupt."""
    tables = registry.by_id(h.scheme_id).tables
    if h.coded and tables.prefix_bits != h.prefix_bits:
        raise ValueError(
            f"scheme-id {h.scheme_id}: registry tables have "
            f"prefix_bits={tables.prefix_bits} but the container was "
            f"coded with {h.prefix_bits} — wrong registry?")
    return tables


def _prefetch_decode_fn():
    """Slot-decode override through K5 (``kernels.ops.
    decode_block_async``) — the async KV paging path's word movement,
    bit-identical to the plain decode."""
    def fn(words, tables, cfg):
        flat = words.reshape(-1, words.shape[-1])
        out = ops.decode_block_async(flat, tables, cfg.chunk_symbols)
        return out.reshape(words.shape[:-1] + (cfg.chunk_symbols,))
    return fn


# --------------------------------------------------------------------------
# Value / code round trips
# --------------------------------------------------------------------------

def decode_values(buf, registry: CodecRegistry, offset: int = 0, *,
                  use_kernels: Optional[bool] = None, prefetch: bool = False,
                  device="cuda") -> Tuple[torch.Tensor, bool, int]:
    """Container -> (float32 values [n_valid] on ``device``, ok,
    next_offset): decode (K4, or K5 with ``prefetch``), then the e4m3
    dequantize. ``use_kernels`` is accepted for the reference's
    signature; the route follows ``device``."""
    del use_kernels
    h, payload, scales, pos = unpack_payload(buf, offset, device=device)
    if scales is None:
        raise ValueError("container carries no scales; use decode_codes")
    codes, ok = _decompress_codes(
        payload, _tables_for(h, registry), h.comm_config(),
        decode_fn=_prefetch_decode_fn() if prefetch else None)
    return _dequantize(codes, scales)[:h.n_valid], bool(ok), pos


def encode_codes(codes: torch.Tensor, entry: CodecEntry,
                 cfg: Optional[CommConfig] = None,
                 **cfg_overrides) -> np.ndarray:
    """uint8 symbol tensor -> container (no scales section), encoded on
    the tensor's device (K3 on the card)."""
    if cfg is None:
        cfg = entry.config(**cfg_overrides)
    flat, n = pad_to_multiple(codes.to(torch.uint8).reshape(-1),
                              cfg.chunk_symbols)
    payload = _compress_codes(flat, entry.tables, cfg)
    return pack_payload(payload, None, scheme_id=entry.scheme_id,
                        cfg=cfg, n_valid=n,
                        prefix_bits=entry.tables.prefix_bits)


def decode_codes(buf, registry: CodecRegistry, offset: int = 0, *,
                 use_kernels: Optional[bool] = None, prefetch: bool = False,
                 device="cuda") -> Tuple[torch.Tensor, bool, int]:
    """Container -> (uint8 codes [n_valid] on ``device``, ok,
    next_offset)."""
    del use_kernels
    h, payload, _, pos = unpack_payload(buf, offset, device=device)
    out, ok = _decompress_codes(
        payload, _tables_for(h, registry) if h.coded else None,
        h.comm_config(),
        decode_fn=_prefetch_decode_fn() if prefetch else None)
    return out[:h.n_valid], bool(ok), pos


# --------------------------------------------------------------------------
# Mixed-scheme streams
# --------------------------------------------------------------------------

def pack_stream(sections: Sequence[np.ndarray]) -> np.ndarray:
    """Concatenate containers into one stream."""
    return (np.concatenate([np.asarray(s, np.uint32) for s in sections])
            if sections else np.zeros(0, np.uint32))


def stream_headers(buf) -> List[Tuple[int, ContainerHeader]]:
    """Walk a stream: [(offset, header), ...] for every section."""
    buf = np.asarray(buf, dtype=np.uint32).reshape(-1)
    out, offset = [], 0
    while offset < buf.size:
        h = parse_header(buf, offset)
        out.append((offset, h))
        offset += h.total_words
    return out


def decode_codes_stream(buf, registry: CodecRegistry, *,
                        use_kernels: bool = False, prefetch: bool = False,
                        device="cuda") -> List[Tuple[torch.Tensor, bool]]:
    """Decode a mixed-scheme stream's QLC chunks in ONE batched pass.

    The stream goes to ``device`` in one copy. All coded sections' slots
    (padded to the widest capacity) decode in a single multi-LUT launch
    — K4, or K5 with ``prefetch`` — with a scheme slot per chunk; raw
    sections are byte views. Escape pools merge per section (their rows
    are section-local), and each section's ``ok`` comes from its
    pool_count on the host. Returns ``[(codes u8 [n_valid], ok), ...]``
    in section order. ``use_kernels`` is accepted for the reference's
    signature; the route follows ``device``.
    """
    del use_kernels
    buf = np.asarray(buf, dtype=np.uint32).reshape(-1)
    heads = stream_headers(buf)
    if not heads:
        return []
    words = _upload(buf, device)
    parsed = [(h, off, *_slice_payload(h, words, off + HEADER_WORDS))
              for off, h in heads]
    results: List[Optional[Tuple[torch.Tensor, bool]]] = [None] * len(parsed)

    coded = [i for i, (h, *_) in enumerate(parsed) if h.coded]
    if coded:
        ks = {parsed[i][0].chunk_symbols for i in coded}
        if len(ks) != 1:
            raise ValueError(
                f"batched stream decode needs one chunk size, got {ks}")
        k = ks.pop()
        cap = max(parsed[i][0].capacity_words for i in coded)
        tables_list, id_map = registry.stacked_decode_tables(
            [parsed[i][0].scheme_id for i in coded])
        blocks, sids = [], []
        for i in coded:
            h, _, payload, _ = parsed[i]
            _tables_for(h, registry)     # prefix_bits sanity per section
            blocks.append(F.pad(payload.words,
                                (0, cap - h.capacity_words)))
            sids.append(torch.full((h.n_chunks,), int(id_map[h.scheme_id]),
                                   dtype=torch.int32, device=words.device))
        all_words = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
        all_sids = sids[0] if len(sids) == 1 else torch.cat(sids)
        decode = ops.decode_block_async if prefetch else ops.decode
        dec = decode(all_words, tables_list, k, scheme_ids=all_sids)
        row = 0
        for i in coded:
            h, off, payload, _ = parsed[i]
            sec = dec[row:row + h.n_chunks]
            row += h.n_chunks
            escape = payload.flags.bool()
            merged = torch.where(escape[:, None],
                                 _gather_pool_raw(payload, h.comm_config()),
                                 sec)
            count = int(buf[off + HEADER_WORDS + h.words_len + h.flags_len
                            + h.pool_len])
            results[i] = (merged.reshape(-1)[:h.n_valid],
                          count <= h.pool_slots)

    for i, (h, _, payload, _) in enumerate(parsed):
        if results[i] is None:          # raw e4m3 section
            out, _ = _decompress_codes(payload, None, h.comm_config())
            results[i] = (out[:h.n_valid], True)
    return results


def container_bytes(buf) -> int:
    """Wire footprint of a container/stream in bytes."""
    return int(np.asarray(buf).size) * 4
