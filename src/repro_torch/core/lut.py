"""Encoder / decoder Look-Up Table construction (paper §7, Tables 3-4).

The encoder LUT maps an *input symbol* (the raw e4m3 byte) to its
codeword + length. The decoder LUT maps the *encoded symbol* (the rank
recovered from area code + payload) back to the output symbol.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np

from repro_torch.core import entropy
from repro_torch.core.schemes import NUM_SYMBOLS, QLCScheme


@dataclasses.dataclass(frozen=True)
class CodecTables:
    """Everything the (de)coder needs, as small numpy arrays.

    Attributes:
      enc_code: [256] uint32 — codeword for each *input symbol* (LSB-first).
      enc_len:  [256] uint32 — codeword length in bits for each input symbol.
      dec_lut:  [256] uint8  — rank -> output symbol (paper Table 4).
      area_symbol_bits: [2**prefix] int32 — payload bits per area code.
      area_starts:      [2**prefix] int32 — first rank of each area.
      prefix_bits: int.
      scheme: the generating scheme (for metrics / introspection).
    """

    enc_code: np.ndarray
    enc_len: np.ndarray
    dec_lut: np.ndarray
    area_symbol_bits: np.ndarray
    area_starts: np.ndarray
    prefix_bits: int
    scheme: QLCScheme

    @functools.cached_property
    def digest(self) -> str:
        """Content digest of every table, computed once per instance: the
        key under which ``kernels.ops`` keeps their device copies."""
        h = hashlib.sha256(bytes([self.prefix_bits]))
        for a in (self.enc_code, self.enc_len, self.dec_lut,
                  self.area_symbol_bits, self.area_starts):
            a = np.ascontiguousarray(a)
            h.update(str((a.dtype.str, a.shape)).encode())
            h.update(a.tobytes())
        return h.hexdigest()

    @property
    def max_code_length(self) -> int:
        return int(self.enc_len.max())

    def expected_bits(self, counts: np.ndarray) -> float:
        pmf = entropy.normalize_counts(counts)
        return float(np.dot(self.enc_len.astype(np.float64), pmf))

    def compressibility(self, counts: np.ndarray) -> float:
        return (8.0 - self.expected_bits(counts)) / 8.0


def build_tables(counts: np.ndarray, scheme: QLCScheme) -> CodecTables:
    """Build encoder/decoder LUTs for a symbol-frequency histogram.

    Symbols are ranked by decreasing count (stable, ties broken by symbol
    value — deterministic across hosts, which matters for distributed use:
    every host must derive identical tables from identical counts).
    """
    counts = np.asarray(counts)
    if counts.shape != (NUM_SYMBOLS,):
        raise ValueError("counts must have shape (256,)")
    _, order = entropy.sort_pmf_desc(counts)  # order[rank] = symbol
    rank_of = np.empty(NUM_SYMBOLS, dtype=np.int32)
    rank_of[order] = np.arange(NUM_SYMBOLS, dtype=np.int32)

    rank_code, rank_len = scheme.rank_codes()
    enc_code = rank_code[rank_of].astype(np.uint32)
    enc_len = rank_len[rank_of].astype(np.uint32)
    dec_lut = order.astype(np.uint8)  # rank -> symbol

    return CodecTables(
        enc_code=enc_code,
        enc_len=enc_len,
        dec_lut=dec_lut,
        area_symbol_bits=scheme.area_symbol_bits,
        area_starts=scheme.area_starts_padded,
        prefix_bits=scheme.prefix_bits,
        scheme=scheme,
    )


def identity_tables(scheme: QLCScheme) -> CodecTables:
    """Tables with rank == symbol (uniform counts); useful for tests."""
    return build_tables(np.full(NUM_SYMBOLS, 1.0), scheme)
