"""Quad Length Code schemes (the paper's core contribution, §5-§6).

A scheme divides the 256 ranked symbols into ``2**prefix_bits`` areas.
The area code (the first ``prefix_bits`` bits of every codeword) uniquely
determines the code length, so the decoder never walks a tree: it reads
the prefix, looks up the length, reads the payload, and adds an offset.

Codeword layout (LSB-first software bitstream convention):

    bits [0, prefix_bits)                    : area code
    bits [prefix_bits, prefix_bits+sb)       : symbol index within area

The paper writes codes MSB-first (``000_000``); bit order is an
implementation detail that changes neither lengths nor ratios. We use the
LSB-first convention standard for software entropy coders (cf. DEFLATE).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

NUM_SYMBOLS = 256


@dataclasses.dataclass(frozen=True)
class QLCScheme:
    """A quad-length-code scheme.

    Attributes:
      areas: tuple of ``(num_symbols, symbol_bits)`` pairs, one per area.
        ``num_symbols <= 2**symbol_bits`` and the totals must sum to 256.
      prefix_bits: number of bits in the area code (3 in the paper).
    """

    areas: Tuple[Tuple[int, int], ...]
    prefix_bits: int = 3

    def __post_init__(self):
        n_areas = len(self.areas)
        if n_areas > (1 << self.prefix_bits):
            raise ValueError(
                f"{n_areas} areas need more than {self.prefix_bits} prefix bits")
        total = 0
        for i, (n, sb) in enumerate(self.areas):
            if n < 1:
                raise ValueError(f"area {i}: num_symbols must be >= 1, got {n}")
            if not (0 <= sb <= 8):
                raise ValueError(f"area {i}: symbol_bits must be in [0, 8], got {sb}")
            if n > (1 << sb):
                raise ValueError(
                    f"area {i}: {n} symbols do not fit in {sb} symbol bits")
            total += n
        if total != NUM_SYMBOLS:
            raise ValueError(f"areas must cover exactly 256 symbols, got {total}")

    # ---- derived tables (all numpy; tiny, computed eagerly) -------------

    @property
    def num_areas(self) -> int:
        return len(self.areas)

    @property
    def area_starts(self) -> np.ndarray:
        """Rank at which each area begins. Shape [num_areas]."""
        sizes = np.array([n for n, _ in self.areas], dtype=np.int32)
        return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)

    @property
    def area_symbol_bits(self) -> np.ndarray:
        """Symbol bits per area, padded to 2**prefix_bits. Shape [2**prefix]."""
        sb = np.array([s for _, s in self.areas], dtype=np.int32)
        pad = (1 << self.prefix_bits) - len(sb)
        if pad:
            # Unused area codes decode as 0 extra bits; they are never emitted.
            sb = np.concatenate([sb, np.zeros(pad, dtype=np.int32)])
        return sb

    @property
    def area_starts_padded(self) -> np.ndarray:
        starts = self.area_starts
        pad = (1 << self.prefix_bits) - len(starts)
        if pad:
            starts = np.concatenate(
                [starts, np.full(pad, NUM_SYMBOLS - 1, dtype=np.int32)])
        return starts.astype(np.int32)

    @property
    def code_lengths(self) -> np.ndarray:
        """Code length per *rank* (0 = most frequent). Shape [256], int32."""
        out = np.empty(NUM_SYMBOLS, dtype=np.int32)
        r = 0
        for n, sb in self.areas:
            out[r:r + n] = self.prefix_bits + sb
            r += n
        return out

    @property
    def max_code_length(self) -> int:
        return int(self.code_lengths.max())

    @property
    def distinct_lengths(self) -> Tuple[int, ...]:
        return tuple(sorted(set(int(x) for x in self.code_lengths)))

    def rank_codes(self) -> Tuple[np.ndarray, np.ndarray]:
        """(code, length) per rank; LSB-first codeword integers. [256] each."""
        codes = np.empty(NUM_SYMBOLS, dtype=np.uint32)
        lens = self.code_lengths.astype(np.uint32)
        r = 0
        for a, (n, sb) in enumerate(self.areas):
            idx = np.arange(n, dtype=np.uint32)
            codes[r:r + n] = np.uint32(a) | (idx << np.uint32(self.prefix_bits))
            r += n
        return codes, lens

    # ---- metrics ---------------------------------------------------------

    def expected_bits(self, pmf_sorted: np.ndarray) -> float:
        """Average code length given a PMF already sorted descending."""
        pmf_sorted = np.asarray(pmf_sorted, dtype=np.float64)
        if pmf_sorted.shape != (NUM_SYMBOLS,):
            raise ValueError("pmf must have shape (256,)")
        return float(np.dot(pmf_sorted, self.code_lengths))

    def compressibility(self, pmf_sorted: np.ndarray) -> float:
        """Paper's metric: (8 - avg_bits) / 8, for a descending-sorted PMF."""
        return (8.0 - self.expected_bits(pmf_sorted)) / 8.0

    def describe(self) -> str:
        rows = ["area  code  #sym  sym_bits  code_len  range"]
        r = 0
        for a, (n, sb) in enumerate(self.areas):
            code = format(a, f"0{self.prefix_bits}b")
            rows.append(
                f"{a + 1:>4}  {code:>4}  {n:>4}  {sb:>8}  "
                f"{self.prefix_bits + sb:>8}  {r}-{r + n - 1}")
            r += n
        return "\n".join(rows)


# The paper's two published schemes. --------------------------------------

#: Table 1 — FFN1-activation-like distributions (no dominant symbol).
TABLE1 = QLCScheme(
    areas=((8, 3), (8, 3), (8, 3), (8, 3), (8, 3), (16, 4), (32, 5), (168, 8)))

#: Table 2 — FFN2-activation-like distributions (zero spike).
TABLE2 = QLCScheme(
    areas=((2, 1), (8, 3), (8, 3), (8, 3), (8, 3), (32, 5), (32, 5), (158, 8)))

PAPER_SCHEMES = {"table1": TABLE1, "table2": TABLE2}


def scheme_from_area_sizes(sizes: Sequence[int], prefix_bits: int = 3
                           ) -> QLCScheme:
    """Build a scheme from area sizes alone, using the minimal symbol bits."""
    areas = tuple((int(n), max(0, math.ceil(math.log2(n))) if n > 1 else 0)
                  for n in sizes)
    # ceil(log2(1)) == 0; for n>1 use exact bit count.
    fixed = []
    for n, _ in areas:
        sb = 0 if n == 1 else math.ceil(math.log2(n))
        fixed.append((n, sb))
    return QLCScheme(areas=tuple(fixed), prefix_bits=prefix_bits)
