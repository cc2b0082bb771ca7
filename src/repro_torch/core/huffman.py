"""Canonical Huffman baseline (the paper compares QLC against it).

Provides: code-length construction (heap-based, deterministic),
canonical codes, an encoder, and the deliberately bit-sequential
tree-walking decoder that represents the complexity QLC removes.
"""
from __future__ import annotations

import heapq
from typing import List, Tuple

import numpy as np

NUM_SYMBOLS = 256


def code_lengths(counts: np.ndarray) -> np.ndarray:
    """Huffman code lengths per symbol. Zero-count symbols get length 0
    (they are never emitted; callers wanting a total code should smooth).

    Deterministic: ties broken by (count, min symbol in subtree).
    """
    counts = np.asarray(counts, dtype=np.float64)
    if counts.shape != (NUM_SYMBOLS,):
        raise ValueError("counts must have shape (256,)")
    active = [int(s) for s in range(NUM_SYMBOLS) if counts[s] > 0]
    lengths = np.zeros(NUM_SYMBOLS, dtype=np.int32)
    if len(active) == 0:
        raise ValueError("at least one symbol must have nonzero count")
    if len(active) == 1:
        lengths[active[0]] = 1
        return lengths

    # Heap of (count, tiebreak, node). Leaves are ints, internal nodes lists.
    heap: List[Tuple[float, int, object]] = [
        (float(counts[s]), s, s) for s in active]
    heapq.heapify(heap)
    uid = NUM_SYMBOLS
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        heapq.heappush(heap, (c1 + c2, uid, (n1, n2)))
        uid += 1

    stack = [(heap[0][2], 0)]
    while stack:
        node, depth = stack.pop()
        if isinstance(node, int):
            lengths[node] = max(depth, 1)
        else:
            stack += [(node[1], depth + 1), (node[0], depth + 1)]
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical Huffman codes (MSB-first integers) from lengths.

    Symbols with length 0 get code 0 (unused).
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    codes = np.zeros(NUM_SYMBOLS, dtype=np.uint64)
    order = sorted((int(l), s) for s, l in enumerate(lengths) if l > 0)
    code = 0
    prev_len = order[0][0] if order else 0
    for l, s in order:
        code <<= (l - prev_len)
        codes[s] = code
        code += 1
        prev_len = l
    return codes


class HuffmanCodec:
    """Reference Huffman codec over 256 symbols."""

    def __init__(self, counts: np.ndarray):
        counts = np.asarray(counts, dtype=np.float64)
        self.lengths = code_lengths(counts)
        self.codes = canonical_codes(self.lengths)
        self._build_tree()

    def _build_tree(self):
        # Binary tree as flat arrays: children[node, bit] -> node or -(sym+1).
        nodes = [[-0, -0]]  # root; 0 means "unassigned child"
        children = nodes

        def insert(sym, code, length):
            node = 0
            for i in range(length - 1, -1, -1):
                bit = (code >> i) & 1
                nxt = children[node][bit]
                if i == 0:
                    children[node][bit] = -(sym + 1)
                else:
                    if nxt <= 0:
                        children.append([0, 0])
                        nxt = len(children) - 1
                        children[node][bit] = nxt
                    node = nxt

        for s in range(NUM_SYMBOLS):
            l = int(self.lengths[s])
            if l > 0:
                insert(s, int(self.codes[s]), l)
        self.children = np.array(children, dtype=np.int64)

    # -- metrics ----------------------------------------------------------

    def expected_bits(self, counts: np.ndarray) -> float:
        counts = np.asarray(counts, dtype=np.float64)
        pmf = counts / counts.sum()
        return float(np.dot(self.lengths.astype(np.float64), pmf))

    def compressibility(self, counts: np.ndarray) -> float:
        return (8.0 - self.expected_bits(counts)) / 8.0

    # -- encode / decode (numpy bitstream, MSB-first) ----------------------

    def encode(self, symbols: np.ndarray) -> Tuple[np.ndarray, int]:
        """Encode to a packed uint8 MSB-first bitstream. Returns (bytes, nbits)."""
        symbols = np.asarray(symbols, dtype=np.int64).reshape(-1)
        lens = self.lengths[symbols].astype(np.int64)
        nbits = int(lens.sum())
        offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
        out = np.zeros((nbits + 7) // 8, dtype=np.uint8)
        codes = self.codes[symbols]
        # Bit-by-bit emit (reference implementation; clarity over speed).
        for i in range(symbols.shape[0]):
            c, l, o = int(codes[i]), int(lens[i]), int(offsets[i])
            for b in range(l):
                bit = (c >> (l - 1 - b)) & 1
                if bit:
                    out[(o + b) >> 3] |= 0x80 >> ((o + b) & 7)
        return out, nbits

    def decode(self, data: np.ndarray, nbits: int, n_symbols: int
               ) -> np.ndarray:
        """Bit-sequential tree-walking decode — the baseline the paper's
        speed claim is about. Each output symbol requires `length` branch
        decisions; decode latency is proportional to total encoded bits."""
        out = np.empty(n_symbols, dtype=np.uint8)
        pos = 0
        children = self.children
        for i in range(n_symbols):
            node = 0
            while True:
                bit = (data[pos >> 3] >> (7 - (pos & 7))) & 1
                pos += 1
                nxt = children[node][bit]
                if nxt <= 0:
                    out[i] = -nxt - 1
                    break
                node = nxt
        return out
