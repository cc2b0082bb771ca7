// Device code shared by the codes decoders K4 (qlc_decode.cu) and K5
// (qlc_prefetch.cu): the decoder's core (a bit cursor over a window
// table, the per-thread word ring that feeds it, and the warp's staged
// store of decoded symbols).
#pragma once

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace qlc {

constexpr unsigned kFull = 0xffffffffu;

// ---- The decoder's core (K4, K5) --------------------------------------
//
// One thread walks one chunk. Per (prefix + 8)-bit window each scheme has
// a 2-byte table entry: the code length (prefix + payload bits) in bits
// 0-4, the symbol dec_lut[min(first rank + payload, 255)] in bits 8-15
// (built on the host, repro_torch/kernels/qlc_codes.py::window_table).
// The cursor keeps the chunk's next 48-96 bits in three registers and
// drops each code with funnel shifts that read its length from the
// entry's low bits as it stands. Codes of at most 16 bits (prefix up to
// 8): two codes never take more than the 32 bits of one top-up, and after
// any two codes at least 16 bits are left, so the next window never waits
// for the top-up. A symbol's loop-carried chain is: mask the buffer's low
// bits, form the table address (one LEA from the lane's table base), load
// the entry from shared memory, shift.

constexpr int kMaxPrefix = 8;
// Symbols per block: the unit of the fast/exact choice and of the stores.
constexpr int kBlockSyms = 32;

// Bytes of the stacked window tables of n_schemes schemes.
__host__ __device__ constexpr int64_t window_table_bytes(int n_schemes, int prefix_bits) {
  return static_cast<int64_t>(n_schemes) << (prefix_bits + 9);
}

// A chunk's scheme slot, clamped into [0, n_schemes) as XLA clamps a
// dynamic index: ids past the stacked tables never read outside them.
__device__ __forceinline__ int scheme_slot(const int32_t* __restrict__ sid, int64_t row,
                                           int n_schemes) {
  const int s = sid != nullptr ? __ldg(sid + row) : 0;
  return s < 0 ? 0 : (s >= n_schemes ? n_schemes - 1 : s);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The table entry of `window` in the table at shared address `tab`.
__device__ __forceinline__ uint32_t lookup(uint32_t tab, uint32_t window, uint32_t imask) {
  uint16_t e;
  asm("ld.shared.u16 %0, [%1];" : "=h"(e) : "r"(tab + ((window & imask) << 1)));
  return e;
}

// Words of a thread's ring: a 256-symbol chunk's slot of up to 125 words
// (89 at 11-bit codes) is whole after the prologue, so its blocks issue
// no copies (a block's copies delay the shared-memory loads after them).
constexpr int kRingWords = 128;

// K4's word source: a per-thread ring of 128 words in shared memory, fed
// by 16-byte cp.async copies. Word i of the slot sits at ring slot
// (g0 + i) mod 128, its index from the 16-byte aligned base `words`, so
// an aligned piece of the tensor lands aligned. The prologue copies words
// [0, 125); at each block boundary every thread copies the 16 words
// [cursor + 109, cursor + 125) of its slot (both cut at the slot's end,
// widened to 16-byte pieces, up to 3 more words each side; zero-filled
// past the tensor's end), and waits for the copies of two blocks ago. A
// block of codes of at most m bits reads words below cursor + m + 5 (the
// buffer and the words read ahead), which the copies waited for hold for
// m <= 40, and the copies never overwrite a word at or past the cursor.
// Past the slot, words read as its last.
struct WordRing {
  const uint32_t* words;
  uint32_t* ring;
  uint64_t g0, gend;  // the slot's first word and the tensor's end, from `words`
  uint32_t cw;
  uint32_t r0;        // g0 mod 64: the ring slot of the slot's word 0

  // Copy words [lo, hi) of the slot (none past its end: reads past it
  // return its last word, which the copies bring with the slot).
  __device__ __forceinline__ void fill(uint32_t lo, uint32_t hi) const {
    hi = min(hi, cw);
    for (uint64_t m = (g0 + lo) & ~3ull; m < g0 + hi && m < gend; m += 4) {
      const size_t valid = m + 4 <= gend ? 16 : static_cast<size_t>(gend - m) * 4;
      __pipeline_memcpy_async(ring + (m & (kRingWords - 1)), words + m, 16, 16 - valid);
    }
  }
  __device__ __forceinline__ const uint32_t* ptr(uint32_t i) const {
    return ring + ((r0 + min(i, cw - 1u)) & (kRingWords - 1));
  }
  __device__ __forceinline__ uint32_t operator()(uint32_t i) const { return *ptr(i); }
  // Warp-uniform: wait for the copies issued two blocks ago, issue the next.
  __device__ __forceinline__ void next_block(bool active, uint32_t bitpos) const {
    if (active) {
      __pipeline_wait_prior(1);
      fill((bitpos >> 5) + kRingWords - 19, (bitpos >> 5) + kRingWords - 3);
    }
    __pipeline_commit();
  }
};

// K5's word source: the slot staged whole in shared memory.
struct StagedWords {
  const uint32_t* w;
  uint32_t cw;
  __device__ __forceinline__ const uint32_t* ptr(uint32_t i) const { return w + min(i, cw - 1u); }
  __device__ __forceinline__ uint32_t operator()(uint32_t i) const { return *ptr(i); }
  __device__ __forceinline__ void next_block(bool, uint32_t) const {}
};

// The bit buffer: lo holds the stream's next 32 bits, mid and hi the 64
// after; nbuf of the 96 are valid.
struct BitCursor {
  uint32_t lo = 0u, mid = 0u, hi = 0u, nbuf = 96u;
  uint32_t nw = 3u;     // words appended so far
  uint32_t nextw = 0u;  // the next word to append, read one top-up ahead
  const uint32_t* nextp = nullptr;  // where the word after it lies

  template <class Words>
  __device__ __forceinline__ void start(const Words& wr) {
    lo = wr(0u);
    mid = wr(1u);
    hi = wr(2u);
    nextw = wr(3u);
    nextp = wr.ptr(4u);
  }
  __device__ __forceinline__ uint32_t bitpos() const { return 32u * nw - nbuf; }
  // Drop the code whose table entry is e.
  __device__ __forceinline__ void drop(uint32_t e) {
    lo = __funnelshift_r(lo, mid, e);
    mid = __funnelshift_r(mid, hi, e);
    hi = __funnelshift_r(hi, 0u, e);
    nbuf -= e & 31u;
  }
  // After two codes (nbuf >= 16): top up by a word while it fits, so that
  // at least 48 bits are valid. The bits it adds lie at or above bit 16,
  // so the next window can be read from lo as it was. The read of the
  // word after waits only for the decision, its address made a top-up
  // ahead.
  template <class Words>
  __device__ __forceinline__ void refill(const Words& wr) {
    const bool r = nbuf <= 64u;
    const uint32_t add = r ? nextw : 0u;
    const bool low = nbuf < 32u;
    const uint32_t s = low ? nbuf : nbuf - 32u;
    const uint32_t up = __funnelshift_lc(0u, add, s);  // add << s, 0 at 32
    const uint32_t down = __funnelshift_lc(add, 0u, s);  // add >> (32 - s)
    lo |= low ? up : 0u;
    mid |= low ? down : up;
    hi |= low ? 0u : down;
    nbuf += r ? 32u : 0u;
    if (r) {
      nextw = *nextp;
      nw += 1u;
      nextp = wr.ptr(nw + 1u);
    }
  }
  // The reference's window at the cursor: the buffer while the cursor lies
  // in the slot (the second word clamps to the last, as the buffer was fed),
  // past it a first word of all ones and the last word as the second.
  __device__ __forceinline__ uint32_t exact_window(uint32_t cw, uint32_t wlast) const {
    const uint32_t pos = bitpos();
    const uint32_t shift = pos & 31u;
    return pos < 32u * cw ? lo
                          : (0xffffffffu >> shift) | (shift == 0u ? 0u : wlast << (32u - shift));
  }
};

// One block of up to 32 symbols (nq groups of 4) of this lane's chunk,
// packed four to a word into pack[0, nq). kFast: every symbol starts in
// the slot. Each symbol's entry is loaded before the top-up that follows
// the symbol before it (the top-up does not touch the window's bits), so
// the top-up's work waits beside the load, not in front of it.
template <bool kFast, class Words>
__device__ __forceinline__ void decode_block(BitCursor& c, const Words& wr, uint32_t tab,
                                             uint32_t imask, uint32_t cw, uint32_t wlast, int nq,
                                             uint32_t (&pack)[kBlockSyms / 4]) {
  uint32_t e = lookup(tab, kFast ? c.lo : c.exact_window(cw, wlast), imask);
#pragma unroll
  for (int q = 0; q < kBlockSyms / 4; ++q) {
    pack[q] = 0u;
    if (q < nq) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c.drop(e);
        pack[q] |= (e >> 8) << (8 * j);
        e = lookup(tab, kFast ? c.lo : c.exact_window(cw, wlast), imask);
        if (j & 1) c.refill(wr);
      }
    }
  }
}

// Decode symbols [0, k) of this lane's chunk `row` (active lanes only)
// block by block into out [n, k]. Each lane keeps a block's 32 symbols
// in 8 registers and stores them itself: two 16-byte stores when rows
// start 16-byte aligned (k a multiple of 16), else word stores. A block
// whose every symbol starts in the slot (checked warp-wide) reads its
// windows from the buffer; any other takes the exact path. k is a
// multiple of 4, so the last block is whole words. `tab` is the shared
// address of the lane's scheme's table.
template <class Words>
__device__ __forceinline__ void decode_rows(Words& wr, BitCursor& c, bool active, uint32_t cw,
                                            uint32_t wlast, uint32_t tab, uint32_t imask,
                                            uint32_t maxlen, int64_t k, int64_t row,
                                            uint8_t* __restrict__ out) {
  uint8_t* dst = out + (active ? row : 0) * k;
  const bool vec = k % 16 == 0;
  for (int64_t b0 = 0; b0 < k; b0 += kBlockSyms) {
    const int nsym = static_cast<int>(k - b0 < kBlockSyms ? k - b0 : kBlockSyms);
    const uint32_t bitpos = c.bitpos();
    wr.next_block(active, bitpos);
    const bool fast = __all_sync(
        kFull, !active || bitpos + static_cast<uint32_t>(nsym - 1) * maxlen < 32u * cw);
    if (active) {
      uint32_t pack[kBlockSyms / 4];
      if (fast) {
        decode_block<true>(c, wr, tab, imask, cw, wlast, nsym / 4, pack);
      } else {
        decode_block<false>(c, wr, tab, imask, cw, wlast, nsym / 4, pack);
      }
      if (vec && nsym == kBlockSyms) {
        uint4* d = reinterpret_cast<uint4*>(dst + b0);
        d[0] = make_uint4(pack[0], pack[1], pack[2], pack[3]);
        d[1] = make_uint4(pack[4], pack[5], pack[6], pack[7]);
      } else {
        uint32_t* d = reinterpret_cast<uint32_t*>(dst + b0);
#pragma unroll
        for (int q = 0; q < kBlockSyms / 4; ++q)
          if (4 * q < nsym) d[q] = pack[q];
      }
    }
  }
}

}  // namespace qlc
