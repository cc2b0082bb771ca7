// Device code shared by the codes kernels K3 (qlc_encode.cu), K4
// (qlc_decode.cu) and K5 (qlc_prefetch.cu): the encoder's CTA-wide scan
// and word packing, the decoder's cursor step, and the warp's staged
// store of decoded symbols.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qlc {

constexpr unsigned kFull = 0xffffffffu;

// Symbols a warp stages per chunk before it stores them (32 lanes x 4 B).
constexpr int kTileSyms = 128;
// Row stride of the staging tile: 132 B puts lane l's row 33*l words in,
// so the per-symbol byte writes of 32 lanes fall on 32 banks.
constexpr int kTileStride = kTileSyms + 4;

// Exclusive offset of this thread's code in the chunk, from a CTA-wide
// scan of the code lengths in element order. `s_warp` holds one slot per
// warp, `carry` the bits of earlier passes. Ends with the CTA in sync.
__device__ __forceinline__ uint32_t cta_exclusive_offset(uint32_t len, uint32_t carry,
                                                         uint32_t* s_warp,
                                                         uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t incl = len;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < nwarps ? s_warp[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += t;
    }
    if (lane < nwarps) s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[nwarps - 1];
  return carry + (warp > 0 ? s_warp[warp - 1] : 0u) + incl - len;
}

// Add a code of <= 11 bits at bit offset `off` into the slot. Word
// indices clamp to cap-1, the second one from the clamped first, and the
// adds wrap mod 2^32: the reference's scatter-add, over capacity too.
__device__ __forceinline__ void pack_code(uint32_t* s_words, int cap, uint32_t off,
                                          uint32_t code) {
  const uint32_t shift = off & 31u;
  const int widx = min(static_cast<int>(off >> 5), cap - 1);
  const int hidx = min(widx + 1, cap - 1);
  atomicAdd(&s_words[widx], code << shift);
  atomicAdd(&s_words[hidx], shift == 0u ? 0u : code >> (32u - shift));
}

// One cursor step: read the bit window at `bitpos`, take the area code,
// its payload bits and first rank from the chunk's scheme LUTs, return
// the symbol of that rank and advance the cursor. A first word past the
// slot reads all ones (the reference gather's fill); the second word
// clamps to the last one; the rank clamps to 255.
template <typename Words>
__device__ __forceinline__ uint32_t decode_symbol(const Words& wr, uint32_t cw,
                                                  uint32_t& bitpos,
                                                  const int32_t* __restrict__ dec,
                                                  const int32_t* __restrict__ sb,
                                                  const int32_t* __restrict__ st,
                                                  int prefix_bits) {
  const uint32_t widx = bitpos >> 5;
  const uint32_t shift = bitpos & 31u;
  const uint32_t w0 = widx < cw ? wr[widx] : 0xffffffffu;
  const uint32_t w1 = wr[min(widx + 1u, cw - 1u)];
  const uint32_t window = (w0 >> shift) | (shift == 0u ? 0u : (w1 << (32u - shift)));
  const uint32_t area = window & ((1u << prefix_bits) - 1u);
  const uint32_t nb = static_cast<uint32_t>(sb[area]);
  const uint32_t payload = (window >> prefix_bits) & ((1u << nb) - 1u);
  const uint32_t rank = static_cast<uint32_t>(st[area]) + payload;
  bitpos += static_cast<uint32_t>(prefix_bits) + nb;
  return static_cast<uint32_t>(dec[min(rank, 255u)]);
}

// The warp's 32 chunks have decoded symbols [base, base + w) into
// `tile` (one row per lane). Store them row by row: lane l writes bytes
// [4l, 4l + 4) of each row, so one store covers 128 consecutive bytes.
// k and base are multiples of 4, so the u32 stores are aligned.
__device__ __forceinline__ void store_tile(uint8_t (*tile)[kTileStride], int64_t base_row,
                                           int64_t n, int64_t k, int64_t base, int w,
                                           uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (4 * lane < w) {
    for (int c = 0; c < 32; ++c) {
      const int64_t rc = base_row + c;
      if (rc >= n) break;
      const uint32_t v = *reinterpret_cast<const uint32_t*>(&tile[c][4 * lane]);
      *reinterpret_cast<uint32_t*>(out + rc * k + base + 4 * lane) = v;
    }
  }
  __syncwarp();
}

}  // namespace qlc
