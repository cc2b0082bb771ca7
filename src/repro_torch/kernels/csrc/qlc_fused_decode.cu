// K2: fused QLC decode -> e4m3 dequantize (-> accumulate), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/qlc_fused.py::fused_decode_pallas
// (body _fused_decode_kernel). Plain version: repro_torch/kernels/ref.py
// ::decode_dequantize_ref, which the kernel matches bit for bit.
//
// Bound on the H100: memory. Per symbol it reads the slot's words (about
// 0.9 B at the path's slots) and 1/8 B of scales and writes 4 B (f32) or
// 2 B (bf16); the accumulate form also reads 4 B of acc. The floor is
// bytes / 3.35 TB/s.
//
// Design: one thread per chunk, 32 chunks per warp (a warp tile), warps
// independent of each other, CTAs of 4 warps, at most 4 CTAs per SM.
//  - Decode table: for each scheme, the value and code length of every
//    (prefix + 8)-bit window (the area code and the widest payload), two
//    bytes each, built in shared memory by each CTA from the area tables:
//    value = vtab[dec_lut[min(first rank + payload, 255)]], an e4m3 value
//    kept as its sign, rebased 5-bit f32 exponent and 3 mantissa bits,
//    length in the low 5 bits. One lookup per symbol then replaces the
//    area, width, rank and value lookups, and the cursor's loop-carried
//    chain is buffer -> table -> funnel shift (which reads the length
//    from the entry's low bits as it stands). A scheme takes 2^(prefix +
//    9) bytes: 4 KiB at the paper's 3-bit prefix, 128 KiB at the widest
//    prefix taken, 8 bits (codes of up to 16 bits). Stacked schemes whose
//    tables do not fit the CTA's shared memory are refused.
//  - Words: each thread keeps a 64-bit bit buffer in two registers, topped
//    up one word per
//    32 bits consumed, checked every second symbol (two codes take at most
//    32 bits). The top-up reads a per-thread ring of R words in shared
//    memory (R = 32 for codes of up to 13 bits, else 64). At each
//    32-symbol block boundary every thread copies the 16 words
//    [cursor + R - 19, cursor + R - 3) of its slot into the ring with
//    16-byte cp.async copies (aligned on the word's global index, so up to
//    3 more words on each side; zero-filled past the tensor's end), waited
//    for one block later. A block of codes of at most m bits reads words
//    below cursor + m + 3, which those copies hold for m <= (R - 6) / 2,
//    and the copies never overwrite a word at or past the cursor. So the
//    words come in long before they are used, at warp-uniform points. A
//    global load per top-up would instead make every lane of the warp
//    wait for the newest outstanding load into the shared register, a
//    memory latency per step (about 1 symbol per cycle per SM).
//  - Cursor: while every symbol of a block starts before the slot's end
//    (checked warp-wide per block), the reference's window is the stream's
//    next 32 bits with the last word repeated after the slot (the second
//    word clamps to cw-1), and the buffer supplies it. Otherwise the block
//    takes the exact path: past the slot the reference reads a first word
//    of all ones and the last word as the second (shift == 0 guarded), so
//    over-capacity and corrupted slots decode to the same values.
//  - Values: __fmul_rn(value, scale), the scale loaded one block ahead
//    (the value rebuilt exactly from its table entry).
//    The accumulate form adds with __fadd_rn: no FMA, so the product is
//    rounded to f32 first, as in the reference.
//  - Stores: each lane decodes one 32-symbol block of its chunk into a
//    per-warp 32 x 36 shared-memory tile with 16-byte writes, and the warp
//    writes the tile out four rows per instruction with 16-byte stores
//    (bf16: 8 bytes after __float2bfloat16_rn).
//
// Scheme slots are clamped into [0, S) (qlc::scheme_slot), so ids left
// on the card unchecked never read outside the stacked tables. K4 and K5
// run a later form of this decode core, written once in qlc_codes.cuh;
// this kernel keeps its own.
//
// What still keeps it from its bound: the output stream (the bf16 form,
// half the bytes written after the same decode, takes three quarters of
// the f32 time); each chunk's decode is serial, so the cursor's chain (a
// table lookup and a funnel shift per symbol) is hidden only by the 16
// warps of an SM; and at small n the grid is nearly empty (n / 32 warps).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "qlc_codes.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kTileStride = 36;  // floats per row of the store tile (16 B aligned rows)
constexpr int kMaxPrefix = 8;    // codes of at most 16 bits: two per top-up
// CTAs per SM at most: more warps slow the output stream (2.33 against
// 2.12 ms at the slice's w_in with five CTAs against four on the H100).
constexpr int kCtasPerSm = 4;

enum OutKind { kF32 = 0, kBF16 = 1, kAccF32 = 2 };

// Words of a thread's ring: enough lead for codes of up to prefix + 8 bits.
__host__ __device__ constexpr int ring_words(int prefix_bits) {
  return prefix_bits + 8 <= 13 ? 32 : 64;
}
// Shared memory of one warp: the store tile and 32 rings at a stride of
// R + 4 words (16 B aligned rows, lanes spread over the banks).
__host__ __device__ constexpr int warp_bytes(int prefix_bits) {
  return 32 * kTileStride * 4 + 32 * (ring_words(prefix_bits) + 4) * 4;
}
__host__ __device__ constexpr int64_t table_bytes(int n_schemes, int prefix_bits) {
  return ((static_cast<int64_t>(n_schemes) << (prefix_bits + 9)) + 15) / 16 * 16;
}

// Two f32 values rounded to bf16 (nearest even), low half first.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

template <int OUT>
__global__ void __launch_bounds__(32 * kWarps)
    fused_decode_kernel(const uint32_t* __restrict__ words, int64_t n, int cw,
                        const float* __restrict__ scales, const int32_t* __restrict__ sid,
                        const int32_t* __restrict__ dec_lut, const int32_t* __restrict__ area_sb,
                        const int32_t* __restrict__ area_st, int n_schemes, int n_area,
                        int prefix_bits, const float* __restrict__ vtab, int64_t k,
                        const float* __restrict__ acc, void* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int R = ring_words(prefix_bits);
  uint16_t* s_tab = reinterpret_cast<uint16_t*>(smem);
  uint8_t* wbase = smem + table_bytes(n_schemes, prefix_bits) + warp * warp_bytes(prefix_bits);
  float* tile = reinterpret_cast<float*>(wbase);
  uint32_t* ring = reinterpret_cast<uint32_t*>(wbase + 32 * kTileStride * 4) + lane * (R + 4);

  const int64_t base_row = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * 32;
  const int rows = static_cast<int>(n - base_row < 32 ? (n - base_row > 0 ? n - base_row : 0)
                                                      : 32);
  const int64_t row = base_row + lane;
  const bool active = lane < rows;
  const uint32_t ucw = static_cast<uint32_t>(cw);
  const uint32_t rmask = static_cast<uint32_t>(R - 1);
  // Ring slot of word i of this slot: its global index mod R, so that a
  // 16-byte aligned piece of the words lands 16-byte aligned.
  const uint64_t g0 = static_cast<uint64_t>(active ? row : 0) * ucw;
  const uint64_t gend = static_cast<uint64_t>(n) * ucw;
  auto fill = [&](uint32_t lo, uint32_t hi) {  // words [lo, hi) of the slot
    for (uint64_t m = (g0 + lo) & ~3ull; m < g0 + hi && m < gend; m += 4) {
      const size_t valid = m + 4 <= gend ? 16 : static_cast<size_t>(gend - m) * 4;
      __pipeline_memcpy_async(ring + (m & rmask), words + m, 16, 16 - valid);
    }
  };
  if (active) fill(0, R - 3);
  __pipeline_commit();

  const int tbits = prefix_bits + 8;
  const uint32_t pmask = (1u << prefix_bits) - 1u;
  const uint32_t imask = (1u << tbits) - 1u;
  for (int i = threadIdx.x; i < (n_schemes << tbits); i += blockDim.x) {
    const int s = i >> tbits;
    const uint32_t w = static_cast<uint32_t>(i) & imask;
    const int a = s * n_area + static_cast<int>(w & pmask);
    const uint32_t sb = static_cast<uint32_t>(__ldg(area_sb + a));
    const uint32_t payload = (w >> prefix_bits) & ((1u << sb) - 1u);
    const uint32_t rank = min(static_cast<uint32_t>(__ldg(area_st + a)) + payload, 255u);
    const uint32_t vb = __float_as_uint(__ldg(vtab + (__ldg(dec_lut + s * 256 + rank) & 255)));
    const uint32_t ex = (vb >> 23) & 255u;
    s_tab[i] = static_cast<uint16_t>(((vb >> 31) << 13) | ((ex != 0u ? ex - 117u : 0u) << 8) |
                                     (((vb >> 20) & 7u) << 5) |
                                     (static_cast<uint32_t>(prefix_bits) + sb));
  }
  __syncthreads();
  if (rows == 0) return;

  const int s = active ? qlc::scheme_slot(sid, row, n_schemes) : 0;
  const uint16_t* tab = s_tab + (s << tbits);
  uint32_t maxlen = 0;
  for (int a = 0; a < n_area; ++a)
    maxlen = max(maxlen, static_cast<uint32_t>(__ldg(area_sb + s * n_area + a)));
  maxlen += static_cast<uint32_t>(prefix_bits);
  const int64_t n_blocks = k / 32;

  __pipeline_wait_prior(0);
  // Past the slot, words read as the last one (the reference's clamp).
  auto rd = [&](uint32_t i) -> uint32_t { return ring[(g0 + min(i, ucw - 1u)) & rmask]; };
  const uint32_t wlast = active ? __ldg(words + g0 + ucw - 1u) : 0u;
  // The bit buffer, 64 bits in two words: lo holds the next 32.
  uint32_t lo = rd(0), hi = rd(1);
  uint32_t nbuf = 64u;
  uint32_t nw = 2u;  // words appended to the buffer
  uint32_t nextw = rd(2);
  float sc_next = active ? __ldg(scales + row * n_blocks) : 0.0f;

  // One symbol: value times the block's scale; the buffer drops its code.
  // The funnel shifts take the code length as the entry's low 5 bits, so
  // the cursor's chain is load -> shift. The value's f32 bits: sign, and
  // exponent and mantissa as a normal number 2^117 times too small
  // (exact, and exactly undone by the first multiply).
  auto decode = [&](uint32_t window, float sc) -> float {
    const uint32_t e = tab[window & imask];
    lo = __funnelshift_r(lo, hi, e);
    hi = __funnelshift_r(hi, 0u, e);
    nbuf -= e & 31u;
    const float v = __uint_as_float(((e & 0x2000u) << 18) | ((e & 0x1fe0u) << 15));
    return __fmul_rn(__fmul_rn(v, 0x1p117f), sc);
  };
  // Top up to at least 33 bits: enough for two codes.
  auto refill = [&]() {
    const bool r = nbuf <= 32u;
    const uint32_t add = r ? nextw : 0u;
    lo |= __funnelshift_lc(0u, add, nbuf);   // add << nbuf, 0 at 32
    hi |= __funnelshift_lc(add, 0u, nbuf);   // add >> (32 - nbuf)
    nbuf += r ? 32u : 0u;
    nw += r ? 1u : 0u;
    if (r) nextw = rd(nw);
  };

  for (int64_t blk = 0; blk < n_blocks; ++blk) {
    const float sc = sc_next;
    const uint32_t bitpos = 32u * nw - nbuf;
    if (active) {
      if (blk + 1 < n_blocks) sc_next = __ldg(scales + row * n_blocks + blk + 1);
      // This block reads words the copies issued up to one block ago hold;
      // issue the ones the next block may need.
      __pipeline_wait_prior(0);
      fill((bitpos >> 5) + R - 19, (bitpos >> 5) + R - 3);
    }
    __pipeline_commit();
    const bool fast = __all_sync(kFull, !active || bitpos + 31u * maxlen < 32u * ucw);
    if (active) {
      if (fast) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float v4[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v4[j] = decode(lo, sc);
            if (j & 1) refill();
          }
          *reinterpret_cast<float4*>(tile + lane * kTileStride + 4 * q) =
              make_float4(v4[0], v4[1], v4[2], v4[3]);
        }
      } else {
        for (int q = 0; q < 8; ++q) {
          float v4[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t pos = 32u * nw - nbuf;
            const uint32_t shift = pos & 31u;
            const uint32_t window =
                pos < 32u * ucw ? lo
                                : (0xffffffffu >> shift) |
                                      (shift == 0u ? 0u : wlast << (32u - shift));
            v4[j] = decode(window, sc);
            if (j & 1) refill();
          }
          *reinterpret_cast<float4*>(tile + lane * kTileStride + 4 * q) =
              make_float4(v4[0], v4[1], v4[2], v4[3]);
        }
      }
    }
    __syncwarp();
    // Four rows per instruction: lanes 8r..8r+7 write row 4i + r, 16 B each.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 4 * i + (lane >> 3);
      if (c < rows) {
        const int q = lane & 7;
        const float4 v = *reinterpret_cast<const float4*>(tile + c * kTileStride + 4 * q);
        const int64_t idx = (base_row + c) * k + blk * 32 + 4 * q;
        if (OUT == kF32) {
          *reinterpret_cast<float4*>(static_cast<float*>(out) + idx) = v;
        } else if (OUT == kBF16) {
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + idx) =
              make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
        } else {
          const float4 a = *reinterpret_cast<const float4*>(acc + idx);
          *reinterpret_cast<float4*>(static_cast<float*>(out) + idx) =
              make_float4(__fadd_rn(a.x, v.x), __fadd_rn(a.y, v.y), __fadd_rn(a.z, v.z),
                          __fadd_rn(a.w, v.w));
        }
      }
    }
    __syncwarp();
  }
}

template <int OUT>
int launch(const void* words, int64_t n, int cw, const void* scales, const void* sid,
           const void* dec_lut, const void* area_sb, const void* area_st, int n_schemes,
           int n_area, int prefix_bits, const void* vtab, int64_t k, const void* acc, void* out,
           cudaStream_t stream) {
  auto kernel = fused_decode_kernel<OUT>;
  int64_t smem = table_bytes(n_schemes, prefix_bits) + kWarps * warp_bytes(prefix_bits);
  int dev = 0, optin = 0, per_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  // Ask for enough that at most kCtasPerSm CTAs share an SM.
  const int64_t share = per_sm / kCtasPerSm - reserved;
  if (smem < share) smem = share;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (n + 31) / 32;
  kernel<<<dim3(static_cast<unsigned>((tiles + kWarps - 1) / kWarps)), 32 * kWarps,
           static_cast<size_t>(smem), stream>>>(
      static_cast<const uint32_t*>(words), n, cw, static_cast<const float*>(scales),
      static_cast<const int32_t*>(sid), static_cast<const int32_t*>(dec_lut),
      static_cast<const int32_t*>(area_sb), static_cast<const int32_t*>(area_st), n_schemes,
      n_area, prefix_bits, static_cast<const float*>(vtab), k, static_cast<const float*>(acc),
      out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). out_kind: 0 f32,
// 1 bf16, 2 f32 accumulate (acc + value); words, out and acc 16-byte
// aligned; prefix_bits at most 8, n_area = 2^prefix_bits and payload
// widths at most 8 bits (codes of at most 16 bits); vtab holds e4m3
// values (at most 4 significant bits, magnitudes 0 or in [2^-9, 2^22)). cudaErrorInvalidValue (1) also when the schemes'
// decode tables (2^(prefix_bits + 9) bytes each) and the warps' buffers
// pass the CTA's shared memory.
extern "C" int qlc_fused_decode(const void* words, int64_t n, int cw, const void* scales,
                                const void* sid, const void* dec_lut, const void* area_sb,
                                const void* area_st, int n_schemes, int n_area,
                                int prefix_bits, const void* vtab, int64_t k, const void* acc,
                                void* out, int out_kind, void* stream) {
  if (n == 0) return 0;
  if (cw < 1 || k % 32 != 0 || n_schemes < 1 || prefix_bits < 0 || prefix_bits > kMaxPrefix ||
      n_area != (1 << prefix_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case kF32:
      return launch<kF32>(words, n, cw, scales, sid, dec_lut, area_sb, area_st, n_schemes,
                          n_area, prefix_bits, vtab, k, acc, out, s);
    case kBF16:
      return launch<kBF16>(words, n, cw, scales, sid, dec_lut, area_sb, area_st, n_schemes,
                           n_area, prefix_bits, vtab, k, acc, out, s);
    case kAccF32:
      return launch<kAccF32>(words, n, cw, scales, sid, dec_lut, area_sb, area_st, n_schemes,
                             n_area, prefix_bits, vtab, k, acc, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
