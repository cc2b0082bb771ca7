// K1: fused block-32 e4m3 quantize -> QLC encode, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/qlc_fused.py::fused_encode_pallas
// (body _fused_encode_kernel, helpers _e4m3_bits_encode, _quantize_tile,
// _pack_codes). Plain version: repro_torch/kernels/ref.py
// ::quantize_encode_ref, which the kernel matches bit for bit.
//
// Bound on the H100: memory in principle. Per symbol it reads 4 B (f32
// input; 2 B for bf16) and writes the slot's words (up to 1.4 B at
// worst-case slots), 1/8 B of scales and, with codes, 1 B; the floor is
// those bytes over 3.35 TB/s. At that rate the card has about 48 issue
// slots per symbol (132 SMs x 4 schedulers x 32 lanes x ~1.75 GHz over
// ~6e11 symbols/s); a CTA-wide scan with shared-memory atomics per
// symbol spends several times that and is bound by instruction issue.
// This design spends about 30 instructions and no CTA barrier per
// symbol.
//
// Design: persistent CTAs of `threads / 32` independent warps. A warp
// owns one chunk row at a time (chunks gw, gw + all warps, ...) and walks
// it in pieces of 1024 symbols; each lane owns one 32-symbol block of the
// piece.
//  - Inputs: the warp stages each piece into shared memory with 16-byte
//    cp.async copies (coalesced; the wrapper hands in a 16-byte aligned
//    x), double-buffered: the next piece's copy is in flight while this
//    one encodes. Blocks sit at a padded stride (144 B for f32, 80 B for
//    bf16), so the 16-byte reads of the 8 lanes of a phase hit distinct
//    banks.
//  - Quantize: each lane takes its block's NaN-propagating amax with no
//    shuffles (a register tree), the scale as __fmul_rn(amax, 1/480) and
//    each element as __fdiv_rn(v, scale), with no fast-math, as the
//    reference's f32 arithmetic. The e4m3 code comes from the hardware's
//    round-to-nearest-even conversion (cvt.rn.satfinite.e4m3x2.f32) with
//    the two places where the formats differ patched (e4m3_code below):
//    one instruction for two elements where the reference's exponent,
//    scaling and rintf take about 20 per element.
//  - Offsets: one packed LUT gather (code | len << 24) per symbol, a
//    serial in-lane sum of the 32 lengths, one 5-step warp scan of the
//    lane totals, and a carry across the pieces of a chunk.
//  - Packing: each lane appends its codes two at a time (at most 32 bits:
//    codes of at most 16 bits: prefix_bits at most 8) to a 64-bit
//    register and emits a word whenever 32 bits are full, into the warp's
//    slot in shared memory. Only a lane's first word (shared with the lane
//    or piece before) and its last, partial word are added with a
//    shared-memory atomicAdd; the words in between belong to the lane
//    alone and are stored. Every word at or past cap-1 is added into word
//    cap-1: the reference's scatter-add clamps both halves of each code
//    there, so that word is the wrapping u32 sum of every virtual word
//    from cap-1 on, and a chunk over capacity stays bit-equal. nbits is
//    the full bit count. (The LUT's codes are below 2^len, so in-lane OR
//    and the reference's add agree.)
//  - Outputs: the finished slot leaves in coalesced u32 stores, scales
//    one 128-byte row per piece, codes as two 16-byte stores per lane.
//    The histogram (a template flag, so the plain call pays nothing for
//    it) is counted in per-warp shared-memory bins (gradient symbols are
//    skewed) and flushed with one global atomicAdd per bin per CTA at the
//    end.
//
// What still keeps it from its bound: the IEEE division (about 10
// instructions per symbol) and the emission branch of the pack, which
// some lane of the warp takes on almost every step; at k < 1024 a warp
// runs only k/32 lanes.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr float kMaxFinite = 480.0f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPiece = 1024;          // symbols a warp stages per step: 32 blocks
constexpr int kLutBytes = 256 * 4;    // packed code | len << 24
constexpr int kSmemTarget = 112 * 1024;  // two CTAs per SM

// Bytes of one staged 32-symbol block: 16 B of padding put the 16-byte
// reads of 8 consecutive lanes on distinct banks.
template <typename T>
struct Stage;
template <>
struct Stage<float> {
  static constexpr int kBlockBytes = 32 * 4 + 16;
};
template <>
struct Stage<__nv_bfloat16> {
  static constexpr int kBlockBytes = 32 * 2 + 16;
};

__host__ __device__ constexpr int cap_pad(int cap) { return (cap + 3) & ~3; }

// Shared memory of one warp: two staged pieces, the slot, and the
// histogram bins when asked for.
__host__ __device__ constexpr int warp_smem_bytes(int block_bytes, int cap, bool hist) {
  return 2 * 32 * block_bytes + 4 * cap_pad(cap) + (hist ? 256 * 4 : 0);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  // jnp.max / torch.amax propagate NaN; fmaxf would drop it.
  return (a > b || isnan(a)) ? a : b;
}

// float32 -> e4m3 code (all-finite eXmY), RTE, saturating at +-480,
// NaN -> max magnitude, sign of zero kept. qlc_fused.py:64-88. The
// hardware's e4m3 (OCP E4M3FN) has the same grid up to 448 and rounds to
// nearest even; it saturates at 448 and keeps 0x7f for NaN, where this
// format has 480. So every |x| above 464 (the tie between 448 and 480,
// which rounds to even 448) and NaN take +-480 (0x7f) instead. Equal to
// the plain version on all 2^32 inputs (chip_smoke.py checks it).
__device__ __forceinline__ uint32_t e4m3_code(float xs) {
  uint16_t pair;
  asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;" : "=h"(pair) : "f"(0.0f), "f"(xs));
  return fabsf(xs) <= 464.0f ? (pair & 0xffu) : (signbit(xs) ? 0xffu : 0x7fu);
}

// The lane's 32 staged inputs, as f32.
__device__ __forceinline__ void load_block(const uint8_t* p, float (&v)[32], float) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint4 u = q[i];
    v[4 * i + 0] = __uint_as_float(u.x);
    v[4 * i + 1] = __uint_as_float(u.y);
    v[4 * i + 2] = __uint_as_float(u.z);
    v[4 * i + 3] = __uint_as_float(u.w);
  }
}
__device__ __forceinline__ void load_block(const uint8_t* p, float (&v)[32], __nv_bfloat16) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 u = q[i];
    const uint32_t h[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j] = __uint_as_float(h[j] << 16);             // bf16 -> f32 is exact
      v[8 * i + 2 * j + 1] = __uint_as_float(h[j] & 0xffff0000u);
    }
  }
}

// Copy piece `pass` of chunk `row` into a stage buffer, as one commit
// group: 16-byte copies, consecutive lanes on consecutive source bytes.
template <typename T>
__device__ __forceinline__ void issue_piece(const T* __restrict__ x, int64_t row, int64_t k,
                                            int64_t pass, uint8_t* dst, int lane) {
  constexpr int kPer16 = 16 / sizeof(T);
  const int64_t e0 = pass * kPiece;
  const int elems = static_cast<int>(k - e0 < kPiece ? k - e0 : kPiece);
  const uint8_t* src = reinterpret_cast<const uint8_t*>(x + row * k + e0);
  for (int u = lane; u < elems / kPer16; u += 32) {
    const int e = u * kPer16;
    __pipeline_memcpy_async(dst + (e >> 5) * Stage<T>::kBlockBytes + (e & 31) * sizeof(T),
                            src + 16 * u, 16);
  }
  __pipeline_commit();
}

template <typename T, bool kHist>
__global__ void __launch_bounds__(256, 2) fused_encode_kernel(const T* __restrict__ x, int64_t n, int64_t k,
                                    const int32_t* __restrict__ enc_code,
                                    const int32_t* __restrict__ enc_len, int cap,
                                    uint32_t* __restrict__ words,
                                    int32_t* __restrict__ nbits,
                                    float* __restrict__ scales,
                                    uint8_t* __restrict__ codes,
                                    int32_t* __restrict__ hist) {
  constexpr int kBB = Stage<T>::kBlockBytes;
  extern __shared__ __align__(16) uint8_t smem[];
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint32_t* s_lut = reinterpret_cast<uint32_t*>(smem);
  uint8_t* s_stage = smem + kLutBytes + warp * warp_smem_bytes(kBB, cap, kHist);
  uint32_t* s_slot = reinterpret_cast<uint32_t*>(s_stage + 2 * 32 * kBB);
  int* s_hist = reinterpret_cast<int*>(s_slot + cap_pad(cap));

  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    s_lut[i] = (static_cast<uint32_t>(enc_code[i]) & 0xffffu) |
               (static_cast<uint32_t>(enc_len[i]) << 24);
  if (kHist)
    for (int i = lane; i < 256; i += 32) s_hist[i] = 0;
  __syncthreads();

  const float inv = __fdiv_rn(1.0f, kMaxFinite);
  const int64_t passes = (k + kPiece - 1) / kPiece;
  const int64_t nb = k / 32;
  const int64_t warp_stride = static_cast<int64_t>(gridDim.x) * nwarps;
  const uint32_t last = static_cast<uint32_t>(cap - 1);

  int64_t row = static_cast<int64_t>(blockIdx.x) * nwarps + warp;
  int64_t pass = 0;
  int buf = 0;
  uint32_t carry = 0;
  if (row < n) issue_piece(x, row, k, 0, s_stage, lane);
  while (row < n) {
    // Prefetch the warp's next piece into the other buffer.
    int64_t nrow = row, npass = pass + 1;
    if (npass == passes) {
      npass = 0;
      nrow += warp_stride;
    }
    if (nrow < n) {
      issue_piece(x, nrow, k, npass, s_stage + (buf ^ 1) * 32 * kBB, lane);
    } else {
      __pipeline_commit();  // an empty group keeps "all but the newest" = this piece
    }
    if (pass == 0) {
      for (int i = 4 * lane; i < cap_pad(cap); i += 128)
        *reinterpret_cast<uint4*>(s_slot + i) = make_uint4(0u, 0u, 0u, 0u);
      carry = 0;
    }
    __pipeline_wait_prior(1);
    __syncwarp();

    // ---- quantize this lane's block ---------------------------------
    const int64_t e0 = pass * kPiece;
    const int nblk = static_cast<int>(k - e0 < kPiece ? (k - e0) >> 5 : 32);
    const bool active = lane < nblk;
    float v[32];
    load_block(s_stage + buf * 32 * kBB + lane * kBB, v, T());
    float m[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) m[j] = nan_max(fabsf(v[j]), fabsf(v[j + 16]));
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = nan_max(m[j], m[j + 8]);
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = nan_max(m[j], m[j + 4]);
    const float amax = nan_max(nan_max(m[0], m[2]), nan_max(m[1], m[3]));
    const float scale = amax > 0.0f ? __fmul_rn(amax, inv) : 1.0f;
    if (active) scales[row * nb + (e0 >> 5) + lane] = scale;

    uint32_t ent[32];
    uint32_t sym4[8];
    uint32_t total = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t sym = e4m3_code(__fdiv_rn(v[j], scale));
      ent[j] = s_lut[sym];
      total += ent[j] >> 24;
      if ((j & 3) == 0) sym4[j >> 2] = 0;
      sym4[j >> 2] |= sym << (8 * (j & 3));
      if (kHist && active) atomicAdd(&s_hist[sym], 1);
    }
    if (!active) total = 0;
    if (codes != nullptr && active) {
      uint4* dst = reinterpret_cast<uint4*>(codes + row * k + e0 + 32 * lane);
      dst[0] = make_uint4(sym4[0], sym4[1], sym4[2], sym4[3]);
      dst[1] = make_uint4(sym4[4], sym4[5], sym4[6], sym4[7]);
    }

    // ---- offsets: warp scan of the lane totals -----------------------
    uint32_t incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const uint32_t off = carry + incl - total;
    carry += __shfl_sync(kFull, incl, 31);

    // ---- pack into the slot, two codes (<= 32 bits) per step ----------
    if (active) {
      uint64_t acc = 0;
      uint32_t nacc = off & 31u;
      uint32_t w = off >> 5;
      bool shared_lo = nacc != 0u;
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const uint32_t len0 = ent[j] >> 24;
        acc |= static_cast<uint64_t>((ent[j] & 0xffffu) | ((ent[j + 1] & 0xffffu) << len0))
               << nacc;
        nacc += len0 + (ent[j + 1] >> 24);
        if (nacc >= 32u) {
          const uint32_t word = static_cast<uint32_t>(acc);
          if (shared_lo || w >= last) {
            atomicAdd(&s_slot[min(w, last)], word);
          } else {
            s_slot[w] = word;
          }
          shared_lo = false;
          acc >>= 32;
          nacc -= 32u;
          ++w;
        }
      }
      if (nacc > 0u) atomicAdd(&s_slot[min(w, last)], static_cast<uint32_t>(acc));
    }

    if (npass == 0) {  // the chunk is done: its slot leaves in coalesced stores
      __syncwarp();
      uint32_t* wr = words + row * cap;
      for (int i = lane; i < cap; i += 32) wr[i] = s_slot[i];
      if (lane == 0) nbits[row] = static_cast<int32_t>(carry);
    }
    __syncwarp();  // this stage buffer is refilled, the slot zeroed, next step
    row = nrow;
    pass = npass;
    buf ^= 1;
  }

  if (kHist) {
    __syncthreads();
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      int c = 0;
      for (int w = 0; w < nwarps; ++w)
        c += reinterpret_cast<const int*>(smem + kLutBytes + w * warp_smem_bytes(kBB, cap, true) +
                                          2 * 32 * kBB + 4 * cap_pad(cap))[i];
      if (c != 0) atomicAdd(&hist[i], c);
    }
  }
}

template <typename T, bool kHist>
int launch(const void* x, int64_t n, int64_t k, const void* enc_code, const void* enc_len,
           int cap, void* words, void* nbits, void* scales, void* codes, void* hist,
           int threads, cudaStream_t stream) {
  auto kernel = fused_encode_kernel<T, kHist>;
  // threads == 0: the most warps (8, 4, 2) whose CTA lets two CTAs share
  // an SM, else 1.
  if (threads == 0) {
    threads = 256;
    while (threads > 32 && kLutBytes + (threads / 32) * warp_smem_bytes(Stage<T>::kBlockBytes,
                                                                         cap, kHist) >
                               kSmemTarget)
      threads /= 2;
  }
  const int smem = kLutBytes + (threads / 32) *
                                   warp_smem_bytes(Stage<T>::kBlockBytes, cap, kHist);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const int64_t warps = threads / 32;
  int64_t grid = (n + warps - 1) / warps;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > resident) grid = resident;
  kernel<<<dim3(static_cast<unsigned>(grid)), threads, smem, stream>>>(
      static_cast<const T*>(x), n, k, static_cast<const int32_t*>(enc_code),
      static_cast<const int32_t*>(enc_len), cap, static_cast<uint32_t*>(words),
      static_cast<int32_t*>(nbits), static_cast<float*>(scales), static_cast<uint8_t*>(codes),
      static_cast<int32_t*>(hist));
  return static_cast<int>(cudaGetLastError());
}

__global__ void e4m3_encode_kernel(const float* __restrict__ x, int64_t n,
                                   uint8_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = static_cast<uint8_t>(e4m3_code(x[i]));
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). `threads` is the
// CTA size, 32 x warps, warps in {1, 2, 4, 8}, or 0 to let the launcher
// pick the most warps whose CTA takes at most 112 KiB; each warp takes
// 2 * 32 * (144 or 80) + 4 * round_up(cap, 4) (+ 1024 with hist) bytes of
// dynamic shared memory, the CTA 1024 more. k is a multiple of 32, codes
// at most 16 bits long and x 16-byte aligned. The caller zeroes `hist`.
extern "C" int qlc_fused_encode(const void* x, int x_is_bf16, int64_t n, int64_t k,
                                const void* enc_code, const void* enc_len, int cap,
                                void* words, void* nbits, void* scales, void* codes,
                                void* hist, int threads, void* stream) {
  if (n == 0) return 0;
  if (threads % 32 != 0 || threads < 0 || threads > 256 || k % 32 != 0 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QLC_ENCODE_LAUNCH(T, H) \
  return launch<T, H>(x, n, k, enc_code, enc_len, cap, words, nbits, scales, codes, hist, threads, s)
  if (x_is_bf16) {
    if (hist != nullptr) QLC_ENCODE_LAUNCH(__nv_bfloat16, true);
    QLC_ENCODE_LAUNCH(__nv_bfloat16, false);
  }
  if (hist != nullptr) QLC_ENCODE_LAUNCH(float, true);
  QLC_ENCODE_LAUNCH(float, false);
#undef QLC_ENCODE_LAUNCH
}

// K1's e4m3 encoder on its own: out[i] = e4m3 code of x[i], for holding it
// against the plain encoder over every f32 bit pattern. Returns the
// cudaError_t of the launch.
extern "C" int qlc_fused_encode_e4m3(const void* x, int64_t n, void* out, void* stream) {
  if (n == 0) return 0;
  e4m3_encode_kernel<<<dim3(static_cast<unsigned>((n + 255) / 256)), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x), n,
                                                            static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
