// K2: fused QLC decode -> e4m3 dequantize (-> accumulate), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/qlc_fused.py::fused_decode_pallas
// (body _fused_decode_kernel). Plain version: repro_torch/kernels/ref.py
// ::decode_dequantize_ref, which the kernel matches bit for bit.
//
// Bound on the H100: memory. Per symbol it reads about 0.9 B of words
// and 1/8 B of scales and writes 4 B (f32) or 2 B (bf16); the accumulate
// form also reads 4 B of acc. The floor is bytes / 3.35 TB/s.
//
// Design: one thread per chunk, 32 chunks per warp. Each thread walks
// its chunk with the paper's O(1) step: the 3-bit area code gives the
// payload bits and the area's first rank from the stacked per-scheme
// LUTs (scheme slot per chunk), the rank indexes dec_lut, and the
// symbol's e4m3 value is multiplied by the block scale with __fmul_rn.
// All LUTs and the 256-entry value table sit in shared memory. The
// cursor guards shift == 0 before `w1 << (32 - shift)` (a shift by 32
// is undefined), clamps the second word to cw-1 and the rank to 255,
// and reads the reference gather's fill (all ones) for a first word
// past the slot. The accumulate form adds with __fadd_rn: no FMA, so the
// product is rounded to f32 first, as in the reference.
//
// What this simple design leaves on the table: the decode is serial per
// chunk, and each thread reads its own chunk's words, so word loads are
// strided across a warp. One thread per chunk would also make the
// stores strided (4 KiB apart); the warp instead decodes one 32-symbol
// block per chunk into a shared-memory tile and writes it out row by
// row, 32 consecutive values per store.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;

enum OutKind { kF32 = 0, kBF16 = 1, kAccF32 = 2 };

template <int OUT>
__global__ void fused_decode_kernel(const uint32_t* __restrict__ words, int64_t n, int cw,
                                    const float* __restrict__ scales,
                                    const int32_t* __restrict__ sid,
                                    const int32_t* __restrict__ dec_lut,
                                    const int32_t* __restrict__ area_sb,
                                    const int32_t* __restrict__ area_st, int n_schemes,
                                    int n_area, int prefix_bits,
                                    const float* __restrict__ vtab, int64_t k,
                                    const float* __restrict__ acc, void* __restrict__ out) {
  extern __shared__ int32_t s_luts[];
  __shared__ float s_val[256];
  __shared__ float s_tile[kWarps][32][33];
  int32_t* s_dec = s_luts;
  int32_t* s_sb = s_dec + n_schemes * 256;
  int32_t* s_st = s_sb + n_schemes * n_area;

  const int tid = threadIdx.x;
  for (int i = tid; i < n_schemes * 256; i += blockDim.x) s_dec[i] = dec_lut[i];
  for (int i = tid; i < n_schemes * n_area; i += blockDim.x) {
    s_sb[i] = area_sb[i];
    s_st[i] = area_st[i];
  }
  for (int i = tid; i < 256; i += blockDim.x) s_val[i] = vtab[i];
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t base_row = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * 32;
  const int64_t row = base_row + lane;
  const bool active = row < n;
  const uint32_t* wr = words + (active ? row : 0) * cw;
  const int s = active ? sid[row] : 0;
  const uint32_t pmask = (1u << prefix_bits) - 1u;
  const int64_t n_blocks = k / 32;
  uint32_t bitpos = 0u;
  float(*tile)[33] = s_tile[warp];

  for (int64_t blk = 0; blk < n_blocks; ++blk) {
    const float sc = active ? scales[row * n_blocks + blk] : 0.0f;
    for (int j = 0; j < 32; ++j) {
      float val = 0.0f;
      if (active) {
        const uint32_t widx = bitpos >> 5;
        const uint32_t shift = bitpos & 31u;
        const uint32_t w0 = widx < static_cast<uint32_t>(cw) ? wr[widx] : 0xffffffffu;
        const uint32_t w1 = wr[min(widx + 1u, static_cast<uint32_t>(cw - 1))];
        const uint32_t window = (w0 >> shift) | (shift == 0u ? 0u : (w1 << (32u - shift)));
        const uint32_t area = window & pmask;
        const uint32_t sb = static_cast<uint32_t>(s_sb[s * n_area + area]);
        const uint32_t payload = (window >> prefix_bits) & ((1u << sb) - 1u);
        const uint32_t rank = static_cast<uint32_t>(s_st[s * n_area + area]) + payload;
        const int sym = s_dec[s * 256 + min(rank, 255u)];
        val = __fmul_rn(s_val[sym], sc);
        bitpos += static_cast<uint32_t>(prefix_bits) + sb;
      }
      tile[lane][j] = val;
    }
    __syncwarp();
    for (int c = 0; c < 32; ++c) {
      const int64_t rc = base_row + c;
      if (rc < n) {
        const float v = tile[c][lane];
        const int64_t idx = rc * k + blk * 32 + lane;
        if (OUT == kF32) {
          static_cast<float*>(out)[idx] = v;
        } else if (OUT == kBF16) {
          static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
        } else {
          static_cast<float*>(out)[idx] = __fadd_rn(acc[idx], v);
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). out_kind: 0 f32,
// 1 bf16, 2 f32 accumulate (acc + value). The stacked LUTs take
// n_schemes * (256 + 2 * n_area) * 4 bytes of dynamic shared memory.
extern "C" int qlc_fused_decode(const void* words, int64_t n, int cw, const void* scales,
                                const void* sid, const void* dec_lut, const void* area_sb,
                                const void* area_st, int n_schemes, int n_area,
                                int prefix_bits, const void* vtab, int64_t k, const void* acc,
                                void* out, int out_kind, void* stream) {
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(n_schemes) * (256 + 2 * n_area) * sizeof(int32_t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows_per_cta = 32 * kWarps;
  const dim3 grid(static_cast<unsigned>((n + rows_per_cta - 1) / rows_per_cta));
  const dim3 block(32 * kWarps);
#define QLC_DECODE_LAUNCH(KIND)                                                          \
  fused_decode_kernel<KIND><<<grid, block, smem, s>>>(                                   \
      static_cast<const uint32_t*>(words), n, cw, static_cast<const float*>(scales),     \
      static_cast<const int32_t*>(sid), static_cast<const int32_t*>(dec_lut),            \
      static_cast<const int32_t*>(area_sb), static_cast<const int32_t*>(area_st),        \
      n_schemes, n_area, prefix_bits, static_cast<const float*>(vtab), k,                \
      static_cast<const float*>(acc), out)
  switch (out_kind) {
    case kF32:
      QLC_DECODE_LAUNCH(kF32);
      break;
    case kBF16:
      QLC_DECODE_LAUNCH(kBF16);
      break;
    case kAccF32:
      QLC_DECODE_LAUNCH(kAccF32);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QLC_DECODE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
