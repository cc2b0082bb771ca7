// K1: fused block-32 e4m3 quantize -> QLC encode, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/qlc_fused.py::fused_encode_pallas
// (body _fused_encode_kernel, helpers _e4m3_bits_encode, _quantize_tile,
// _pack_codes). Plain version: repro_torch/kernels/ref.py
// ::quantize_encode_ref, which the kernel matches bit for bit.
//
// Bound on the H100: memory. Per symbol it reads 4 B (f32 input; 2 B for
// bf16) and writes about 0.9 B of words plus 1/8 B of scales, with a few
// dozen integer operations in between, far below the card's operation
// rate, so the floor is bytes / 3.35 TB/s.
//
// Design: one CTA per chunk row. Each warp covers one 32-element block,
// so the block amax is a NaN-propagating __shfl_xor max. The scale is
// __fmul_rn(amax, 1/480) and the element scaling __fdiv_rn, with no
// fast-math, as the reference's f32 arithmetic. The e4m3 bits come from
// the exponent field and one rintf (round to nearest even). Code lengths
// go through a CTA-wide exclusive scan; codes are packed with
// shared-memory atomicAdd into the chunk's slot, clamping word indices
// to cap-1 exactly as the reference's scatter-add does, so chunks over
// capacity stay bit-equal too. The optional histogram is counted in
// shared memory and flushed with one global atomicAdd per bin per CTA.
//
// What this simple design leaves on the table: one CTA per 1024-symbol
// chunk keeps only the CTA's own loads in flight, the scan costs four
// __syncthreads per 1024 symbols, and slot words are written by a
// block-stride loop rather than vector stores.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kMaxFinite = 480.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  // jnp.max / torch.amax propagate NaN; fmaxf would drop it.
  return (a > b || isnan(a)) ? a : b;
}

// float32 -> e4m3 code (all-finite eXmY), RTE, saturating at +-480,
// NaN -> max magnitude, sign of zero kept. qlc_fused.py:64-88.
__device__ __forceinline__ uint32_t e4m3_bits(float xs) {
  float mag = fabsf(xs);
  if (isnan(mag)) mag = kMaxFinite;
  mag = fminf(mag, kMaxFinite);
  int e = static_cast<int>(__float_as_uint(mag) >> 23) - 127;
  e = max(e, -6);
  const float step = __uint_as_float(static_cast<uint32_t>(e - 3 + 127) << 23);
  int k = static_cast<int>(rintf(__fdiv_rn(mag, step)));
  if (k == 16) {
    e += 1;
    k = 8;
  }
  const uint32_t code = (e == -6 && k < 8)
                            ? static_cast<uint32_t>(k)
                            : static_cast<uint32_t>(((e + 7) << 3) | (k - 8));
  return signbit(xs) ? (code | 0x80u) : code;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void fused_encode_kernel(const T* __restrict__ x, int64_t k,
                                    const int32_t* __restrict__ enc_code,
                                    const int32_t* __restrict__ enc_len, int cap,
                                    uint32_t* __restrict__ words,
                                    int32_t* __restrict__ nbits,
                                    float* __restrict__ scales,
                                    uint8_t* __restrict__ codes,
                                    int32_t* __restrict__ hist) {
  extern __shared__ uint32_t s_words[];
  __shared__ uint32_t s_code[256];
  __shared__ uint32_t s_len[256];
  __shared__ int s_hist[256];
  __shared__ uint32_t s_warp[32];
  __shared__ uint32_t s_carry;

  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;

  for (int i = tid; i < 256; i += nthreads) {
    s_code[i] = static_cast<uint32_t>(enc_code[i]);
    s_len[i] = static_cast<uint32_t>(enc_len[i]);
    s_hist[i] = 0;
  }
  for (int i = tid; i < cap; i += nthreads) s_words[i] = 0u;
  if (tid == 0) s_carry = 0u;
  __syncthreads();

  const float inv = __fdiv_rn(1.0f, kMaxFinite);
  const T* xr = x + row * k;
  for (int64_t base = 0; base < k; base += nthreads) {
    const int64_t e = base + tid;
    const float v = load_f32(xr + e);
    float amax = fabsf(v);
    for (int o = 16; o > 0; o >>= 1)
      amax = nan_max(amax, __shfl_xor_sync(kFull, amax, o));
    const float scale = amax > 0.0f ? __fmul_rn(amax, inv) : 1.0f;
    const float xs = __fdiv_rn(v, scale);
    const uint32_t sym = e4m3_bits(xs);
    if (lane == 0) scales[row * (k / 32) + e / 32] = scale;
    if (codes != nullptr) codes[row * k + e] = static_cast<uint8_t>(sym);
    if (hist != nullptr) atomicAdd(&s_hist[sym], 1);

    // CTA-wide exclusive scan of the code lengths, in element order.
    const uint32_t len = s_len[sym];
    const uint32_t code = s_code[sym];
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
    const uint32_t off = s_carry + (warp > 0 ? s_warp[warp - 1] : 0u) + incl - len;

    // A code of <= 11 bits at bit offset `shift` spans at most 2 words.
    const uint32_t shift = off & 31u;
    const int widx = min(static_cast<int>(off >> 5), cap - 1);
    const int hidx = min(widx + 1, cap - 1);
    atomicAdd(&s_words[widx], code << shift);
    atomicAdd(&s_words[hidx], shift == 0u ? 0u : code >> (32u - shift));
    __syncthreads();
    if (tid == 0) s_carry += s_warp[nwarps - 1];
    __syncthreads();
  }

  uint32_t* wr = words + row * cap;
  for (int i = tid; i < cap; i += nthreads) wr[i] = s_words[i];
  if (tid == 0) nbits[row] = static_cast<int32_t>(s_carry);
  if (hist != nullptr) {
    for (int i = tid; i < 256; i += nthreads)
      if (s_hist[i] != 0) atomicAdd(&hist[i], s_hist[i]);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). `threads` is a
// multiple of 32 that divides k, at most 1024; cap * 4 bytes of dynamic
// shared memory must fit in 48 KiB. The caller zeroes `hist`.
extern "C" int qlc_fused_encode(const void* x, int x_is_bf16, int64_t n, int64_t k,
                                const void* enc_code, const void* enc_len, int cap,
                                void* words, void* nbits, void* scales, void* codes,
                                void* hist, int threads, void* stream) {
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(cap) * sizeof(uint32_t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n));
  if (x_is_bf16) {
    fused_encode_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), k, static_cast<const int32_t*>(enc_code),
        static_cast<const int32_t*>(enc_len), cap, static_cast<uint32_t*>(words),
        static_cast<int32_t*>(nbits), static_cast<float*>(scales),
        static_cast<uint8_t*>(codes), static_cast<int32_t*>(hist));
  } else {
    fused_encode_kernel<float><<<grid, threads, smem, s>>>(
        static_cast<const float*>(x), k, static_cast<const int32_t*>(enc_code),
        static_cast<const int32_t*>(enc_len), cap, static_cast<uint32_t*>(words),
        static_cast<int32_t*>(nbits), static_cast<float*>(scales),
        static_cast<uint8_t*>(codes), static_cast<int32_t*>(hist));
  }
  return static_cast<int>(cudaGetLastError());
}
