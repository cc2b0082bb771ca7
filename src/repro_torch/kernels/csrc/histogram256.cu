// K6: 256-bin histogram of u8 symbols, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/histogram256.py::histogram256_pallas
// (body _hist_kernel, a one-hot reduction accumulated over a sequential
// grid). Plain version: repro_torch/kernels/ref.py::histogram256_ref,
// which the kernel matches bit for bit (integer atomics are exact in any
// order).
//
// Bound on the H100: memory. It reads each symbol once (1 B) and writes
// 1 KiB of counts, with a shared-memory atomic per symbol in between, so
// the floor is bytes / 3.35 TB/s.
//
// Design: CTAs run in no order on the card, so the TPU's grid-carried sum
// becomes atomics. A grid-stride loop over 16-byte vector loads (four
// words of four symbols each per thread and iteration) covers the
// 16-byte-aligned body; a scalar loop covers the head before the first
// aligned address and the tail after the last whole vector, so any length
// at any byte offset works. Each warp counts into its own copy of the 256
// bins in shared memory: gradient e4m3 symbols are highly skewed, and one
// copy per CTA would serialise all warps on the hot bins. At the end the
// CTA sums its copies and adds each nonzero bin to the global counts with
// one atomicAdd. Per-CTA counts fit u32 because the wrapper launches on
// at most 2^31 - 1 symbols.
//
// What this simple design leaves on the table: lanes of one warp that
// hit the same bin still serialise on its shared-memory atomic (an
// all-one-symbol stream is the worst case), and each CTA pays a 256-bin
// epilogue of global atomics.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void count_word(uint32_t* bins, uint32_t w) {
  atomicAdd(&bins[w & 0xFFu], 1u);
  atomicAdd(&bins[(w >> 8) & 0xFFu], 1u);
  atomicAdd(&bins[(w >> 16) & 0xFFu], 1u);
  atomicAdd(&bins[w >> 24], 1u);
}

__global__ void __launch_bounds__(kThreads)
    histogram256_kernel(const uint8_t* __restrict__ sym, int64_t n, int64_t head,
                        uint32_t* __restrict__ counts) {
  __shared__ uint32_t s_bins[kWarps][256];
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) (&s_bins[0][0])[i] = 0u;
  __syncthreads();

  uint32_t* bins = s_bins[threadIdx.x / 32];
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;

  // Body: 16-byte vectors from the first aligned address.
  const int64_t n_vec = (n - head) / 16;
  const uint4* vec = reinterpret_cast<const uint4*>(sym + head);
  for (int64_t i = tid; i < n_vec; i += stride) {
    const uint4 v = __ldg(vec + i);
    count_word(bins, v.x);
    count_word(bins, v.y);
    count_word(bins, v.z);
    count_word(bins, v.w);
  }
  // Head [0, head) and tail [tail0, n), one symbol per thread.
  const int64_t tail0 = head + n_vec * 16;
  const int64_t n_scalar = head + (n - tail0);
  for (int64_t i = tid; i < n_scalar; i += stride) {
    const int64_t j = i < head ? i : tail0 + (i - head);
    atomicAdd(&bins[sym[j]], 1u);
  }
  __syncthreads();

  for (int b = threadIdx.x; b < 256; b += kThreads) {
    uint32_t c = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += s_bins[w][b];
    if (c) atomicAdd(&counts[b], c);
  }
}

}  // namespace

// Adds the histogram of sym[0, n) into counts (int32 [256], zeroed by the
// caller). Returns the cudaError_t of the launch (0 on success).
extern "C" int histogram256(const void* sym, int64_t n, void* counts, int blocks,
                            void* stream) {
  if (n <= 0) return 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(sym);
  const int64_t to_aligned = static_cast<int64_t>((16u - (addr & 15u)) & 15u);
  const int64_t head = to_aligned < n ? to_aligned : n;
  histogram256_kernel<<<dim3(static_cast<unsigned>(blocks)), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sym), n, head, static_cast<uint32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
