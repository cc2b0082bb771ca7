// K3: QLC encode of u8 symbol chunks, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/qlc_encode.py::encode_pallas
// (body _encode_kernel). Plain version: repro_torch/kernels/ref.py
// ::encode_ref, which the kernel matches bit for bit.
//
// Bound on the H100: memory. Per symbol it reads 1 B and writes the
// chunk's slot (at most 11/8 B per symbol, about 0.4 B on the KV cache's
// exponent planes), with a dozen integer operations in between, far
// below the card's operation rate, so the floor is bytes / 3.35 TB/s.
//
// Design: K1's pack without the quantizer. One CTA per chunk, one thread
// per symbol in passes of blockDim.x symbols. Each thread gathers its
// (code, length) from the encoder LUT in shared memory; a CTA-wide scan
// of the lengths gives its bit offset; the code is added into the slot's
// words in shared memory with atomicAdd (u32, wrapping), word indices
// clamped to cap-1 as the reference's scatter-add does, so chunks over
// capacity come out bit-equal too. The slot is then stored in one
// coalesced pass and the chunk's bit count goes to nbits.
//
// What this simple design leaves on the table: a 256-symbol chunk keeps
// one small CTA busy for one pass, the scan costs two __syncthreads per
// pass, and the input is read one byte per thread.
#include <cstdint>
#include <cuda_runtime.h>

#include "qlc_codes.cuh"

namespace {

__global__ void encode_kernel(const uint8_t* __restrict__ sym, int64_t k,
                              const int32_t* __restrict__ enc_code,
                              const int32_t* __restrict__ enc_len, int cap,
                              uint32_t* __restrict__ words, int32_t* __restrict__ nbits) {
  extern __shared__ uint32_t s_words[];
  __shared__ uint32_t s_code[256];
  __shared__ uint32_t s_len[256];
  __shared__ uint32_t s_warp[32];

  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += blockDim.x) {
    s_code[i] = static_cast<uint32_t>(enc_code[i]);
    s_len[i] = static_cast<uint32_t>(enc_len[i]);
  }
  for (int i = tid; i < cap; i += blockDim.x) s_words[i] = 0u;
  __syncthreads();

  const uint8_t* sr = sym + row * k;
  uint32_t carry = 0u;
  for (int64_t base = 0; base < k; base += blockDim.x) {
    const uint32_t s = sr[base + tid];
    const uint32_t len = s_len[s];
    uint32_t total;
    const uint32_t off = qlc::cta_exclusive_offset(len, carry, s_warp, &total);
    qlc::pack_code(s_words, cap, off, s_code[s]);
    carry += total;
    __syncthreads();  // s_warp is rewritten by the next pass
  }

  uint32_t* wr = words + row * cap;
  for (int i = tid; i < cap; i += blockDim.x) wr[i] = s_words[i];
  if (tid == 0) nbits[row] = static_cast<int32_t>(carry);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). `threads` is a
// multiple of 32 that divides k, at most 1024; cap * 4 bytes of dynamic
// shared memory must fit in 48 KiB.
extern "C" int qlc_encode(const void* sym, int64_t n, int64_t k, const void* enc_code,
                          const void* enc_len, int cap, void* words, void* nbits,
                          int threads, void* stream) {
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(cap) * sizeof(uint32_t);
  encode_kernel<<<dim3(static_cast<unsigned>(n)), threads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sym), k, static_cast<const int32_t*>(enc_code),
      static_cast<const int32_t*>(enc_len), cap, static_cast<uint32_t*>(words),
      static_cast<int32_t*>(nbits));
  return static_cast<int>(cudaGetLastError());
}
