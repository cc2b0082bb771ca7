// K4: QLC decode of word slots to u8 symbols (multi-LUT), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/qlc_decode.py::decode_pallas
// (body _decode_kernel). Plain version: repro_torch/kernels/ref.py
// ::decode_ref, which the kernel matches bit for bit.
//
// Bound on the H100: by bytes the floor is tiny (each slot word read
// once, 1 B per symbol written: 1.6 us at the KV path's [12288, 256] at
// 45 words). What sets the time is one chunk's serial chain of K symbols:
// each is a table load and a shift that depend on the one before, so a
// chunk takes K steps however wide the card is, and 12,288 chunks are
// only 384 warps, about three per SM.
//
// Design: K2's decode core, written once in qlc_codes.cuh for K4 and K5,
// emitting symbols. One thread per chunk, 32 chunks per warp, CTAs of one
// warp, so the KV shape's 384 warps spread over all 132 SMs (CTAs of 4
// warps left 36 SMs idle).
//  - Table: per scheme, the symbol and code length of every
//    (prefix + 8)-bit window, 2 B each (4 KiB at the paper's 3-bit
//    prefix), built once per table set on the host and kept on the device
//    by kernels.ops; each CTA copies the stacked tables into shared memory
//    with 16-byte cp.async in its prologue, beside its first words.
//  - Words: a per-thread ring of 128 words in shared memory fed by
//    16-byte cp.async copies aligned on the word's index from the 16-byte
//    aligned base below `words` (any 4-byte offset works; zero-filled past
//    the tensor's end), cut at the slot's end. A slot of up to 125 words
//    (every 256-symbol slot) arrives whole in the prologue; a wider one is
//    topped up at block boundaries, two blocks ahead of its use (a
//    block's copies delay the shared-memory loads issued after them, by
//    about 20 cycles a symbol at 89-word slots with a 64-word ring).
//  - Cursor: a 96-bit bit buffer in three registers, topped up every
//    second symbol so that at least 48 bits are valid; the next table
//    entry is loaded before the top-up, whose bits lie above the window,
//    so the loop-carried chain is mask -> address -> table load -> funnel
//    shift (43 cycles in a bare chain on the H100, tools/decode_cycles.py).
//    Blocks whose cursor may pass the slot take the exact path (first
//    word all ones, second the slot's last; the rank clamp is in the
//    table).
//  - Stores: each lane keeps a block's 32 symbols in 8 registers and
//    stores them itself (two 16-byte stores when rows are 16-byte
//    aligned).
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "qlc_codes.cuh"

namespace {

// Shared memory of the CTA's warp beside the tables: 32 rings at a stride
// of 132 words (16-byte aligned rows).
constexpr int kRingStride = qlc::kRingWords + 4;
constexpr int kRingBytes = 32 * kRingStride * 4;

__global__ void __launch_bounds__(32)
    decode_kernel(const uint32_t* __restrict__ words, int head, int64_t n, int cw,
                  const int32_t* __restrict__ sid, const uint16_t* __restrict__ wtab,
                  int n_schemes, int prefix_bits, int maxlen, int64_t k,
                  uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x;
  const int tbits = prefix_bits + 8;
  const int64_t tab_bytes = qlc::window_table_bytes(n_schemes, prefix_bits);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  const bool active = row < n;
  const uint32_t ucw = static_cast<uint32_t>(cw);

  for (int64_t i = 16 * lane; i < tab_bytes; i += 16 * 32)
    __pipeline_memcpy_async(smem + i, reinterpret_cast<const uint8_t*>(wtab) + i, 16);
  const uint64_t g0 = static_cast<uint64_t>(head) + static_cast<uint64_t>(active ? row : 0) * ucw;
  qlc::WordRing wr{words,
                   reinterpret_cast<uint32_t*>(smem + tab_bytes) + lane * kRingStride,
                   g0,
                   static_cast<uint64_t>(head) + static_cast<uint64_t>(n) * ucw,
                   ucw,
                   static_cast<uint32_t>(g0) & (qlc::kRingWords - 1)};
  if (active) wr.fill(0u, qlc::kRingWords - 3);
  __pipeline_commit();
  const int s = active ? qlc::scheme_slot(sid, row, n_schemes) : 0;
  const uint32_t wlast = active ? __ldg(words + wr.g0 + ucw - 1u) : 0u;
  __pipeline_wait_prior(0);
  __syncwarp();  // every lane's share of the tables is in

  qlc::BitCursor c;
  if (active) c.start(wr);
  qlc::decode_rows(wr, c, active, ucw, wlast, qlc::smem_addr(smem) + (s << (tbits + 1)),
                   (1u << tbits) - 1u, static_cast<uint32_t>(maxlen), k, row, out);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success; cudaErrorInvalidValue
// (1) for operands outside the kernel's domain, also when the tables and
// the rings pass the CTA's shared memory). words: int32 [n, cw]
// at any 4-byte offset, whose 16-byte aligned base below it lies in the
// same allocation; sid: int32 [n] scheme slots (clamped into
// [0, n_schemes)) or null for slot 0; wtab: the stacked window tables,
// n_schemes x 2^(prefix_bits + 8) u16, 16-byte aligned; prefix_bits at
// most 8; max_code_bits the longest code of any stacked scheme; k a
// positive multiple of 4.
extern "C" int qlc_decode(const void* words, int64_t n, int cw, const void* sid, const void* wtab,
                          int n_schemes, int prefix_bits, int max_code_bits, int64_t k, void* out,
                          void* stream) {
  if (n == 0) return 0;
  const uintptr_t p = reinterpret_cast<uintptr_t>(words);
  if (cw < 1 || k <= 0 || k % 4 != 0 || n_schemes < 1 || prefix_bits < 0 ||
      prefix_bits > qlc::kMaxPrefix || max_code_bits < 0 || max_code_bits > prefix_bits + 8 ||
      p % 4 != 0 || reinterpret_cast<uintptr_t>(wtab) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = qlc::window_table_bytes(n_schemes, prefix_bits) + kRingBytes;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((n + 31) / 32));
  decode_kernel<<<grid, 32, static_cast<size_t>(smem),
                  static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(p & ~static_cast<uintptr_t>(15)),
      static_cast<int>((p & 15) / 4), n, cw, static_cast<const int32_t*>(sid),
      static_cast<const uint16_t*>(wtab), n_schemes, prefix_bits, max_code_bits, k,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
