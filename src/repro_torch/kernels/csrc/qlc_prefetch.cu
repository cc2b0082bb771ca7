// K5: QLC decode with the slot words staged tile by tile into shared
// memory by Hopper's bulk asynchronous copy (TMA), double-buffered, for
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/qlc_prefetch.py
// ::prefetch_decode_pallas (body _prefetch_decode_kernel), which streams
// tiles of words HBM -> VMEM through a 2-slot scratch with DMA
// semaphores. It computes exactly K4's function; its plain version is
// repro_torch/kernels/ref.py::decode_block_async_ref, the same function
// as decode_ref, and the kernel matches it bit for bit.
//
// Bound on the H100: as K4, a tiny byte floor; the serial cursor of each
// chunk sets the time.
//
// Design: CTAs of one warp; a tile is T consecutive chunks, one per lane
// (T = 32, or 16, 8, ... 1 when two slots of 32 chunks' words do not fit
// beside the tables: the wrapper picks it), whose words are one
// contiguous run in global memory. The grid is one CTA per tile, up to the
// CTAs that fit on the card at once; a CTA with more than one tile walks
// tiles blockIdx.x, blockIdx.x + gridDim.x, ...
//  - Staging: lane 0 copies a tile's run (widened to 16-byte aligned
//    ends, never past the tensor: the at most 3 words of a ragged end are
//    loaded by the lanes) into one of two shared-memory slots with one
//    cp.async.bulk, which completes on that slot's mbarrier
//    (complete_tx). Before it decodes tile i from slot i % 2 it issues
//    tile i+1's copy into the other slot, so the next tile is in flight
//    while this one decodes, and no thread spends instructions on the
//    copy. Each slot's barrier phase flips per use; its parity is tracked
//    in a register. The first copy also brings the stacked window tables.
//  - Decode: K4's cursor core (qlc_codes.cuh) over the staged words: the
//    bit buffer, the window table, the exact path past the slot, the
//    lanes' stores from registers.
//  - A dense run cannot be padded to an odd row stride, so with an even
//    cw the lanes' word reads may share banks; they come once per 32
//    bits consumed, off the cursor's chain, and are accepted.
#include <cstdint>
#include <cuda_runtime.h>

#include "qlc_codes.cuh"

namespace {

using qlc::smem_addr;

constexpr int kHeadBytes = 16;  // the two slots' mbarriers, at the start of shared memory

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0u;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Global -> shared bulk copy of `bytes` (a multiple of 16, both ends
// 16-byte aligned), completed on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Words of a slot: a tile's run of `rows` chunks widened to 16-byte ends.
__host__ __device__ constexpr int64_t slot_words(int cw, int rows) {
  return (static_cast<int64_t>(rows) * cw + 6 + 3) & ~3LL;
}

__global__ void __launch_bounds__(32)
    prefetch_decode_kernel(const uint32_t* __restrict__ words, int head, int64_t n, int cw,
                           int tile_rows, int64_t n_tiles, const int32_t* __restrict__ sid,
                           const uint16_t* __restrict__ wtab, int n_schemes, int prefix_bits,
                           int maxlen, int64_t k, uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int lane = threadIdx.x;
  const int tbits = prefix_bits + 8;
  const int64_t tab_bytes = qlc::window_table_bytes(n_schemes, prefix_bits);
  uint16_t* s_tab = reinterpret_cast<uint16_t*>(smem + kHeadBytes);
  uint32_t* slots = reinterpret_cast<uint32_t*>(smem + kHeadBytes + tab_bytes);
  const int64_t sw = slot_words(cw, tile_rows);
  const uint64_t ucw = static_cast<uint64_t>(cw);
  const uint64_t gend = static_cast<uint64_t>(head) + static_cast<uint64_t>(n) * ucw;
  const uint64_t bulk_end = gend & ~3ull;  // bulk copies stop at the tensor's last aligned piece

  // Words [first, end) of tile t, first rounded down to 16 bytes.
  auto span = [&](int64_t t, uint64_t& first, uint64_t& end) {
    const int64_t r0 = t * tile_rows;
    const int64_t r1 = n - r0 < tile_rows ? n : r0 + tile_rows;
    first = (static_cast<uint64_t>(head) + static_cast<uint64_t>(r0) * ucw) & ~3ull;
    end = static_cast<uint64_t>(head) + static_cast<uint64_t>(r1) * ucw;
  };
  // The bulk part of tile t's run: words [first, stop).
  auto bulk_stop = [&](uint64_t first, uint64_t end) {
    const uint64_t up = (end + 3) & ~3ull;
    const uint64_t stop = up < bulk_end ? up : bulk_end;
    return stop > first ? stop : first;
  };
  // Lane 0: tile t's bulk copy into slot `slot` (with `extra` bytes of
  // tables on the first).
  auto issue = [&](int64_t t, int slot, uint32_t extra) {
    uint64_t first, end;
    span(t, first, end);
    const uint32_t bytes = static_cast<uint32_t>(bulk_stop(first, end) - first) * 4u;
    mbar_arrive_expect_tx(&bar[slot], bytes + extra);
    if (extra != 0u) bulk_copy(s_tab, wtab, extra, &bar[slot]);
    if (bytes != 0u) bulk_copy(slots + slot * sw, words + first, bytes, &bar[slot]);
  };

  if (lane == 0) {
    mbar_init(&bar[0], 1u);
    mbar_init(&bar[1], 1u);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  if (lane == 0) issue(blockIdx.x, 0, static_cast<uint32_t>(tab_bytes));

  uint32_t parity = 0u;  // bit b: the phase parity slot b completes next
  int slot = 0;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x, slot ^= 1) {
    const int64_t next = t + gridDim.x;
    // Slot ^ 1 was last read in the previous iteration, which ended in a
    // __syncwarp: refill it with the next tile.
    if (lane == 0 && next < n_tiles) issue(next, slot ^ 1, 0u);
    uint32_t* sl = slots + slot * sw;
    uint64_t first, end;
    span(t, first, end);
    for (uint64_t i = bulk_stop(first, end) + lane; i < end; i += 32)
      sl[i - first] = __ldg(words + i);
    mbar_wait(&bar[slot], (parity >> slot) & 1u);
    parity ^= 1u << slot;
    __syncwarp();  // the lanes' ragged-end words are in too

    const int64_t base_row = t * tile_rows;
    const int rows = static_cast<int>(n - base_row < tile_rows ? n - base_row : tile_rows);
    const int64_t row = base_row + lane;
    const bool active = lane < rows;
    qlc::StagedWords wr{
        sl + (static_cast<uint64_t>(head) + static_cast<uint64_t>(active ? row : base_row) * ucw -
              first),
        static_cast<uint32_t>(cw)};
    const int s = active ? qlc::scheme_slot(sid, row, n_schemes) : 0;
    const uint32_t wlast = wr(static_cast<uint32_t>(cw) - 1u);
    qlc::BitCursor c;
    if (active) c.start(wr);
    qlc::decode_rows(wr, c, active, static_cast<uint32_t>(cw), wlast,
                     smem_addr(s_tab) + (s << (tbits + 1)), (1u << tbits) - 1u,
                     static_cast<uint32_t>(maxlen), k, row, out);
    __syncwarp();  // this slot is refilled by the next iteration's copy
  }
}

// Shared memory of one CTA: the barriers, the stacked window tables and
// two slots (kernels/qlc_codes.py::prefetch_smem).
int64_t cta_smem(int n_schemes, int prefix_bits, int cw, int tile_rows) {
  return kHeadBytes + qlc::window_table_bytes(n_schemes, prefix_bits) +
         2 * slot_words(cw, tile_rows) * 4;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success; cudaErrorInvalidValue
// (1) for operands outside the kernel's domain, also when a CTA's shared
// memory (cta_smem) passes the card's). Operands as qlc_decode's
// (qlc_decode.cu); tile_rows (1 to 32) chunks per tile.
extern "C" int qlc_prefetch(const void* words, int64_t n, int cw, const void* sid,
                            const void* wtab, int n_schemes, int prefix_bits, int max_code_bits,
                            int64_t k, void* out, int tile_rows, void* stream) {
  if (n == 0) return 0;
  const uintptr_t p = reinterpret_cast<uintptr_t>(words);
  if (cw < 1 || k <= 0 || k % 4 != 0 || n_schemes < 1 || prefix_bits < 0 ||
      prefix_bits > qlc::kMaxPrefix || max_code_bits < 0 || max_code_bits > prefix_bits + 8 ||
      p % 4 != 0 || reinterpret_cast<uintptr_t>(wtab) % 16 != 0 || tile_rows < 1 ||
      tile_rows > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = cta_smem(n_schemes, prefix_bits, cw, tile_rows);
  // The CTAs that fit on the card at once, per device and shared-memory
  // size (asked once: the query costs more than the launch).
  static int64_t known_smem[16], known_resident[16];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 16) return static_cast<int>(cudaErrorInvalidDevice);
  if (known_smem[dev] != smem) {
    int optin = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(prefetch_decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prefetch_decode_kernel, 32,
                                                          static_cast<size_t>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    known_resident[dev] = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
    known_smem[dev] = smem;
  }
  const int64_t n_tiles = (n + tile_rows - 1) / tile_rows;
  const int64_t grid = n_tiles < known_resident[dev] ? n_tiles : known_resident[dev];
  prefetch_decode_kernel<<<dim3(static_cast<unsigned>(grid)), 32, static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(p & ~static_cast<uintptr_t>(15)),
      static_cast<int>((p & 15) / 4), n, cw, tile_rows, n_tiles, static_cast<const int32_t*>(sid),
      static_cast<const uint16_t*>(wtab), n_schemes, prefix_bits, max_code_bits, k,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
