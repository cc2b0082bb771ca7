// K5: QLC decode with the slot words staged through a double-buffered
// asynchronous copy into shared memory, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/qlc_prefetch.py
// ::prefetch_decode_pallas (body _prefetch_decode_kernel), which streams
// tiles of words HBM -> VMEM through a 2-slot scratch with DMA
// semaphores. It computes exactly K4's function; its plain version is
// repro_torch/kernels/ref.py::decode_block_async_ref, the same function
// as decode_ref, and the kernel matches it bit for bit.
//
// Bound on the H100: as K4, memory by bytes, the serial cursor in
// practice.
//
// Design: a CTA of kWarps warps walks tiles of 32 * kWarps consecutive
// chunks, tile blockIdx.x, then blockIdx.x + gridDim.x, ... A tile's
// words are one contiguous run in global memory; the CTA copies it into
// one of two shared-memory slots with cp.async (__pipeline_memcpy_async,
// 4 B per copy so any word offset works; rows padded to an odd stride so
// the 32 cursors of a warp spread over the banks). Before it decodes
// tile i from slot i % 2 it issues tile i+1's copy into the other slot
// and commits it, then waits for all but that newest group: tile i+1's
// words are in flight while tile i decodes. Each thread then runs K4's
// cursor over its chunk's words in shared memory, and the warp stores its
// symbols through K4's staging tile. The grid is half the tile count,
// rounded up, and at most the CTAs that fit on the card at once, so every
// CTA but an odd last one walks two tiles or more.
//
// What this simple design leaves on the table: a CTA that walks two
// tiles decodes them one after the other, so at a given size K5 runs
// half as many cursors at once as K4; the copy is 4 B per thread; TMA
// would free the threads of the copy altogether.
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "qlc_codes.cuh"

namespace {

template <int kWarps>
__global__ void prefetch_decode_kernel(const uint32_t* __restrict__ words, int64_t n, int cw,
                                       int stride, int64_t n_tiles,
                                       const int32_t* __restrict__ sid,
                                       const int32_t* __restrict__ dec_lut,
                                       const int32_t* __restrict__ area_sb,
                                       const int32_t* __restrict__ area_st, int n_schemes,
                                       int n_area, int prefix_bits, int64_t k,
                                       uint8_t* __restrict__ out) {
  constexpr int kTile = 32 * kWarps;
  extern __shared__ int32_t s_dyn[];
  __shared__ __align__(16) uint8_t s_tile[kWarps][32][qlc::kTileStride];
  int32_t* s_dec = s_dyn;
  int32_t* s_sb = s_dec + n_schemes * 256;
  int32_t* s_st = s_sb + n_schemes * n_area;
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_st + n_schemes * n_area);

  const int tid = threadIdx.x;
  for (int i = tid; i < n_schemes * 256; i += blockDim.x) s_dec[i] = dec_lut[i];
  for (int i = tid; i < n_schemes * n_area; i += blockDim.x) {
    s_sb[i] = area_sb[i];
    s_st[i] = area_st[i];
  }

  // Issue the copy of one tile's words into a slot, as one commit group.
  auto issue = [&](int64_t tile, int slot) {
    const int64_t r0 = tile * kTile;
    const int rows = static_cast<int>(n - r0 < kTile ? n - r0 : kTile);
    const uint32_t* src = words + r0 * cw;
    uint32_t* dst = s_words + static_cast<int64_t>(slot) * kTile * stride;
    for (int i = tid; i < rows * cw; i += blockDim.x) {
      const int r = i / cw;
      __pipeline_memcpy_async(dst + r * stride + (i - r * cw), src + i, sizeof(uint32_t));
    }
    __pipeline_commit();
  };

  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint8_t(*tile)[qlc::kTileStride] = s_tile[warp];

  int slot = 0;
  if (static_cast<int64_t>(blockIdx.x) < n_tiles) issue(blockIdx.x, 0);
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x, slot ^= 1) {
    // Prefetch: tile t + gridDim.x into the other slot before decoding t.
    const int64_t next = t + gridDim.x;
    if (next < n_tiles) {
      issue(next, slot ^ 1);
    } else {
      __pipeline_commit();  // an empty group keeps "all but the newest" = tile t
    }
    __pipeline_wait_prior(1);
    __syncthreads();

    const int64_t base_row = t * kTile + warp * 32;
    const int64_t row = base_row + lane;
    const bool active = row < n;
    const uint32_t* wr =
        s_words + (static_cast<int64_t>(slot) * kTile + warp * 32 + lane) * stride;
    const int s = active ? sid[row] : 0;
    const int32_t* dec = s_dec + s * 256;
    const int32_t* sb = s_sb + s * n_area;
    const int32_t* st = s_st + s * n_area;
    uint32_t bitpos = 0u;
    for (int64_t base = 0; base < k; base += qlc::kTileSyms) {
      const int w = static_cast<int>(k - base < qlc::kTileSyms ? k - base : qlc::kTileSyms);
      if (active) {
        for (int j = 0; j < w; ++j)
          tile[lane][j] = static_cast<uint8_t>(qlc::decode_symbol(
              wr, static_cast<uint32_t>(cw), bitpos, dec, sb, st, prefix_bits));
      }
      qlc::store_tile(tile, base_row, n, k, base, w, out);
    }
    __syncthreads();  // this slot is refilled by the next iteration's prefetch
  }
}

template <int kWarps>
int launch(const void* words, int64_t n, int cw, int stride, const void* sid,
           const void* dec_lut, const void* area_sb, const void* area_st, int n_schemes,
           int n_area, int prefix_bits, int64_t k, void* out, size_t smem,
           cudaStream_t stream) {
  auto kernel = prefetch_decode_kernel<kWarps>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kWarps,
                                                           smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int64_t tile = 32 * kWarps;
  const int64_t n_tiles = (n + tile - 1) / tile;
  int64_t grid = (n_tiles + 1) / 2;  // every CTA walks >= 2 tiles when there are 2
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > resident) grid = resident;
  if (grid < 1) grid = 1;
  kernel<<<dim3(static_cast<unsigned>(grid)), 32 * kWarps, smem, stream>>>(
      static_cast<const uint32_t*>(words), n, cw, stride, n_tiles,
      static_cast<const int32_t*>(sid), static_cast<const int32_t*>(dec_lut),
      static_cast<const int32_t*>(area_sb), static_cast<const int32_t*>(area_st), n_schemes,
      n_area, prefix_bits, k, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). `warps` (4, 2 or
// 1) sets the tile to 32 * warps chunks; the wrapper picks the largest
// whose two word slots fit. k is a multiple of 4. Dynamic shared memory:
// the stacked LUTs plus 2 * 32 * warps * stride words, stride = cw
// rounded up to odd.
extern "C" int qlc_prefetch(const void* words, int64_t n, int cw, const void* sid,
                            const void* dec_lut, const void* area_sb, const void* area_st,
                            int n_schemes, int n_area, int prefix_bits, int64_t k, void* out,
                            int warps, void* stream) {
  if (n == 0) return 0;
  const int stride = cw | 1;
  const size_t smem =
      (static_cast<size_t>(n_schemes) * (256 + 2 * n_area) +
       2 * static_cast<size_t>(32 * warps) * static_cast<size_t>(stride)) *
      sizeof(int32_t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (warps) {
    case 4:
      return launch<4>(words, n, cw, stride, sid, dec_lut, area_sb, area_st, n_schemes, n_area,
                       prefix_bits, k, out, smem, s);
    case 2:
      return launch<2>(words, n, cw, stride, sid, dec_lut, area_sb, area_st, n_schemes, n_area,
                       prefix_bits, k, out, smem, s);
    case 1:
      return launch<1>(words, n, cw, stride, sid, dec_lut, area_sb, area_st, n_schemes, n_area,
                       prefix_bits, k, out, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
