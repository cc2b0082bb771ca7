// K4: QLC decode of word slots to u8 symbols (multi-LUT), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/qlc_decode.py::decode_pallas
// (body _decode_kernel). Plain version: repro_torch/kernels/ref.py
// ::decode_ref, which the kernel matches bit for bit.
//
// Bound on the H100: memory by bytes (each slot word read once, 1 B per
// symbol written, floor = bytes / 3.35 TB/s), but in practice the serial
// cursor: each symbol is a chain of dependent shifts and shared-memory
// LUT reads, so a chunk takes K steps however wide the card is.
//
// Design: K2's decode without the dequantize. One thread per chunk, 32
// chunks per warp, 4 warps per CTA. Each thread walks its chunk with the
// paper's O(1) step (qlc::decode_symbol): the 3-bit area code gives the
// payload bits and the area's first rank from the stacked per-scheme
// LUTs at the chunk's scheme slot, the rank indexes dec_lut. All LUTs
// sit in shared memory. The warp decodes 128 symbols of each of its 32
// chunks into a shared-memory tile and stores it row by row, 128
// consecutive bytes per store, instead of 32 one-byte stores 1 chunk
// apart.
//
// What this simple design leaves on the table: each thread reads its own
// chunk's words straight from global memory, strided across the warp
// (K5 stages them through shared memory instead), and 128 chunks per CTA
// give few CTAs when n is small.
#include <cstdint>
#include <cuda_runtime.h>

#include "qlc_codes.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void decode_kernel(const uint32_t* __restrict__ words, int64_t n, int cw,
                              const int32_t* __restrict__ sid,
                              const int32_t* __restrict__ dec_lut,
                              const int32_t* __restrict__ area_sb,
                              const int32_t* __restrict__ area_st, int n_schemes, int n_area,
                              int prefix_bits, int64_t k, uint8_t* __restrict__ out) {
  extern __shared__ int32_t s_luts[];
  __shared__ __align__(16) uint8_t s_tile[kWarps][32][qlc::kTileStride];
  int32_t* s_dec = s_luts;
  int32_t* s_sb = s_dec + n_schemes * 256;
  int32_t* s_st = s_sb + n_schemes * n_area;

  const int tid = threadIdx.x;
  for (int i = tid; i < n_schemes * 256; i += blockDim.x) s_dec[i] = dec_lut[i];
  for (int i = tid; i < n_schemes * n_area; i += blockDim.x) {
    s_sb[i] = area_sb[i];
    s_st[i] = area_st[i];
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t base_row = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * 32;
  const int64_t row = base_row + lane;
  const bool active = row < n;
  const uint32_t* wr = words + (active ? row : 0) * cw;
  const int s = active ? sid[row] : 0;
  const int32_t* dec = s_dec + s * 256;
  const int32_t* sb = s_sb + s * n_area;
  const int32_t* st = s_st + s * n_area;
  uint8_t(*tile)[qlc::kTileStride] = s_tile[warp];
  uint32_t bitpos = 0u;

  for (int64_t base = 0; base < k; base += qlc::kTileSyms) {
    const int w = static_cast<int>(k - base < qlc::kTileSyms ? k - base : qlc::kTileSyms);
    if (active) {
      for (int j = 0; j < w; ++j)
        tile[lane][j] = static_cast<uint8_t>(
            qlc::decode_symbol(wr, static_cast<uint32_t>(cw), bitpos, dec, sb, st, prefix_bits));
    }
    qlc::store_tile(tile, base_row, n, k, base, w, out);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). k is a multiple
// of 4. The stacked LUTs take n_schemes * (256 + 2 * n_area) * 4 bytes of
// dynamic shared memory.
extern "C" int qlc_decode(const void* words, int64_t n, int cw, const void* sid,
                          const void* dec_lut, const void* area_sb, const void* area_st,
                          int n_schemes, int n_area, int prefix_bits, int64_t k, void* out,
                          void* stream) {
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(n_schemes) * (256 + 2 * n_area) * sizeof(int32_t);
  const int64_t rows_per_cta = 32 * kWarps;
  const dim3 grid(static_cast<unsigned>((n + rows_per_cta - 1) / rows_per_cta));
  decode_kernel<<<grid, 32 * kWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n, cw, static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(dec_lut), static_cast<const int32_t*>(area_sb),
      static_cast<const int32_t*>(area_st), n_schemes, n_area, prefix_bits, k,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
