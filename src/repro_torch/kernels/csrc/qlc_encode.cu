// K3: QLC encode of u8 symbol chunks, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/qlc_encode.py::encode_pallas
// (body _encode_kernel). Plain version: repro_torch/kernels/ref.py
// ::encode_ref, which the kernel matches bit for bit.
//
// Bound on the H100: memory in principle. Per symbol it reads 1 B and
// writes the chunk's slot (at most 11/8 B per symbol at worst-case
// slots of 11-bit codes, 0.7 B on the KV cache's 45-word planes), so the
// floor is those bytes over 3.35 TB/s: about 2e12 symbols/s. At that
// rate the card has about 16 issue slots per symbol (132 SMs x 4
// schedulers x 32 lanes x ~1.9 GHz), so the pack must cost a few
// instructions per symbol and next to nothing per chunk: a chunk of 256
// symbols is 8 per lane of a warp, and the fixed work of a warp's turn
// (scan, slot stores, loop) would cost as much as its symbols.
//
// Design: K1's warp pack without the quantizer, each lane always on one
// block of 32 symbols, several chunks per warp turn.
//  - Persistent CTAs of `warps` independent warps (1, 2, 4 or 8), as
//    many CTAs as are resident at once. The encoder LUT is read into
//    shared memory once per CTA, behind the CTA's only barrier, while the
//    warps' first symbols are already in flight.
//  - A warp's turn covers 32 blocks of 32 symbols: `chunks` (C) whole
//    chunks of k <= 1024 symbols, G = k/32 lanes each (C <= 32 / G: a
//    group of C consecutive chunk rows, one contiguous stretch of at most
//    1 KiB), or one 1024-symbol piece of a longer chunk, with a carry to
//    the next piece. Lanes past C * G idle. The turns of a warp are
//    groups gw, gw + all warps, ... Each lane loads its block as two
//    16-byte loads (rows 16-byte aligned: the wrapper copies a tensor
//    that is not), and the warp's next turn is loaded into registers
//    before this one is packed, so its global latency hides behind the
//    pack. The wrapper picks `warps` and C (kernels/qlc_codes.py::
//    encode_geometry): the most chunks a turn can take, then the most
//    warps whose slots fit 48 KiB.
//  - Offsets: one LUT load per symbol, a serial in-lane sum of the 32
//    lengths, a warp scan of the lane totals segmented by chunk (log2 G
//    shuffle steps), and, past 1024 symbols, the carry. With codes of at
//    most 16 bits an entry is code | len << 21, so the in-lane sum is a
//    sum of entries (32 codes of 16 bits stay below bit 21); with longer
//    codes an entry is the pair {code, len}.
//  - Packing: each lane appends its codes to a 32-bit word (funnel
//    shifts over up to 96 bits), four codes at a time when codes are at
//    most 16 bits long (kLong false), else two: at most 64 bits a step.
//    It adds each word they fill into its chunk's slot in shared memory
//    (red.shared.add), then its last, partial word. The slot starts at
//    zero, so adding is storing for the words a lane owns alone, and the
//    words shared with the lane or piece before come out as the sum of
//    both parts. Every word at or past cap-1 is added into word cap-1: the
//    reference's scatter-add clamps both halves of each code there, so
//    that word is the wrapping u32 sum of every virtual word from cap-1
//    on, and a chunk over capacity stays bit-equal. nbits is the full bit
//    count. (The LUT's codes are below 2^len, which kernels/ops.py checks
//    on the host, so in-lane OR and the reference's add agree.)
//  - Outputs: the C slots sit back to back at a stride of cap words,
//    which is the layout of the C output rows, so the warp stores them in
//    one coalesced pass (16-byte pieces when C * cap is a multiple of 4),
//    zeroing the shared words as it reads them; the last lane of each
//    chunk stores its nbits. No CTA barrier after the prologue.
//
// What keeps it from its bound (tools/encode_cycles.py splits a turn's
// cycles; PERF.md has the numbers): a warp runs a turn's phases one after
// another (LUT loads, scan, pack, slot stores), the pack's word chain
// is the longest, and the shared-memory pipe serves every phase. Tried
// and not faster: staging the input through cp.async, a branch-free
// emission (stores to a scratch word), several accumulators per lane,
// a replicated bank-conflict-free LUT, fewer registers per thread.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 48 * 1024;
constexpr int kPiece = 1024;  // symbols of a warp's turn: 32 lanes x 32

// Bytes of one CTA's shared memory: the LUT and C slots per warp.
__host__ __device__ constexpr int smem_bytes(bool long_codes, int warps, int chunks, int cap) {
  return 256 * (long_codes ? 8 : 4) + warps * chunks * cap * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Add v into the shared word at addr when `on` (a predicated red).
__device__ __forceinline__ void red_add_if(bool on, uint32_t addr, uint32_t v) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t@p red.shared.add.u32 [%0], %1;\n\t}" ::"r"(
          addr),
      "r"(v), "r"(static_cast<uint32_t>(on))
      : "memory");
}

// A lane's 32 symbols at p (16-byte aligned), 4 to a word.
__device__ __forceinline__ void load_block(const uint8_t* p, uint32_t (&x)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// A lane's bit accumulator over its chunk's slot at shared address
// `slot`: `lo` holds nacc (< 32) pending bits, word w is next.
struct Packer {
  uint32_t slot;
  uint32_t last;  // cap - 1
  uint32_t lo, nacc, w;

  // Append `len` (<= 64) bits `c` (< 2^len); add the one or two words
  // they fill.
  __device__ __forceinline__ void append(uint64_t c, uint32_t len) {
    const uint32_t clo = static_cast<uint32_t>(c), chi = static_cast<uint32_t>(c >> 32);
    const uint32_t r1 = __funnelshift_l(clo, chi, nacc);  // bits 32-63 of c << nacc
    const uint32_t r2 = __funnelshift_l(chi, 0u, nacc);   // bits 64-95
    lo |= clo << nacc;
    const uint32_t tot = nacc + len;
    const bool one = tot >= 32u, two = tot >= 64u;
    red_add_if(one, slot + 4u * min(w, last), lo);
    red_add_if(two, slot + 4u * min(w + 1u, last), r1);
    lo = two ? r2 : (one ? r1 : lo);
    w += tot >> 5;
    nacc = tot & 31u;
  }
  __device__ __forceinline__ void finish() const {
    red_add_if(nacc > 0u, slot + 4u * min(w, last), lo);
  }
};

// Codes a, b (entries code | len << 21, codes of at most 16 bits) as one
// code of at most 32 bits, and its length.
__device__ __forceinline__ uint32_t pair_code(uint32_t a, uint32_t b) {
  return (a & 0xffffu) | ((b & 0xffffu) << (a >> 21));
}
__device__ __forceinline__ uint32_t pair_len(uint32_t a, uint32_t b) {
  return (a >> 21) + (b >> 21);
}

template <bool kLong>
__global__ void __launch_bounds__(256) encode_kernel(const uint8_t* __restrict__ sym, int64_t n,
                                                     int64_t k,
                                                     const int32_t* __restrict__ enc_code,
                                                     const int32_t* __restrict__ enc_len,
                                                     int cap, int chunks,
                                                     uint32_t* __restrict__ words,
                                                     int32_t* __restrict__ nbits) {
  using Entry = typename std::conditional<kLong, uint2, uint32_t>::type;
  __shared__ Entry s_lut[256];
  extern __shared__ __align__(16) uint32_t s_slots[];
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Lanes per chunk, this lane's chunk in the group and block in the turn.
  const bool multi = k > kPiece;
  const int g_lanes = multi ? 32 : static_cast<int>(k >> 5);
  const int cl = lane / g_lanes;
  const int pos = lane - cl * g_lanes;
  const int64_t passes = multi ? (k + kPiece - 1) / kPiece : 1;
  const int64_t groups = (n + chunks - 1) / chunks;
  uint32_t* slots = s_slots + warp * chunks * cap;
  const uint32_t my_slot = smem_addr(slots) + 4u * static_cast<uint32_t>(cl * cap);

  // Whether this lane holds a block in the turn (g, p), and where it is.
  auto block_of = [&](int64_t g, int64_t p, const uint8_t** at) {
    const int64_t row = g * chunks + cl;
    const int64_t e0 = p * kPiece + static_cast<int64_t>(pos) * 32;
    *at = sym + row * k + e0;
    return cl < chunks && row < n && e0 < k;
  };

  const int64_t warp_stride = static_cast<int64_t>(gridDim.x) * nwarps;
  int64_t g = static_cast<int64_t>(blockIdx.x) * nwarps + warp;
  int64_t pass = 0;
  uint32_t nx[8];
  const uint8_t* at;
  bool nact = g < groups && block_of(g, 0, &at);
  if (nact) load_block(at, nx);  // in flight while the LUT comes in

  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const uint32_t c = static_cast<uint32_t>(enc_code[i]);
    const uint32_t l = static_cast<uint32_t>(enc_len[i]);
    if constexpr (kLong) {
      s_lut[i] = make_uint2(c, l);
    } else {
      s_lut[i] = (c & 0xffffu) | (l << 21);
    }
  }
  for (int i = lane; i < chunks * cap; i += 32) slots[i] = 0u;
  __syncthreads();

  uint32_t carry = 0;  // bits of the chunk's earlier pieces (k > 1024)
  while (g < groups) {
    uint32_t x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = nx[i];
    const bool act = nact;
    // The warp's next turn is in flight while this one packs.
    int64_t ng = g, npass = pass + 1;
    if (npass == passes) {
      npass = 0;
      ng += warp_stride;
    }
    nact = ng < groups && block_of(ng, npass, &at);
    if (nact) load_block(at, nx);

    // ---- entries and the lane's bit total --------------------------------
    Entry e[32];
    uint32_t total = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      e[j] = s_lut[(x[j >> 2] >> (8 * (j & 3))) & 0xffu];
      if constexpr (kLong) {
        total += e[j].y;
      } else {
        total += e[j];
      }
    }
    if constexpr (!kLong) total >>= 21;
    if (!act) total = 0;

    // ---- offsets: warp scan of the lane totals, segmented by chunk ------
    uint32_t incl = total;
    for (int o = 1; o < g_lanes; o <<= 1) {  // the same count on every lane
      const uint32_t t = __shfl_up_sync(kFull, incl, o);
      if (pos >= o) incl += t;
    }
    const uint32_t off = carry + incl - total;
    if (multi) carry += __shfl_sync(kFull, incl, 31);

    // ---- pack into the chunk's slot --------------------------------------
    if (act) {
      Packer pk{my_slot, static_cast<uint32_t>(cap - 1), 0u, off & 31u, off >> 5};
      if constexpr (kLong) {
#pragma unroll
        for (int j = 0; j < 32; j += 2)  // two codes, at most 64 bits, a step
          pk.append(e[j].x | (static_cast<uint64_t>(e[j + 1].x) << e[j].y), e[j].y + e[j + 1].y);
      } else {
#pragma unroll
        for (int j = 0; j < 32; j += 4) {  // four codes, at most 64 bits, a step
          const uint32_t la = pair_len(e[j], e[j + 1]);
          pk.append(pair_code(e[j], e[j + 1]) |
                          (static_cast<uint64_t>(pair_code(e[j + 2], e[j + 3])) << la),
                      la + pair_len(e[j + 2], e[j + 3]));
        }
      }
      pk.finish();
    }

    if (npass == 0) {  // the group's chunks are done: their slots leave
      __syncwarp();
      const int64_t row0 = g * chunks;
      const int64_t rows = n - row0 < chunks ? n - row0 : chunks;
      uint32_t* wr = words + row0 * cap;
      const int nw = static_cast<int>(rows * cap);
      // 16-byte pieces where the warp's slots and its rows start 16-byte
      // aligned, then single words.
      const int nv =
          ((chunks * cap) & 3) == 0 && (reinterpret_cast<uintptr_t>(wr) & 15) == 0 ? nw >> 2 : 0;
      for (int i = lane; i < nv; i += 32) {
        reinterpret_cast<uint4*>(wr)[i] = reinterpret_cast<const uint4*>(slots)[i];
        reinterpret_cast<uint4*>(slots)[i] = make_uint4(0u, 0u, 0u, 0u);
      }
      for (int i = 4 * nv + lane; i < nw; i += 32) {
        wr[i] = slots[i];
        slots[i] = 0u;
      }
      if (multi ? lane == 0 : (act && pos == g_lanes - 1))
        nbits[row0 + cl] = static_cast<int32_t>(multi ? carry : incl);
      carry = 0;
      __syncwarp();  // the slots are zero before the next group adds into them
    }
    g = ng;
    pass = npass;
  }
}

// CTAs of encode_kernel<kLong> resident at once on the current device
// (0 on an error, in *err). The last answer is kept per host thread: a
// call repeats its operands.
template <bool kLong>
int64_t resident_ctas(int warps, int dyn_smem, cudaError_t* err) {
  thread_local int c_dev = -1, c_warps = 0, c_smem = 0;
  thread_local int64_t c_ctas = 0;
  int dev = 0, sms = 0, per_sm = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  if (dev == c_dev && warps == c_warps && dyn_smem == c_smem) return c_ctas;
  if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, encode_kernel<kLong>,
                                                            32 * warps, dyn_smem)) != cudaSuccess)
    return 0;
  c_dev = dev;
  c_warps = warps;
  c_smem = dyn_smem;
  c_ctas = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  return c_ctas;
}

// Checks the arguments, then launches, or with grid_warps != nullptr
// stores the warps of a full grid instead.
int dispatch(const void* sym, int64_t n, int64_t k, const void* enc_code, const void* enc_len,
             int cap, void* words, void* nbits, int max_code_bits, int warps, int chunks,
             cudaStream_t stream, int64_t* grid_warps) {
  const bool long_codes = max_code_bits > 16;
  if (k <= 0 || k % 32 != 0 || cap < 1 || max_code_bits < 0 || max_code_bits > 32 ||
      (warps != 1 && warps != 2 && warps != 4 && warps != 8) || chunks < 1 ||
      chunks > (k > kPiece ? 1 : 32 / static_cast<int>(k / 32)) ||
      smem_bytes(long_codes, warps, chunks, cap) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dyn = warps * chunks * cap * 4;  // the LUT is static shared memory
  cudaError_t err;
  const int64_t resident = long_codes ? resident_ctas<true>(warps, dyn, &err)
                                      : resident_ctas<false>(warps, dyn, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid_warps != nullptr) {
    *grid_warps = resident * warps;
    return 0;
  }
  const int64_t groups = (n + chunks - 1) / chunks;
  int64_t grid = (groups + warps - 1) / warps;
  if (grid > resident) grid = resident;
  auto kernel = long_codes ? encode_kernel<true> : encode_kernel<false>;
  kernel<<<dim3(static_cast<unsigned>(grid)), 32 * warps, dyn, stream>>>(
      static_cast<const uint8_t*>(sym), n, k, static_cast<const int32_t*>(enc_code),
      static_cast<const int32_t*>(enc_len), cap, chunks, static_cast<uint32_t*>(words),
      static_cast<int32_t*>(nbits));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). k is a positive
// multiple of 32, sym 16-byte aligned, 1 <= cap, every code below 2^len
// with len <= max_code_bits <= 32 (codes of at most 16 bits take the
// four-codes-per-step pack), warps in {1, 2, 4, 8}, chunks (per warp
// turn) in [1, 32 / (k / 32)] for k <= 1024 and 1 above, and the CTA's
// shared memory, 256 * (4 or 8) + warps * chunks * cap * 4 bytes, at
// most 48 KiB.
extern "C" int qlc_encode(const void* sym, int64_t n, int64_t k, const void* enc_code,
                          const void* enc_len, int cap, void* words, void* nbits,
                          int max_code_bits, int warps, int chunks, void* stream) {
  if (n == 0) return 0;
  return dispatch(sym, n, k, enc_code, enc_len, cap, words, nbits, max_code_bits, warps, chunks,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The warps of a full grid of qlc_encode's launch with these arguments on
// the current device (their first turns cover that many groups of
// `chunks` chunks), or minus the cudaError_t.
extern "C" int qlc_encode_grid_warps(int64_t k, int cap, int max_code_bits, int warps,
                                     int chunks) {
  int64_t out = 0;
  const int rc = dispatch(nullptr, 1, k, nullptr, nullptr, cap, nullptr, nullptr, max_code_bits,
                          warps, chunks, nullptr, &out);
  return rc != 0 ? -rc : static_cast<int>(out);
}
