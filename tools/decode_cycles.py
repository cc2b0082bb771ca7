"""Where a codes decoder's time goes, in SM cycles, on one card.

Builds copies of this checkout's K4 (``qlc_decode.cu``) and K5
(``qlc_prefetch.cu``) under ``build/decode_cycles/`` with ``clock64``
stamps added by lane 0 of the first 64 CTAs: at the kernel's start,
after its prologue (tables and first words in), and, for each 32-symbol
block, before its word top-up, after its decode and after its stores;
with whether the block took the fast or the exact path. Runs both on the
codes shapes of ``tools/bench_fused_ab.py --codes`` (kv, parity, warp)
and prints, per kernel and shape, the medians over those CTAs: prologue
cycles, cycles per symbol in fast and in exact blocks, store cycles per
block, and the total. Also times a bare dependent chain of the decode
step's kind (mask, table address, 2-byte shared-memory load, funnel
shift) in one warp: its cycles per step and the SM clock
(``clock64`` over ``%globaltimer``), the floor of one chunk's cursor.

The stamps cost a few cycles each; the copies decode bit-equal to the
plain version (checked). Run from the root of a checkout on the card:
    python3 tools/decode_cycles.py [--json out.json]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import _skewed_symbols, smi_line  # noqa: E402

OUT = os.path.join(ROOT, "build", "decode_cycles")
STAMP = '''namespace qlc {
__device__ unsigned long long* g_prof = nullptr;
__device__ __forceinline__ void stamp(int slot, unsigned long long v) {
  if (g_prof != nullptr && (threadIdx.x & 31) == 0 && blockIdx.x < 64)
    g_prof[blockIdx.x * 64 + slot] = v;
}
'''
SET = ('extern "C" int prof_set(void* p) { return (int)cudaMemcpyToSymbol('
       'qlc::g_prof, &p, sizeof(p)); }\n')
# Slots: 0 start, 1 prologue done, 2 cursor started; block b: 4 + 3b top-up,
# 5 + 3b decoded, 6 + 3b stored (b < 8); 40 + b: 1 if fast.
EDITS = {
    "qlc_codes.cuh": [
        ("namespace qlc {\n", STAMP),
        ("    wr.next_block(active, bitpos);\n",
         "    stamp(4 + 3 * (b0 / kBlockSyms), clock64());\n"
         "    wr.next_block(active, bitpos);\n"),
        ("    if (active) {\n      uint32_t pack[kBlockSyms / 4];\n",
         "    stamp(40 + b0 / kBlockSyms, fast);\n"
         "    if (active) {\n      uint32_t pack[kBlockSyms / 4];\n"),
        ("      if (vec && nsym == kBlockSyms) {\n",
         "      stamp(5 + 3 * (b0 / kBlockSyms), clock64());\n"
         "      if (vec && nsym == kBlockSyms) {\n"),
        ("          if (4 * q < nsym) d[q] = pack[q];\n      }\n",
         "          if (4 * q < nsym) d[q] = pack[q];\n      }\n"
         "      stamp(6 + 3 * (b0 / kBlockSyms), clock64());\n"),
    ],
    "qlc_decode.cu": [
        ("  extern __shared__", "  qlc::stamp(0, clock64());\n"
                                "  extern __shared__"),
        ("  qlc::BitCursor c;\n  if (active) c.start(wr);\n",
         "  qlc::stamp(1, clock64());\n  qlc::BitCursor c;\n"
         "  if (active) c.start(wr);\n  qlc::stamp(2, clock64());\n"),
        ('extern "C" int qlc_decode', SET + 'extern "C" int qlc_decode'),
    ],
    "qlc_prefetch.cu": [
        ("  extern __shared__", "  qlc::stamp(0, clock64());\n"
                                "  extern __shared__"),
        ("    qlc::BitCursor c;\n    if (active) c.start(wr);\n",
         "    qlc::stamp(1, clock64());\n    qlc::BitCursor c;\n"
         "    if (active) c.start(wr);\n    qlc::stamp(2, clock64());\n"),
        ('extern "C" int qlc_prefetch', SET + 'extern "C" int qlc_prefetch'),
    ],
}
CHAIN = r'''
#include <cstdint>
#include <cuda_runtime.h>
// One warp: `steps` dependent decode-like steps (mask, table address,
// 2-byte shared load, funnel shift), timed by clock64 and globaltimer.
__global__ void chain(const uint16_t* tab_g, int steps, unsigned long long* out,
                      uint32_t* sink) {
  __shared__ uint16_t tab[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x) tab[i] = tab_g[i];
  __syncthreads();
  uint32_t lo = 0x9e3779b9u * (threadIdx.x + 1), hi = 0x7f4a7c15u ^ threadIdx.x;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(tab));
  unsigned long long t0, g0, t1, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  t0 = clock64();
  for (int i = 0; i < steps; ++i) {
    uint16_t e;
    asm volatile("ld.shared.u16 %0, [%1];" : "=h"(e) : "r"(base + ((lo & 2047u) << 1)));
    lo = __funnelshift_r(lo, hi, e);
    hi = hi * 1664525u + 1013904223u;
  }
  t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  sink[threadIdx.x] = lo;
  if (threadIdx.x == 0) { out[0] = t1 - t0; out[1] = g1 - g0; }
}
extern "C" int run_chain(const void* tab, int steps, void* out, void* sink) {
  chain<<<1, 32>>>(static_cast<const uint16_t*>(tab), steps,
                   static_cast<unsigned long long*>(out), static_cast<uint32_t*>(sink));
  return static_cast<int>(cudaDeviceSynchronize());
}
'''


def build(qf):
    """The instrumented K4/K5 and the chain kernel, as loaded libraries."""
    src = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    for name, edits in EDITS.items():
        text = open(os.path.join(src, name)).read()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: anchor {old!r} not found once; "
                                   "update tools/decode_cycles.py")
            text = text.replace(old, new)
        with open(os.path.join(OUT, name), "w") as f:
            f.write(text)
    with open(os.path.join(OUT, "chain.cu"), "w") as f:
        f.write(CHAIN)
    libs = {}
    procs = {name: subprocess.Popen(
        [qf._nvcc(), *qf.NVCC_FLAGS, "-o", os.path.join(OUT, f"{name}.so"),
         os.path.join(OUT, f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name in ("qlc_decode", "qlc_prefetch", "chain")}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        libs[name] = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
    return libs


def chain_cycles(lib) -> dict:
    rng = np.random.default_rng(0)
    tab = torch.from_numpy(rng.integers(0, 1 << 15, 2048).astype(np.int16)
                           ).cuda()
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    sink = torch.zeros(32, dtype=torch.int32, device="cuda")
    steps = 1 << 16
    lib.run_chain.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p]
    res = []
    for _ in range(3):
        if lib.run_chain(tab.data_ptr(), steps, out.data_ptr(),
                         sink.data_ptr()) != 0:
            raise RuntimeError("chain kernel failed")
        cyc, ns = out.cpu().tolist()
        res.append((cyc / steps, cyc / ns))
    return {"cycles_per_step": float(np.median([r[0] for r in res])),
            "sm_clock_ghz": float(np.median([r[1] for r in res]))}


def phases(prof: np.ndarray, n_ctas: int, k: int) -> dict:
    """Medians over the stamped CTAs."""
    n_blocks = -(-k // 32)
    pro, fast, exact, store, total = [], [], [], [], []
    for row in prof[:n_ctas]:
        t0 = row[0]
        pro.append(row[1] - t0)
        for b in range(n_blocks):
            dec = (row[5 + 3 * b] - row[4 + 3 * b]) / min(32, k - 32 * b)
            (fast if row[40 + b] else exact).append(dec)
            store.append(row[6 + 3 * b] - row[5 + 3 * b])
        total.append(row[6 + 3 * (n_blocks - 1)] - t0)
    med = (lambda v: float(np.median(v)) if v else None)  # noqa: E731
    return {"prologue_cycles": med(pro), "fast_cycles_per_symbol": med(fast),
            "exact_cycles_per_symbol": med(exact),
            "store_cycles_per_block": med(store), "total_cycles": med(total),
            "fast_blocks": len(fast), "exact_blocks": len(exact)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the result line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("decode_cycles: no CUDA device available")
    from repro_torch.core import lut, schemes
    from repro_torch.kernels import ops, qlc_codes as qc, qlc_fused as qf
    from repro_torch.kernels import ref
    smi = smi_line()
    libs = build(qf)
    result = {"device": smi, "chain": chain_cycles(libs["chain"])}
    print(f"[cycles] {smi}; bare chain {result['chain']}", flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for label, n, k, cap in (("kv", 12288, 256, 45), ("parity", 4096, 256, 89),
                             ("warp", 32, 256, 45)):
        sym = _skewed_symbols(n, k, 0)
        counts = np.bincount(sym.cpu().numpy().reshape(-1),
                             minlength=256).astype(np.float64) + 1
        tables = [lut.build_tables(counts, schemes.TABLE1)]
        words = ref.encode_ref(sym, tables[0], cap)[0]
        window, pb, longest = ops._window_luts(tables, sym.device)
        want = ref.decode_ref(words, tables, 0, k)
        for kname, cname in (("K4", "qlc_decode"), ("K5", "qlc_prefetch")):
            lib = libs[cname]
            fn = getattr(lib, cname)
            fn.argtypes, fn.restype = qf._ARGTYPES[cname], ctypes.c_int
            lib.prof_set.argtypes = [ctypes.c_void_p]
            prof = torch.zeros((64, 64), dtype=torch.int64, device="cuda")
            out = torch.empty((n, k), dtype=torch.uint8, device="cuda")
            extra = ((qc.prefetch_tile_rows(1, pb, cap),)
                     if kname == "K5" else ())
            lib.prof_set(prof.data_ptr())
            for _ in range(3):
                flush.zero_()
                torch.cuda._sleep(1_000_000)
                rc = fn(words.data_ptr(), n, cap, None, window.data_ptr(), 1,
                        pb, longest, k, out.data_ptr(), *extra,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{kname} launch failed: {rc}")
                torch.cuda.synchronize()
            lib.prof_set(None)
            if not torch.equal(out, want):
                raise AssertionError(f"{kname} {label}: differs from plain")
            r = phases(prof.cpu().numpy(), min(64, -(-n // 32)), k)
            result.setdefault(label, {})[kname] = {"shape": [n, k],
                                                   "cap": cap, **r}
            print(f"[cycles] {label} [{n}, {k}] cap {cap} {kname}: {r}",
                  flush=True)
    line = json.dumps(result)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
