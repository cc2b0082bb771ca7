"""Where K3's time goes, in SM cycles, on one card.

Builds a copy of this checkout's K3 (``qlc_encode.cu``) under
``build/encode_cycles/`` with ``clock64`` stamps taken by lane 0 of every
warp around the phases of each turn: waiting for the turn's symbols
(loaded a turn ahead), the LUT loads and in-lane sum, the segmented warp
scan, the pack into the slots, and the slot stores. Each stamp first
reads the phase's last result, so it waits for it. Runs the copy on the
``tools/bench_fused_ab.py --codes`` K3 shapes (warp, parity, kv,
block128, channel) and prints, per shape, the mean cycles per turn of
each phase, the turns per warp and the warps' median total; also the
kernel-alone time of the copy without and with stamps.

The stamps cost a few instructions each and hold the phases apart; the
copy encodes bit-equal to the plain version (checked). Run from the root
of a checkout on the card:
    python3 tools/encode_cycles.py [--json out.json]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src"), os.path.join(ROOT, "tools")]

from bench_fused_ab import K3_SHAPES, k3_case, launcher  # noqa: E402
from chip_smoke import smi_line, time_ms  # noqa: E402

OUT = os.path.join(ROOT, "build", "encode_cycles")
PHASES = ("wait_symbols", "lut", "scan", "pack", "store")
STAMP = '''namespace {
__device__ unsigned long long* g_prof = nullptr;
// clock64 after a register move of `dep`: the stamp waits for it.
__device__ __forceinline__ unsigned long long stamp(uint32_t dep) {
  uint32_t d;
  asm volatile("mov.u32 %0, %1;" : "=r"(d) : "r"(dep));
  unsigned long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "r"(d) : "memory");
  return t;
}
'''


def _lap(i: int, dep: str) -> str:
    return (f"    {{ const unsigned long long t_ = stamp({dep}); ph_[{i}] += "
            "t_ - t_prev_; t_prev_ = t_; }\n")


# (anchor, replacement): each anchor must occur once in qlc_encode.cu.
EDITS = [
    ("namespace {\n", STAMP),
    ("  uint32_t carry = 0;  // bits of the chunk's earlier pieces (k > 1024)\n",
     "  uint32_t carry = 0;  // bits of the chunk's earlier pieces (k > 1024)\n"
     "  unsigned long long ph_[6] = {0, 0, 0, 0, 0, 0};\n"
     "  unsigned long long t_prev_ = stamp(0);\n"
     "  const unsigned long long t_start_ = t_prev_;\n"),
    ("    for (int i = 0; i < 8; ++i) x[i] = nx[i];\n",
     "    for (int i = 0; i < 8; ++i) x[i] = nx[i];\n" + _lap(0, "x[0] ^ x[7]")),
    ("    if (!act) total = 0;\n", "    if (!act) total = 0;\n" + _lap(1, "total")),
    ("    if (multi) carry += __shfl_sync(kFull, incl, 31);\n",
     "    if (multi) carry += __shfl_sync(kFull, incl, 31);\n" + _lap(2, "off ^ carry")
     + "    uint32_t pkw_ = 0;\n"),
    ("      pk.finish();\n", "      pk.finish();\n      pkw_ = pk.w;\n"),
    ("    if (npass == 0) {  // the group's chunks are done",
     _lap(3, "pkw_") + "    if (npass == 0) {  // the group's chunks are done"),
    ("    g = ng;\n    pass = npass;\n  }\n}\n",
     _lap(4, "0") + "    ph_[5] += 1;\n    g = ng;\n    pass = npass;\n  }\n"
     "  if (g_prof != nullptr && lane == 0) {\n"
     "    unsigned long long* o_ = g_prof + (static_cast<int64_t>(blockIdx.x) "
     "* nwarps + warp) * 8;\n"
     "    for (int i = 0; i < 6; ++i) o_[i] = ph_[i];\n"
     "    o_[6] = stamp(0) - t_start_;\n  }\n}\n"),
]
SET = ('\nextern "C" int prof_set(void* p) { return (int)cudaMemcpyToSymbol('
       'g_prof, &p, sizeof(p)); }\n')


def build(qf) -> ctypes.CDLL:
    """The stamped copy of K3, compiled with the kernels' flags."""
    src = open(os.path.join(qf.CSRC, "qlc_encode.cu")).read()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"qlc_encode.cu: anchor {old!r} not found once; "
                               "update tools/encode_cycles.py to the kernel")
        src = src.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, "qlc_encode.cu"), os.path.join(OUT, "qlc_encode.so")
    with open(cu, "w") as f:
        f.write(src + SET)
    proc = subprocess.run([qf._nvcc(), *qf.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.qlc_encode.argtypes = qf._ARGTYPES["qlc_encode"]
    lib.qlc_encode.restype = ctypes.c_int
    lib.prof_set.argtypes = [ctypes.c_void_p]
    lib.prof_set.restype = ctypes.c_int
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the result line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("encode_cycles: no CUDA device available")
    from repro_torch.kernels import ops, qlc_codes as qc, qlc_fused as qf
    from repro_torch.kernels import ref
    lib = build(qf)
    smi = smi_line()
    print(f"[cycles] {smi}", flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    result = {"device": smi}
    for label, n, k, cap in K3_SHAPES:
        sym, t = k3_case(n, k)
        code = ops._i32(t.enc_code, "cuda")
        length = ops._i32(t.enc_len, "cuda")
        longest = int(t.enc_len.max())
        warps, chunks, _ = qc.encode_geometry(k, cap, longest)
        words = torch.empty((n, cap), dtype=torch.int32, device="cuda")
        nbits = torch.empty(n, dtype=torch.int32, device="cuda")
        run = launcher(lib.qlc_encode, sym.data_ptr(), n, k, code.data_ptr(),
                       length.data_ptr(), cap, words.data_ptr(),
                       nbits.data_ptr(), longest, warps, chunks)
        lib.prof_set(None)
        plain_ms = time_ms(run, 10, flush, alone=True)
        prof = torch.zeros((1 << 18, 8), dtype=torch.int64, device="cuda")
        lib.prof_set(prof.data_ptr())
        stamped_ms = time_ms(run, 1, flush, alone=True)
        lib.prof_set(None)
        want = ref.encode_ref(sym, t, cap)
        equal = torch.equal(words, want[0]) and torch.equal(nbits, want[1])
        p = prof.cpu().numpy()
        p = p[p[:, 5] > 0]
        turns = int(p[:, 5].sum())
        per = p[:, :5].sum(0) / turns
        res = {"shape": [n, k], "cap": cap, "warps_per_cta": warps,
               "chunks_per_turn": chunks, "equal": equal,
               "alone_ms": plain_ms, "stamped_ms": stamped_ms,
               "warps": len(p), "turns_per_warp": turns / len(p),
               "cycles_per_turn": dict(zip(PHASES, per.round(1).tolist())),
               "warp_cycles_median": float(np.median(p[:, 6]))}
        result[label] = res
        print(f"[cycles] {label} [{n}, {k}] cap {cap}: equal {equal}, alone "
              f"{plain_ms:.4f} ms (stamped {stamped_ms:.4f}), "
              f"{res['turns_per_warp']:.2f} turns per warp, cycles per turn "
              + ", ".join(f"{ph} {c:.0f}" for ph, c in zip(PHASES, per))
              + f"; a warp's whole run {res['warp_cycles_median']:.0f} "
              "(median)", flush=True)
    line = json.dumps(result)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    sys.exit(0 if all(v["equal"] for v in result.values()
                      if isinstance(v, dict)) else 1)


if __name__ == "__main__":
    main()
