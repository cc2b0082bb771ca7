"""Time the fused kernels K1 (quantize -> encode) and K2 (decode ->
dequantize) of this checkout against those of another checkout, in turns
on one card, at the main paths' own shapes.

Shapes (NVIDIA H100, one card):
  w_in   — the slice's largest leaf: phi3-mini-3.8b's stacked w_in
           [32, 3072, 8192] as [786432, 1024] f32 (random, std
           1/sqrt(3072), seed 0): K1 at 353-word slots (the slice's
           calibration slot), then K2 f32 and bf16 at the slot of the
           longest chunk (the weight wire's exact capacity).
  train  — the train path's flat gradient: one backward pass of
           phi3-mini-3.8b cut to 8 layers (batch 4 x 512, seed 0), as
           [1077171, 1024] f32 chunks: K1 with codes at the calibrated
           plan's slot, K2 accumulate on those words.

Each kernel of each checkout is timed in turns (other, this, this, other)
with ``chip_smoke.time_ms`` (median of CUDA-event timings, L2 flushed
before every launch), beside ``chip_smoke.bound_ms`` of the bytes it must
move. The outputs of the two checkouts must be equal bit for bit. The
other checkout's K1 is launched with ``--other-threads`` threads per
CTA: by default the CTA size the wrapper passed before K1's launcher
picked its own (``qlc_fused._threads_for``); 0 lets a launcher that
picks its own CTA pick. Prints
one JSON line, and writes it to ``--json PATH`` when given.

Run from the root of a checkout, with the other checkout's tree (the
parent commit, for example, from ``git archive``) under a directory that
``.gitignore`` lists:
    python3 tools/bench_fused_ab.py --other build/parent [--json out.json]
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import bound_ms, nbytes, smi_line, time_ms  # noqa: E402

NAMES = ("qlc_fused_encode", "qlc_fused_decode")


def build_other(qf, other: str):
    """The other checkout's K1/K2 entry points, compiled with this
    checkout's flags into build/ab_other/, all sources at once."""
    csrc = os.path.join(other, "src", "repro_torch", "kernels", "csrc")
    out_dir = os.path.join(ROOT, "build", "ab_other")
    os.makedirs(out_dir, exist_ok=True)
    procs = {name: subprocess.Popen(
        [qf._nvcc(), *qf.NVCC_FLAGS, "-o", os.path.join(out_dir, f"{name}.so"),
         os.path.join(csrc, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in NAMES}
    fns = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the other {name}:\n{text}")
        fn = getattr(ctypes.CDLL(os.path.join(out_dir, f"{name}.so")), name)
        fn.argtypes, fn.restype = qf._ARGTYPES[name], ctypes.c_int
        fns[name] = fn
    return fns


def launcher(fn, *args):
    """A call of the C entry point ``fn`` on the current stream that
    raises on a launch error."""
    def run():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return run


def a_b(name, fns, outs, reps, flush, nbytes_moved):
    """Both checkouts' launches once (outputs compared), then timed in
    turns other, this, this, other."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["this"]))
    ms = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        ms[who].append(time_ms(fns[who], reps, flush))
    res = {"equal": equal, "other_ms": ms["other"], "this_ms": ms["this"],
           "bound_ms": bound_ms(nbytes_moved)}
    print(f"[ab] {name}: outputs equal {equal}, other {ms['other']} ms, this "
          f"{ms['this']} ms, HBM bound {res['bound_ms']:.4f} ms", flush=True)
    return res


def run_shape(label, x, tables, enc_cap, train, other, qf, ops, flush, reps,
              other_threads):
    """K1 of both checkouts on x at enc_cap (with codes on the train
    shape), then K2 of both on this checkout's words: accumulate at
    enc_cap on the train shape, else f32 and bf16 cut to the longest
    chunk's slot."""
    from repro_torch.core import codec
    from repro_torch.quant import e4m3
    dev = "cuda"
    n, k = x.shape
    t = (ops._i32(tables.enc_code, dev), ops._i32(tables.enc_len, dev))
    outs = {who: [torch.empty((n, enc_cap), dtype=torch.int32, device=dev),
                  torch.empty(n, dtype=torch.int32, device=dev),
                  torch.empty((n, k // 32), dtype=torch.float32, device=dev)]
            + ([torch.empty((n, k), dtype=torch.uint8, device=dev)]
               if train else [])
            for who in ("other", "this")}
    fns = {who: launcher(
        fn, x.data_ptr(), 0, n, k, t[0].data_ptr(), t[1].data_ptr(), enc_cap,
        *(o.data_ptr() for o in outs[who][:3]),
        outs[who][3].data_ptr() if train else None, None, threads)
        for who, fn, threads in (
            ("other", other["qlc_fused_encode"],
             qf._threads_for(k) if other_threads is None else other_threads),
            ("this", qf._lib("qlc_fused_encode").qlc_fused_encode, 0))}
    res = {"K1": {"shape": [n, k], "cap": enc_cap, "codes": train, **a_b(
        f"{label} K1", fns, outs, reps, flush, nbytes(x, *outs["this"]))}}
    words, nb, sc = outs["this"][:3]
    del outs, fns

    cap = enc_cap if train else -(-int(nb.max()) // 32)
    w = words[:, :cap].contiguous()
    del words
    dec, sb, st, pb = codec.stack_decode_tables([tables])
    sid = torch.zeros(n, dtype=torch.int32, device=dev)
    luts = (sid, ops._i32(dec, dev), ops._i32(sb, dev), ops._i32(st, dev))
    vtab = torch.as_tensor(e4m3.decode_table(), device=dev)
    acc = (torch.randn((n, k), generator=torch.Generator(dev).manual_seed(1),
                       device=dev) if train else None)
    for form in (("acc",) if train else ("f32", "bf16")):
        dt = torch.bfloat16 if form == "bf16" else torch.float32
        outs = {who: [torch.empty((n, k), dtype=dt, device=dev)]
                for who in ("other", "this")}
        fns = {who: launcher(
            fn, w.data_ptr(), n, cap, sc.data_ptr(),
            *(a.data_ptr() for a in luts), 1, sb.shape[1], pb,
            vtab.data_ptr(), k, acc.data_ptr() if train else None,
            outs[who][0].data_ptr(), {"f32": 0, "bf16": 1, "acc": 2}[form])
            for who, fn in (
                ("other", other["qlc_fused_decode"]),
                ("this", qf._lib("qlc_fused_decode").qlc_fused_decode))}
        moved = nbytes(w, sc, sid, outs["this"][0]) + (
            nbytes(acc) if train else 0)
        res[f"K2_{form}"] = {"shape": [n, cap], "form": form, **a_b(
            f"{label} K2 {form}", fns, outs, reps, flush, moved)}
        del outs, fns
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout's tree")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--other-threads", type=int,
                    help="K1 CTA size for the other checkout")
    ap.add_argument("--json", help="also write the result line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_fused_ab: no CUDA device available")
    from repro_torch.comm import calibrate
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.kernels import ops, qlc_fused as qf
    from repro_torch.models import init_params
    smi = smi_line()
    print(f"[ab] {smi}", flush=True)
    qf.build_kernels()
    other = build_other(qf, args.other)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    result = {"device": smi}

    gen = torch.Generator(device="cuda").manual_seed(0)
    xw = torch.randn((786432, 1024), generator=gen, device="cuda") \
        * (1.0 / 3072 ** 0.5)
    tables, _ = calibrate.calibrate_for_tensor(xw)
    result["w_in"] = run_shape("w_in", xw, tables, 353, False, other, qf,
                               ops, flush, args.reps, args.other_threads)
    del xw
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), num_layers=8)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    b0 = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=512,
                                     global_batch=4)).batch_at(0)
    b0 = {k: torch.as_tensor(v).to("cuda") for k, v in b0.items()}
    grad = calibrate.flat_gradient(cfg, params, b0)
    del params, b0
    torch.cuda.empty_cache()
    tables, plan = calibrate.calibrate_for_tensor(grad)
    result["train"] = run_shape(
        "train", grad.reshape(-1, plan.chunk_symbols), tables,
        plan.capacity_words, True, other, qf, ops, flush, args.reps,
        args.other_threads)
    line = json.dumps(result)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    sys.exit(0 if all(v["equal"] for key, r in result.items()
                      if key != "device" for v in r.values()) else 1)


if __name__ == "__main__":
    main()
