"""Time the fused kernels K1 (quantize -> encode) and K2 (decode ->
dequantize) of this checkout against those of another checkout, in turns
on one card, at the main paths' own shapes; with ``--codes``, the codes
kernels K3 (encode), K4 (decode) and K5 (prefetch decode) and the
histogram K6 instead.

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
with ``chip_smoke.time_ms(..., alone=True)`` (median of CUDA-event
timings of the device's execution, L2 flushed before every launch),
beside ``chip_smoke.bound_ms`` (``roofline.kernel_bytes``: its inputs
read once, its outputs written once, over HBM). The outputs of the two checkouts must be equal bit for bit. The
other checkout's K1 is launched with ``--other-threads`` threads per
CTA: by default the CTA size the wrapper passed before K1's launcher
picked its own (``threads_for``); 0 lets a launcher that
picks its own CTA pick. Prints
one JSON line, and writes it to ``--json PATH`` when given.

``--codes`` K3 shapes (u8 chunks from ``chip_smoke._skewed_symbols``:
skewed rows, every fourth uniform, so those overrun a tight slot; one
TABLE1 scheme calibrated on the data):
  warp     — [32, 256] at 45-word slots: one warp's worth, the launch
             and prologue;
  parity   — [4096, 256] at 89 words, ``chip_smoke.py``'s parity shape;
  kv       — [12288, 256] at 45 words, the KV path's coded plane
             (phi3-mini-3.8b, 16-token blocks);
  block128 — [98304, 256] at 45 words, the plane of one 128-token block,
             the reference's default ``--kv-block``;
  channel  — [32768, 1024] at 240 words, the ``CommConfig`` default that
             ``Channel.compress_codes`` uses.
K3 of both checkouts is timed alone (as K1/K2 are) and, in turns of one
process per checkout (other, this, this, other), through each
checkout's own ``kernels.ops.encode`` (``time_ms`` without ``alone``,
the host's entry work included). The other checkout's K3 is called
through whichever C interface its ``qlc_encode.cu`` declares: one CTA of
``threads`` per chunk (K3's first design), or the longest code, the
warps per CTA and the chunks per warp turn. K6 of both on [4096, 1024]
skewed symbols.

``--codes`` K4/K5 shapes (the same data):
  kv     — the KV path's coded plane, [12288, 256] at 45-word slots, one
           scheme;
  parity — ``chip_smoke.py``'s codes parity shape, [4096, 256], two
           schemes interleaved by chunk, at the longest chunk's slot;
  warp   — one warp's 32 chunks of 256 symbols and of 4 (45-word slots):
           the launch and prologue with and without one chunk's chain.
K4 and K5 of both checkouts decode the same words (encoded by the plain
version) with their operands made outside the timed window. The other
checkout's kernels are called through its own C interface: the stacked
area tables of PRs 12-14 (K5 with its warps argument), or the window
table of this checkout's, whichever its ``qlc_decode.cu`` declares.

Run from the root of a checkout, with the other checkout's tree (the
parent commit, for example, from ``git archive``) under a directory that
``.gitignore`` lists:
    python3 tools/bench_fused_ab.py --other build/parent [--codes]
        [--json out.json]
(``--codes`` takes about 2 minutes: it builds each checkout's kernels in
a process of its own too.)
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import bound_ms, smi_line, time_ms  # noqa: E402

NAMES = ("qlc_fused_encode", "qlc_fused_decode")
CODES = ("qlc_decode", "qlc_prefetch", "qlc_encode", "histogram256")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: K4/K5's C interface before the window table (PRs 12-14).
AREA_ARGTYPES = {
    "qlc_decode": [_P, _L, _I, _P, _P, _P, _P, _I, _I, _I, _L, _P, _P],
    "qlc_prefetch": [_P, _L, _I, _P, _P, _P, _P, _I, _I, _I, _L, _P, _I, _P]}
#: The C interface of K3's first design: one CTA of ``threads`` per chunk.
K3_THREADS_ARGTYPES = [_P, _L, _L, _P, _P, _I, _P, _P, _I, _P]
#: K3's shapes: label, chunks, symbols per chunk, slot words.
K3_SHAPES = (("warp", 32, 256, 45), ("parity", 4096, 256, 89),
             ("kv", 12288, 256, 45), ("block128", 98304, 256, 45),
             ("channel", 32768, 1024, 240))


def codes_interface(other: str) -> str:
    """"window" when the other checkout's K4 takes the window table, else
    "area" (the stacked area tables of PRs 12-14)."""
    path = os.path.join(other, "src", "repro_torch", "kernels", "csrc",
                        "qlc_decode.cu")
    return "window" if "wtab" in open(path).read() else "area"


def threads_for(k: int) -> int:
    """The CTA size the first designs' wrappers passed K1 and K3: the
    largest multiple of 32 that divides k and is at most 1024."""
    return next(t for t in range(min(k, 1024) // 32 * 32, 31, -32)
                if k % t == 0)


def k3_interface(root: str) -> str:
    """"lut" when the checkout's K3 takes the longest code, its warps per
    CTA and chunks per warp turn, else "threads" (one CTA of ``threads``
    per chunk, K3's first design)."""
    path = os.path.join(root, "src", "repro_torch", "kernels", "csrc",
                        "qlc_encode.cu")
    return "lut" if "max_code_bits" in open(path).read() else "threads"


def k3_tail(interface: str, k: int, cap: int, longest: int) -> tuple:
    """K3's launch arguments after ``nbits``, by C interface."""
    if interface == "threads":
        return (threads_for(k),)
    from repro_torch.kernels import qlc_codes as qc
    warps, chunks, _ = qc.encode_geometry(k, cap, longest)
    return (longest, warps, chunks)


def k3_case(n: int, k: int):
    """K3's symbols on the card and one TABLE1 scheme calibrated on them."""
    from chip_smoke import _skewed_symbols
    from repro_torch.core import lut, schemes
    sym = _skewed_symbols(n, k, 0)
    counts = np.bincount(sym.cpu().numpy().reshape(-1),
                         minlength=256).astype(np.float64) + 1
    return sym, lut.build_tables(counts, schemes.TABLE1)


def ops_encode_times(reps: int) -> dict:
    """ms of ``kernels.ops.encode`` at each K3 shape, through the
    checkout first on ``sys.path``."""
    from repro_torch.kernels import ops
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for label, n, k, cap in K3_SHAPES:
        sym, tables = k3_case(n, k)
        out[label] = time_ms(lambda: ops.encode(sym, tables, cap), reps,
                             flush)
    return out


def k3_ops_turns(other: str, reps: int) -> dict:
    """``ops_encode_times`` in one process per checkout, in turns other,
    this, this, other: {label: {"other": [ms, ms], "this": [ms, ms]}}."""
    out = {label: {"other": [], "this": []} for label, *_ in K3_SHAPES}
    for who in ("other", "this", "this", "other"):
        src = os.path.join(other if who == "other" else ROOT, "src")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--other", other,
             "--ops-encode", "--src", src, "--reps", str(reps)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"ops.encode timing of {who} failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        for label, ms in json.loads(proc.stdout.splitlines()[-1]).items():
            out[label][who].append(ms)
    return out


def k3_shape(label, n, k, cap, fns_c, interfaces, flush, reps):
    """K3 of both checkouts alone on the same symbols; the outputs must
    also equal the plain version's."""
    from repro_torch.kernels import ops, ref
    sym, tables = k3_case(n, k)
    code = ops._i32(tables.enc_code, "cuda")
    length = ops._i32(tables.enc_len, "cuda")
    longest = int(tables.enc_len.max())
    outs = {who: [torch.empty((n, cap), dtype=torch.int32, device="cuda"),
                  torch.empty(n, dtype=torch.int32, device="cuda")]
            for who in ("other", "this")}
    fns = {who: launcher(fns_c[who], sym.data_ptr(), n, k, code.data_ptr(),
                         length.data_ptr(), cap,
                         *(o.data_ptr() for o in outs[who]),
                         *k3_tail(interfaces[who], k, cap, longest))
           for who in ("other", "this")}
    r = a_b(f"{label} K3", fns, outs, reps, flush,
            bound_ms("encode", sym, tables, cap))
    want = ref.encode_ref(sym, tables, cap)
    r["equal"] = r["equal"] and all(torch.equal(a, b)
                                    for a, b in zip(outs["this"], want))
    return {"shape": [n, k], "cap": cap, **r}


def k6_shape(fns_c, flush, reps):
    """K6 of both checkouts on [4096, 1024] skewed symbols (all 256
    values), the grid its wrapper picks."""
    from repro_torch.kernels import histogram256 as h6
    rng = np.random.default_rng(6)
    sym = np.minimum(rng.geometric(0.05, (4096, 1024)), 255).astype(np.uint8)
    sym[0, :256] = np.arange(256)
    x = torch.from_numpy(sym).cuda().reshape(-1)
    n = x.numel()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = max(1, min(-(-n // (16 * h6._THREADS)), sms * h6._CTAS_PER_SM))
    outs = {who: [torch.zeros(256, dtype=torch.int32, device="cuda")]
            for who in ("other", "this")}
    fns = {who: launcher(fns_c[who], x.data_ptr(), n, outs[who][0].data_ptr(),
                         blocks) for who in ("other", "this")}
    return {"shape": [4096, 1024], **a_b("hist K6", fns, outs, reps, flush,
                                         bound_ms("histogram", x))}


def build_other(qf, other: str, names=NAMES, argtypes=None):
    """The other checkout's entry points ``names``, compiled with this
    checkout's flags into build/ab_other/, all sources at once."""
    csrc = os.path.join(other, "src", "repro_torch", "kernels", "csrc")
    out_dir = os.path.join(ROOT, "build", "ab_other")
    os.makedirs(out_dir, exist_ok=True)
    procs = {name: subprocess.Popen(
        [qf._nvcc(), *qf.NVCC_FLAGS, "-o", os.path.join(out_dir, f"{name}.so"),
         os.path.join(csrc, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in names}
    fns = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the other {name}:\n{text}")
        fn = getattr(ctypes.CDLL(os.path.join(out_dir, f"{name}.so")), name)
        fn.argtypes = (argtypes or qf._ARGTYPES)[name]
        fn.restype = ctypes.c_int
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


def a_b(name, fns, outs, reps, flush, bound):
    """Both checkouts' launches once (outputs compared), then timed in
    turns other, this, this, other."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["this"]))
    ms = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        ms[who].append(time_ms(fns[who], reps, flush, alone=True))
    res = {"equal": equal, "other_ms": ms["other"], "this_ms": ms["this"],
           "bound_ms": bound}
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
             threads_for(k) if other_threads is None else other_threads),
            ("this", qf._lib("qlc_fused_encode").qlc_fused_encode, 0))}
    res = {"K1": {"shape": [n, k], "cap": enc_cap, "codes": train, **a_b(
        f"{label} K1", fns, outs, reps, flush,
        bound_ms("quantize_encode", x, tables, enc_cap, emit_codes=train))}}
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
        bound = (bound_ms("decode_dequantize_accumulate", acc, w, sc,
                          tables, k, scheme_ids=sid) if train else
                 bound_ms("decode_dequantize", w, sc, tables, k,
                          scheme_ids=sid, out_dtype=dt))
        res[f"K2_{form}"] = {"shape": [n, cap], "form": form, **a_b(
            f"{label} K2 {form}", fns, outs, reps, flush, bound)}
        del outs, fns
    return res


def codes_shape(label, sym, tables, sid, cap, other, interface, flush,
                reps):
    """K4 and K5 of both checkouts on the same words: ``sym`` encoded by
    the plain version at ``cap`` words under ``tables[sid]``."""
    from repro_torch.kernels import ops, qlc_codes as qc, qlc_fused as qf
    from repro_torch.kernels import ref
    n, k = sym.shape
    words = torch.stack([ref.encode_ref(sym, t, cap)[0] for t in tables]
                        ).gather(0, sid.long()[None, :, None].expand(
                            1, n, cap))[0].contiguous()
    window, pb, longest = ops._window_luts(tables, sym.device)
    dec, sb, st, _ = ops._area_luts(tables, sym.device)
    this_args = (window.data_ptr(), len(tables), pb, longest, k)
    if interface == "window":
        other_args = this_args
    else:
        other_args = (dec.data_ptr(), sb.data_ptr(), st.data_ptr(),
                      len(tables), sb.shape[1], pb, k)
    res = {}
    for kname, cname in (("K4", "qlc_decode"), ("K5", "qlc_prefetch")):
        outs = {who: [torch.empty((n, k), dtype=torch.uint8,
                                  device=sym.device)]
                for who in ("other", "this")}
        # K5's last argument: its tile's chunks (this checkout's, and the
        # other's with the window table), or, before the window table,
        # its CTA's warps (the most of 4, 2, 1 whose two word slots fit
        # 160 KiB).
        this_extra = other_extra = ()
        if kname == "K5":
            this_extra = (qc.prefetch_tile_rows(len(tables), pb, cap),)
            other_extra = this_extra if interface == "window" else (
                next(w for w in (4, 2, 1)
                     if 2 * 32 * w * (cap | 1) * 4 <= 160 * 1024),)
        fns = {"other": launcher(other[cname], words.data_ptr(), n, cap,
                                 sid.data_ptr(), *other_args,
                                 outs["other"][0].data_ptr(), *other_extra),
               "this": launcher(getattr(qf._lib(cname), cname),
                                words.data_ptr(), n, cap, sid.data_ptr(),
                                *this_args, outs["this"][0].data_ptr(),
                                *this_extra)}
        r = a_b(f"{label} {kname}", fns, outs, reps, flush,
                bound_ms("decode" if kname == "K4" else "decode_block_async",
                         words, tables, k, scheme_ids=sid))
        want = ref.decode_ref(words, tables, sid, k)
        r["equal"] = r["equal"] and torch.equal(outs["this"][0], want)
        res[kname] = {"shape": [n, k], "cap": cap, **r}
    return res


def main_codes(args, flush, result):
    from chip_smoke import _skewed_symbols
    from repro_torch.core import lut, schemes
    from repro_torch.kernels import qlc_fused as qf
    interface = codes_interface(args.other)
    k3_faces = {"other": k3_interface(args.other), "this": k3_interface(ROOT)}
    argtypes = {**qf._ARGTYPES, **(AREA_ARGTYPES if interface == "area"
                                   else {})}
    if k3_faces["other"] == "threads":
        argtypes["qlc_encode"] = K3_THREADS_ARGTYPES
    other = build_other(qf, args.other, CODES, argtypes)
    result["other_interface"] = interface
    result["k3_interfaces"] = k3_faces
    k3_c = {"other": other["qlc_encode"],
            "this": qf._lib("qlc_encode").qlc_encode}
    result["k3"] = {label: k3_shape(label, n, k, cap, k3_c, k3_faces, flush,
                                    args.reps)
                    for label, n, k, cap in K3_SHAPES}
    torch.cuda.empty_cache()
    for label, ms in k3_ops_turns(args.other, args.reps).items():
        result["k3"][label]["ops_ms"] = ms
        print(f"[ab] {label} K3 through ops: other {ms['other']} ms, this "
              f"{ms['this']} ms", flush=True)
    result["k6"] = {"hist": k6_shape(
        {"other": other["histogram256"],
         "this": qf._lib("histogram256").histogram256}, flush, args.reps)}
    for label, n, k, two, cap in (("kv", 12288, 256, False, 45),
                                  ("parity", 4096, 256, True, None),
                                  ("warp", 32, 256, False, 45),
                                  ("warp_k4", 32, 4, False, 45)):
        sym = _skewed_symbols(n, k, 0)
        counts = np.bincount(sym.cpu().numpy().reshape(-1),
                             minlength=256).astype(np.float64) + 1
        tables = [lut.build_tables(counts, schemes.TABLE1)]
        if two:
            tables.append(lut.build_tables(counts[::-1].copy(),
                                           schemes.TABLE2))
        sid = (torch.arange(n, device="cuda") % len(tables)).to(torch.int32)
        if cap is None:
            from repro_torch.core import codec
            nb = torch.maximum(*(codec.encode_chunk_bits(sym, t.enc_len)
                                 for t in tables))
            cap = -(-int(nb.max()) // 32) | 1
        result[label] = codes_shape(label, sym, tables, sid, cap, other,
                                    interface, flush, args.reps)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout's tree")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--other-threads", type=int,
                    help="K1 CTA size for the other checkout")
    ap.add_argument("--codes", action="store_true",
                    help="time K4 and K5 instead of K1 and K2")
    ap.add_argument("--json", help="also write the result line here")
    ap.add_argument("--ops-encode", action="store_true",
                    help="(internal) print K3's ops.encode times of the "
                         "checkout whose src is --src")
    ap.add_argument("--src", help="(internal) the src/ to import first")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_fused_ab: no CUDA device available")
    if args.ops_encode:
        sys.path.insert(0, args.src)
        print(json.dumps(ops_encode_times(args.reps)))
        return
    from repro_torch.comm import calibrate
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.kernels import ops, qlc_fused as qf
    from repro_torch.models import init_params
    smi = smi_line()
    print(f"[ab] {smi}", flush=True)
    qf.build_kernels()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    result = {"device": smi}
    if args.codes:
        main_codes(args, flush, result)
        return finish(args, result)
    other = build_other(qf, args.other)

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
    finish(args, result)


def finish(args, result):
    """Print (and write) the result line; exit 1 unless every pair of
    outputs was equal."""
    line = json.dumps(result)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    sys.exit(0 if all(v["equal"] for r in result.values()
                      if isinstance(r, dict) for v in r.values()
                      if isinstance(v, dict)) else 1)


if __name__ == "__main__":
    main()
