"""Wrappers of the fused CUDA kernels for Hopper (sm_90a), and the
builder of every kernel of the port.

  K1 ``fused_encode``  — block-32 e4m3 quantize + QLC encode
                         (``csrc/qlc_fused_encode.cu``; replaces
                         ``repro/kernels/qlc_fused.py::fused_encode_pallas``).
  K2 ``fused_decode``  — QLC decode + dequantize (+ accumulate)
                         (``csrc/qlc_fused_decode.cu``; replaces
                         ``repro/kernels/qlc_fused.py::fused_decode_pallas``).

The codes kernels K3-K5 have their wrappers in ``kernels.qlc_codes``
and the histogram K6 in ``kernels.histogram256``; all build here.
Each source has a plain C interface and is compiled at first use by
``nvcc`` into its own shared library under
``build/torch_kernels/`` in the checkout, named by a digest of the
source, the shared headers and the flags, and loaded with ``ctypes``.
All sources build in parallel. Nothing is compiled or loaded when this
module is imported.

The wrappers take CUDA tensors only: the CPU route to the plain versions
lives in ``kernels.ops``. Each wrapper counts its launches in a plain
int attribute (``fused_encode.launches``, ``fused_decode.launches``),
incremented once per kernel launch and nowhere else.

Launch geometry (set by the C launchers). K1 runs persistent CTAs of 1,
2, 4 or 8 independent warps, one chunk per warp at a time and one
32-symbol block per lane; each warp holds two staged 1024-symbol pieces
of its input, its slot and, with ``emit_hist``, 256 bins in dynamic
shared memory, and the launcher takes the most warps whose CTA still
lets two CTAs share an SM. K2 runs CTAs of 4 warps, one thread per chunk
and 32 chunks per warp; each warp holds a 32 x 36 store tile and a ring
of 32 words per thread (64 for prefixes over 5 bits), and the CTA a
decode table of 2^(prefix_bits + 9) bytes per scheme (4 KiB at the
paper's 3-bit prefix) in dynamic shared memory, at least a quarter of an
SM's, so that at most four CTAs share an SM. Both take codes of at most
16 bits (prefix_bits at most 8).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("qlc_fused_encode", "qlc_fused_decode", "qlc_encode",
           "qlc_decode", "qlc_prefetch", "histogram256")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
MAX_SMEM = 48 * 1024
#: K1's widest slot, 44 KiB, the widest its first design took: a CTA of
#: one warp then takes 56 KiB of shared memory.
ENCODE_MAX_CAP = (MAX_SMEM - 4096) // 4
#: The longest code K1 and K2 take: two codes fill one 32-bit step.
MAX_CODE_BITS = 16

_LIBS: Dict[str, ctypes.CDLL] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_ARGTYPES = {
    "qlc_fused_encode": [_P, _I, _L, _L, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                         _P],
    "qlc_fused_encode_e4m3": [_P, _L, _P, _P],
    "qlc_fused_decode": [_P, _L, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _L,
                         _P, _P, _I, _P],
    "qlc_encode": [_P, _L, _L, _P, _P, _I, _P, _P, _I, _I, _I, _P],
    "qlc_encode_grid_warps": [_L, _I, _I, _I, _I],
    "qlc_decode": [_P, _L, _I, _P, _P, _I, _I, _I, _L, _P, _P],
    "qlc_prefetch": [_P, _L, _I, _P, _P, _I, _I, _I, _L, _P, _I, _P],
    "histogram256": [_P, _L, _P, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on the machine with the card")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_kernels() -> Tuple[float, str]:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together. Returns (seconds, compiler log)."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {name}\n{text}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    return time.perf_counter() - t0, "\n".join(log)


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_kernels()
        lib = ctypes.CDLL(str(path))
        for fname, argtypes in _ARGTYPES.items():
            if fname == name or fname.startswith(f"{name}_"):
                fn = getattr(lib, fname)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _check(t: torch.Tensor, what: str, dtypes, ndim: int):
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its data starts on 16 bytes (the kernels' vector
    copies and stores need it), else a contiguous copy that does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_encode(x: torch.Tensor, enc_code: torch.Tensor,
                 enc_len: torch.Tensor, capacity_words: int, *,
                 emit_codes: bool = False, emit_hist: bool = False):
    """K1 on the card: float [n, K] (f32 or bf16) -> (words int32 [n, CW]
    (u32 bit patterns), nbits int32 [n], scales f32 [n, K/32]
    [, codes u8 [n, K]] [, hist int32 [256]]).

    ``enc_code`` / ``enc_len`` are int32 [256] CUDA tensors, codes of at
    most ``MAX_CODE_BITS`` bits (a scheme's prefix_bits at most 8; not
    checked here, which would cost a device-to-host read per call).
    """
    cap = int(capacity_words)
    if not 1 <= cap <= ENCODE_MAX_CAP:
        raise ValueError(f"capacity_words {cap} outside [1, {ENCODE_MAX_CAP}]")
    if x.dim() != 2 or x.shape[1] % 32 or x.shape[1] <= 0:
        raise ValueError(f"x {tuple(x.shape)} must be [n, K], K a positive "
                         "multiple of 32")
    _check(x, "x", (torch.float32, torch.bfloat16), 2)
    for t, what in ((enc_code, "enc_code"), (enc_len, "enc_len")):
        _check(t, what, (torch.int32,), 1)
        if t.numel() != 256 or t.device != x.device:
            raise ValueError(f"{what} must be 256 entries on {x.device}")
    n, k = x.shape
    bf16 = x.dtype == torch.bfloat16
    x = _aligned16(x)
    dev = x.device
    words = torch.empty((n, cap), dtype=torch.int32, device=dev)
    nbits = torch.empty((n,), dtype=torch.int32, device=dev)
    scales = torch.empty((n, k // 32), dtype=torch.float32, device=dev)
    codes = (torch.empty((n, k), dtype=torch.uint8, device=dev)
             if emit_codes else None)
    hist = torch.zeros(256, dtype=torch.int32, device=dev) if emit_hist \
        else None
    rc = _lib("qlc_fused_encode").qlc_fused_encode(
        x.data_ptr(), int(bf16), n, k,
        enc_code.data_ptr(), enc_len.data_ptr(), cap, words.data_ptr(),
        nbits.data_ptr(), scales.data_ptr(),
        codes.data_ptr() if codes is not None else None,
        hist.data_ptr() if hist is not None else None, 0, _stream(x))
    if rc != 0:
        raise RuntimeError(f"K1 fused_encode launch failed: CUDA error {rc}")
    fused_encode.launches += 1
    out = [words, nbits, scales]
    if codes is not None:
        out.append(codes)
    if hist is not None:
        out.append(hist)
    return tuple(out)


fused_encode.launches = 0


def e4m3_encode(x: torch.Tensor) -> torch.Tensor:
    """K1's e4m3 encoder on its own, on the card: f32 (any shape) -> u8
    codes, what K1 gives each scaled element. For holding it against
    the plain encoder over every f32 bit pattern."""
    _check(x.reshape(-1), "x", (torch.float32,), 1)
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    rc = _lib("qlc_fused_encode").qlc_fused_encode_e4m3(
        x.data_ptr(), x.numel(), out.data_ptr(), _stream(x))
    if rc != 0:
        raise RuntimeError(f"K1 e4m3 encoder launch failed: CUDA error {rc}")
    e4m3_encode.launches += 1
    return out


e4m3_encode.launches = 0

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1}


def fused_decode(words: torch.Tensor, scales: torch.Tensor,
                 scheme_ids: torch.Tensor, dec_lut: torch.Tensor,
                 area_sb: torch.Tensor, area_starts: torch.Tensor,
                 value_tab: torch.Tensor, chunk_symbols: int, *,
                 prefix_bits: int, out_dtype=torch.float32,
                 acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 on the card: words int32 [n, CW], scales f32 [n, K/32], scheme
    slots int32 [n] (clamped into [0, S) by the kernel), stacked LUTs
    int32 ``dec_lut [S, 256]`` / ``area_* [S, A]``, value table f32
    [256] -> [n, K] in ``out_dtype`` (f32 or bf16), or ``acc + value`` in
    f32 when ``acc`` is given.

    ``value_tab`` is the e4m3 value table (``quant.e4m3.decode_table``,
    which ``kernels.ops`` passes; not checked here, which would cost a
    device-to-host read per call): K2 keeps each value in a 2-byte table
    entry beside its code length, which holds e4m3 values only.
    Stacked schemes must fit their decode tables, 2^(prefix_bits + 9)
    bytes each, in one CTA's shared memory: up to 47 schemes at a 3-bit
    prefix, one at 8 bits; the launch fails with CUDA error 1 past that."""
    k = int(chunk_symbols)
    if k % 32 or k <= 0:
        raise ValueError(f"chunk_symbols {k} must be a positive multiple "
                         "of 32")
    if not 0 <= int(prefix_bits) <= MAX_CODE_BITS - 8:
        raise ValueError(f"prefix_bits {prefix_bits} outside [0, "
                         f"{MAX_CODE_BITS - 8}]: K2 takes codes of at most "
                         f"{MAX_CODE_BITS} bits")
    _check(words, "words", (torch.int32,), 2)
    n, cw = words.shape
    _check(scales, "scales", (torch.float32,), 2)
    _check(scheme_ids, "scheme_ids", (torch.int32,), 1)
    for t, what in ((dec_lut, "dec_lut"), (area_sb, "area_sb"),
                    (area_starts, "area_starts")):
        _check(t, what, (torch.int32,), 2)
    _check(value_tab, "value_tab", (torch.float32,), 1)
    s, a = area_sb.shape
    if (scales.shape != (n, k // 32) or scheme_ids.shape != (n,)
            or dec_lut.shape != (s, 256) or area_starts.shape != (s, a)
            or a != 1 << int(prefix_bits) or value_tab.shape != (256,)):
        raise ValueError("operand shapes disagree: words "
                         f"{tuple(words.shape)}, scales {tuple(scales.shape)},"
                         f" sid {tuple(scheme_ids.shape)}, dec_lut "
                         f"{tuple(dec_lut.shape)}, area {tuple(area_sb.shape)}"
                         f" at prefix_bits {prefix_bits}")
    if acc is not None:
        _check(acc, "acc", (torch.float32,), 2)
        if acc.shape != (n, k):
            raise ValueError(f"acc shape {tuple(acc.shape)} != {(n, k)}")
        kind, out_dtype = 2, torch.float32
        acc = _aligned16(acc)
    else:
        if out_dtype not in _OUT_KIND:
            raise TypeError(f"out_dtype {out_dtype} not in f32/bf16")
        kind = _OUT_KIND[out_dtype]
    words = _aligned16(words)
    out = torch.empty((n, k), dtype=out_dtype, device=words.device)
    rc = _lib("qlc_fused_decode").qlc_fused_decode(
        words.data_ptr(), n, cw, scales.data_ptr(), scheme_ids.data_ptr(),
        dec_lut.data_ptr(), area_sb.data_ptr(), area_starts.data_ptr(), s, a,
        int(prefix_bits), value_tab.data_ptr(), k,
        acc.data_ptr() if acc is not None else None, out.data_ptr(), kind,
        _stream(words))
    if rc != 0:
        raise RuntimeError(f"K2 fused_decode launch failed: CUDA error {rc}")
    fused_decode.launches += 1
    return out


fused_decode.launches = 0
