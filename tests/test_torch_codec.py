"""Port parity, codec and kernels: the pure-torch codec and the plain
versions of K1 (fused quantize+encode) and K2 (fused decode+dequantize)
against the JAX reference, bit for bit. The reference's Pallas kernels
run in interpret mode on the CPU, as in ``tests/test_fused_kernels.py``.

Words travel as int32 in the port and uint32 in the reference; they are
compared as bit patterns. The CUDA kernels are held against these plain
versions on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TABLE1, TABLE2, build_tables
from repro.core import codec as jcodec
from repro.kernels import ops as jops
from repro_torch.core import codec as tcodec
from repro_torch.core import lut as t_lut, schemes as t_schemes
from repro_torch.kernels import ops as tops
from repro_torch.quant import e4m3 as te
from tests.torch_dist import one_cpu_thread

one_cpu_thread()


def _counts(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(1 << 14) * 0.05).astype(np.float32)
    codes, _ = te.quantize_block32(torch.from_numpy(x))
    return np.bincount(codes.numpy(), minlength=256).astype(np.float64) + 1


@pytest.fixture(scope="module")
def tables():
    """(reference tables, port tables) for TABLE1 and TABLE2."""
    c1, c2 = _counts(0), _counts(1)
    return {"t1": (build_tables(c1, TABLE1),
                   t_lut.build_tables(c1, t_schemes.TABLE1)),
            "t2": (build_tables(c2, TABLE2),
                   t_lut.build_tables(c2, t_schemes.TABLE2))}


def _x(rows: int, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, k)) * 2).astype(np.float32)
    x[0, :6] = [np.nan, -np.nan, 0.0, -0.0, 1e9, -480.0]
    x[1, :32] = 0.0
    return x


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("scheme", ["t1", "t2"])
@pytest.mark.parametrize("cap", ["worst", "exact", "over"])
def test_encode_decode_chunks_match(tables, scheme, cap):
    jt, tt = tables[scheme]
    k = 256
    syms = te.quantize_block32(torch.from_numpy(_x(12, k, 3)))[0]
    nbits = tcodec.encode_chunk_bits(syms, tt.enc_len)
    words_cap = {"worst": tcodec.worst_case_words(k),
                 "exact": -(-int(nbits.max()) // 32),
                 "over": int(nbits.min()) // 32 - 4}[cap]
    wj, nj = jcodec.encode_chunks(jnp.asarray(syms.numpy()), jt, words_cap)
    wt, nt = tcodec.encode_chunks(syms, tt, words_cap)
    np.testing.assert_array_equal(np.asarray(wj), _u32(wt))
    np.testing.assert_array_equal(np.asarray(nj), nt.numpy())
    np.testing.assert_array_equal(nbits.numpy(), nt.numpy())
    dj = jcodec.decode_chunks(wj, jt, k)
    dt = tcodec.decode_chunks(wt, tt, k)
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    if cap != "over":
        np.testing.assert_array_equal(dt.numpy(), syms.numpy())


def test_decode_chunks_multi_mixed_schemes(tables):
    (j1, t1), (j2, t2) = tables["t1"], tables["t2"]
    k, rows = 128, 10
    syms = te.quantize_block32(torch.from_numpy(_x(rows, k, 4)))[0]
    cap = tcodec.worst_case_words(k)
    sid = np.arange(rows) % 2
    w1, _ = tcodec.encode_chunks(syms, t1, cap)
    w2, _ = tcodec.encode_chunks(syms, t2, cap)
    w = torch.where(torch.from_numpy(sid == 1)[:, None], w2, w1)
    dj = jcodec.decode_chunks_multi(jnp.asarray(_u32(w)), [j1, j2],
                                    jnp.asarray(sid), k)
    dt = tcodec.decode_chunks_multi(w, [t1, t2], torch.from_numpy(sid), k)
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    np.testing.assert_array_equal(dt.numpy(), syms.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [256, 1024])
def test_k1_plain_matches_reference_kernel(tables, dtype, k):
    jt, tt = tables["t1"]
    x32 = _x(9, k, 5)
    xt = torch.from_numpy(x32).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    cap = tcodec.worst_case_words(k)
    outs_j = jops.quantize_encode(xj, jt, cap, emit_codes=True,
                                  emit_hist=True)
    outs_t = tops.quantize_encode(xt, tt, cap, emit_codes=True,
                                  emit_hist=True)
    names = ("words", "nbits", "scales", "codes", "hist")
    for name, a, b in zip(names, outs_j, outs_t):
        a = np.asarray(a)
        b = b.numpy()
        if a.dtype.kind == "f":
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b.view(a.dtype), err_msg=name)
    assert int(outs_t[4].sum()) == 9 * k


def _wire(tables, k: int, rows: int):
    """Mixed-scheme K1 output (port plain version) for the K2 tests."""
    (j1, t1), (j2, t2) = tables["t1"], tables["t2"]
    xt = torch.from_numpy(_x(rows, k, 6))
    cap = tcodec.worst_case_words(k)
    w1, _, s1 = tops.quantize_encode(xt, t1, cap)
    w2, _, _ = tops.quantize_encode(xt, t2, cap)
    sid = np.arange(rows) % 2
    w = torch.where(torch.from_numpy(sid == 1)[:, None], w2, w1)
    return w, s1, sid, [j1, j2], [t1, t2]


@pytest.mark.parametrize("form", ["f32", "bf16", "accumulate_zero",
                                  "accumulate"])
def test_k2_plain_matches_reference_kernel(tables, form):
    """Bit-equal in every form. The accumulate form rounds the dequantize
    product to f32 before the add (no FMA), as the reference's kernel
    intends (its optimization barrier); on the CPU, XLA contracts the
    reference's interpret-mode kernel into an FMA anyway, which its own
    tests allow to one f32 ulp. So a live accumulator is held bit-equal
    to the reference's decode-then-add, and within the reference's own
    ulp tolerance of its fused form; a zero accumulator bit-equal to the
    fused form."""
    k, rows = 256, 10
    w, s, sid, jl, tl = _wire(tables, k, rows)
    wj, sj, sidj = jnp.asarray(_u32(w)), jnp.asarray(s.numpy()), \
        jnp.asarray(sid)
    if form.startswith("accumulate"):
        acc = np.random.default_rng(7).standard_normal((rows, k)).astype(
            np.float32)
        if form == "accumulate_zero":
            acc[:] = 0.0
        fused = jops.decode_dequantize_accumulate(
            jnp.asarray(acc), wj, sj, jl, k, scheme_ids=sidj)
        b = tops.decode_dequantize_accumulate(
            torch.from_numpy(acc), w, s, tl, k, scheme_ids=sid)
        np.testing.assert_allclose(b.numpy(), np.asarray(fused), rtol=1e-5,
                                   atol=1e-6)
        a = (fused if form == "accumulate_zero" else
             jnp.asarray(acc) + jops.decode_dequantize(wj, sj, jl, k,
                                                       scheme_ids=sidj))
    else:
        jd, td = ((jnp.float32, torch.float32) if form == "f32"
                  else (jnp.bfloat16, torch.bfloat16))
        a = jops.decode_dequantize(wj, sj, jl, k, scheme_ids=sidj,
                                   out_dtype=jd)
        b = tops.decode_dequantize(w, s, tl, k, scheme_ids=sid,
                                   out_dtype=td)
    a = np.asarray(a.astype(jnp.float32))
    np.testing.assert_array_equal(a.view(np.uint32),
                                  b.float().numpy().view(np.uint32))


def test_kernel_route_rejects_other_devices(tables):
    _, tt = tables["t1"]
    x = torch.zeros((2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        tops.quantize_encode(x, tt, 30)
