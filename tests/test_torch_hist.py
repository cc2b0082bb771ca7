"""Port parity, calibration: the plain version of K6 (the 256-bin
histogram) and the gradient calibration it feeds, against the JAX
reference, bit for bit.

The reference's K6 runs in interpret mode on the CPU. The calibration is
held bit-equal on the SAME f32 array fed to both packages (tables and
every plan field): gradients computed by the two frameworks differ in
their last bits, so the gradient path itself is compared in
``test_torch_train.py`` at a stated tolerance. Inputs hold no f32
subnormals (XLA on the CPU flushes them; torch keeps them).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import calibrate as jcal
from repro.comm.planner import plan_for_tables as j_plan_for_tables
from repro.core import TABLE1, build_tables, distributions
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.quant import e4m3 as je4m3
from repro_torch.comm import calibrate as tcal
from repro_torch.comm.planner import plan_for_tables
from repro_torch.core import lut as t_lut, schemes as t_schemes
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from tests.torch_dist import one_cpu_thread

one_cpu_thread()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("n", [128, 1024, 4096, 5000, 12345])
def test_k6_plain_matches_reference(n, rng):
    """The reference test's sizes (its kernel pads to 128 x 8 and takes
    the padding back out of bin 0; the port pads nothing)."""
    syms = rng.integers(0, 256, size=n, dtype=np.uint8)
    want = np.asarray(jops.histogram(jnp.asarray(syms)))
    np.testing.assert_array_equal(
        want, np.asarray(jref.histogram256_ref(jnp.asarray(syms))))
    got = tops.histogram(torch.from_numpy(syms))
    assert got.dtype == torch.int32 and got.shape == (256,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tref.histogram256_ref(torch.from_numpy(syms)).numpy(), want)


def test_k6_plain_on_a_real_stream_any_shape():
    """A skewed e4m3 stream, longer than one plain slice, given 2-D."""
    syms = np.array(distributions.ffn2_symbols(1 << 17, seed=3))
    want = np.bincount(syms, minlength=256)
    got = tops.histogram(torch.from_numpy(syms.reshape(-1, 1024)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.histogram(jnp.asarray(syms))))


def test_k6_rejects_non_u8():
    with pytest.raises(TypeError, match="u8"):
        tops.histogram(torch.zeros(8, dtype=torch.int32))


def test_symbol_counts_sum_in_int64():
    syms = torch.from_numpy(distributions.ffn1_symbols(1 << 14, seed=5))
    counts = tcal.symbol_counts(syms)
    assert counts.dtype == np.float64
    np.testing.assert_array_equal(
        counts, np.bincount(syms.numpy(), minlength=256))


def _grad_like(n: int, seed: int) -> np.ndarray:
    """A gradient-like flat f32 vector: heavy-tailed, with regions of
    different scale (a mixture of tensor types), no subnormals."""
    rng = np.random.default_rng(seed)
    x = rng.standard_t(3, n).astype(np.float32) * 1e-3
    x[: n // 4] *= 40.0
    x[n // 2: n // 2 + n // 8] *= 1e-2
    x[5] = 0.0
    return x


def _plan_fields(plan):
    return (plan.chunk_symbols, plan.capacity_words, plan.pool_slots_per_1k,
            plan.expected_bits_per_symbol, plan.escape_prob_bound,
            plan.drift_margin_bits)


def _same_tables(a, b):
    for f in ("enc_code", "enc_len", "dec_lut", "area_symbol_bits",
              "area_starts"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert a.prefix_bits == b.prefix_bits
    assert tuple(a.scheme.areas) == tuple(b.scheme.areas)


@pytest.mark.parametrize("n,chunk", [(40 * 1024 + 17, 1024),
                                     (300 * 256 + 64, 256)])
def test_calibrate_for_tensor_bit_equal(n, chunk):
    """Tables and every plan field from the same array, empirical slot
    sizing included (the per-chunk bit sums on the tensor's device, the
    percentile on the host)."""
    x = _grad_like(n, 1)
    jt, jp = jcal.calibrate_for_tensor(jnp.asarray(x), chunk_symbols=chunk)
    tt, tp = tcal.calibrate_for_tensor(torch.from_numpy(x),
                                       chunk_symbols=chunk)
    _same_tables(jt, tt)
    assert _plan_fields(jp) == _plan_fields(tp)


@pytest.mark.parametrize("cap_pool", [None, 64])
def test_empirical_plan_bit_equal(cap_pool):
    """``empirical_plan`` from numpy or torch symbols equals the
    reference's, with and without the pool cap; short streams keep the
    plan."""
    syms = distributions.ffn1_symbols(1 << 15, seed=7)
    counts = np.maximum(np.bincount(syms, minlength=256).astype(np.float64),
                        1e-6)
    jt, tt = build_tables(counts, TABLE1), t_lut.build_tables(
        counts, t_schemes.TABLE1)
    jplan = j_plan_for_tables(jt, counts, chunk_symbols=512)
    tplan = plan_for_tables(tt, counts, chunk_symbols=512)
    want = jcal.empirical_plan(jt, syms, jplan, chunk_symbols=512,
                               max_pool_slots_per_1k=cap_pool)
    for s in (syms, torch.from_numpy(syms)):
        got = tcal.empirical_plan(tt, s, tplan, chunk_symbols=512,
                                  max_pool_slots_per_1k=cap_pool)
        assert _plan_fields(got) == _plan_fields(want)
    short = syms[:7 * 512]
    assert tcal.empirical_plan(tt, short, tplan, chunk_symbols=512) is tplan


def test_quantized_symbols_leave_out_partial_block():
    x = _grad_like(32 * 5 + 7, 2)
    codes = tcal.quantized_symbols(torch.from_numpy(x))
    assert codes.shape == (160,) and codes.dtype == torch.uint8
    jcodes = np.asarray(je4m3.quantize_block32(jnp.asarray(x[:160]))[0])
    np.testing.assert_array_equal(codes.numpy(), jcodes)
