"""Port parity, host side: e4m3 quantization, codec tables, planner and
registry JSON of ``repro_torch`` against the JAX reference ``repro``.

Inputs come from numpy with fixed seeds and go to both packages.
Floats that are subnormal in f32 are left out of the quantizer inputs
(and blocks whose scale would be): XLA on the CPU flushes them to zero,
while torch and the CUDA kernels keep IEEE subnormals. e4m3's own
subnormals (multiples of 2**-9) are normal f32 values and are covered.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.planner import plan_for_tables as j_plan
from repro.core import TABLE1, TABLE2, build_tables, distributions
from repro.core import CodecRegistry as JRegistry
from repro.core.adapt import select_scheme as j_select
from repro.quant import e4m3 as je
from repro_torch.comm.planner import plan_for_tables as t_plan
from repro_torch.core import CodecRegistry as TRegistry
from repro_torch.core import lut as t_lut, schemes as t_schemes
from repro_torch.core.adapt import select_scheme as t_select
from repro_torch.quant import e4m3 as te
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

_POS = je.decode_table()[:128].astype(np.float64)


def _raw_adversarial() -> np.ndarray:
    """Values straight on, between and beyond the e4m3 grid."""
    ties = ((_POS[:-1] + _POS[1:]) / 2).astype(np.float32)  # exact in f32
    grid = _POS.astype(np.float32)
    nudged = np.concatenate([np.nextafter(ties, np.float32(0)),
                             np.nextafter(ties, np.float32(1000))])
    special = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 480.0,
                        480.1, 496.0, 1e30, 2.0 ** -9, 2.0 ** -10,
                        3 * 2.0 ** -10, 2.0 ** -6, 2.0 ** -20], np.float32)
    v = np.concatenate([grid, ties, nudged, special])
    return np.concatenate([v, -v]).astype(np.float32)


def _blocks_adversarial(rng) -> np.ndarray:
    """[rows, 256] float32: random blocks with the raw values mixed in,
    plus all-zero, NaN-holding and infinity-holding blocks."""
    raw = _raw_adversarial()
    x = (rng.standard_normal((64, 256)) * 3).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, raw.size, replace=False)
    flat[idx] = raw
    x[1, :32] = 0.0
    x[2, :32] = -0.0
    x[3, 32:64] = np.float32(480.0) * np.arange(32, dtype=np.float32) / 31
    x[4, :] = (rng.standard_normal(256) * 1e-3).astype(np.float32)
    return x


@pytest.mark.parametrize("case", ["raw", "blocks"])
def test_e4m3_encode_bit_equal(case):
    rng = np.random.default_rng(1)
    x = _raw_adversarial() if case == "raw" else _blocks_adversarial(rng)
    a = np.asarray(je.e4m3_encode(jnp.asarray(x)))
    b = te.e4m3_encode(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 37.5])
def test_quantize_dequantize_bit_equal(scale):
    rng = np.random.default_rng(2)
    x = _blocks_adversarial(rng) * np.float32(scale)
    cj, sj = je.quantize_block32(jnp.asarray(x))
    ct, st = te.quantize_block32(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_array_equal(np.asarray(sj).view(np.uint32),
                                  st.numpy().view(np.uint32))
    dj = je.dequantize_block32(cj, sj)
    dt = te.dequantize_block32(ct, st)
    np.testing.assert_array_equal(np.asarray(dj).view(np.uint32),
                                  dt.numpy().view(np.uint32))
    np.testing.assert_array_equal(je.decode_table(), te.decode_table())


def _counts(kind: str) -> np.ndarray:
    if kind == "ffn1":
        return np.asarray(distributions.ffn1_counts(1 << 14, seed=0))
    if kind == "ffn2":
        return np.asarray(distributions.ffn2_counts(1 << 14, seed=1))
    rng = np.random.default_rng(3)          # a calibrated e4m3 histogram
    x = (rng.standard_normal(1 << 14) * 0.02).astype(np.float32)
    codes, _ = te.quantize_block32(torch.from_numpy(x))
    return np.bincount(codes.numpy(), minlength=256).astype(np.float64)


@pytest.mark.parametrize("scheme", ["table1", "table2"])
@pytest.mark.parametrize("kind", ["ffn1", "ffn2", "calibrated"])
def test_codec_tables_equal(scheme, kind):
    counts = _counts(kind)
    js = {"table1": TABLE1, "table2": TABLE2}[scheme]
    ts = {"table1": t_schemes.TABLE1, "table2": t_schemes.TABLE2}[scheme]
    jt = build_tables(counts, js)
    tt = t_lut.build_tables(counts, ts)
    for f in ("enc_code", "enc_len", "dec_lut", "area_symbol_bits",
              "area_starts"):
        a, b = getattr(jt, f), getattr(tt, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert jt.prefix_bits == tt.prefix_bits
    assert jt.max_code_length == tt.max_code_length
    assert dataclass_tuple(j_plan(jt, counts)) == dataclass_tuple(
        t_plan(tt, counts))
    js_sel = j_select(counts, allow_search=True)
    ts_sel = t_select(counts, allow_search=True)
    assert js_sel.scheme_name == ts_sel.scheme_name
    assert js_sel.scheme.areas == ts_sel.scheme.areas
    assert js_sel.expected_bits == ts_sel.expected_bits


def dataclass_tuple(plan):
    return (plan.chunk_symbols, plan.capacity_words, plan.pool_slots_per_1k,
            plan.expected_bits_per_symbol, plan.escape_prob_bound,
            plan.drift_margin_bits)


def _fill(reg):
    reg.register("grads", _counts("ffn1"))
    reg.register("acts", _counts("ffn2"))
    reg.register("grads_alias", _counts("ffn1"))           # aliases id 0
    reg.register("params", _counts("calibrated"), scheme_id=7)
    return reg


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_registry_json_loads_both_ways(direction):
    src_cls, dst_cls = ((JRegistry, TRegistry) if direction == "jax_to_torch"
                        else (TRegistry, JRegistry))
    src = _fill(src_cls())
    text = src.to_json()
    dst = dst_cls.from_json(text)
    assert src.names() == dst.names()
    for name in src.names():
        a, b = src[name], dst[name]
        assert a.scheme_id == b.scheme_id, name
        assert a.scheme.areas == b.scheme.areas
        for f in ("enc_code", "enc_len", "dec_lut"):
            np.testing.assert_array_equal(getattr(a.tables, f),
                                          getattr(b.tables, f))
    assert [e.scheme_id for e in src.entries()] == \
        [e.scheme_id for e in dst.entries()]
    assert json.loads(dst.to_json())["entries"] == \
        json.loads(text)["entries"]


def test_registry_caches_survive_the_port():
    """Transport and link caches written by the reference's collectives
    pass through a load/save in the port unchanged."""
    from repro.comm.planner import TransportConfig
    src = _fill(JRegistry())
    src.cache_transport(0, "data", 1 << 20, TransportConfig("ring", 2))
    src.cache_link_constants("data", "ici", wire_Bps=4.5e10, alpha_s=2e-6)
    back = JRegistry.from_json(TRegistry.from_json(src.to_json()).to_json())
    assert back.transport_cache() == src.transport_cache()
    assert back.link_cache() == src.link_cache()
    assert back.to_json_dict() == src.to_json_dict()
