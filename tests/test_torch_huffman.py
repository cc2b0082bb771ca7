"""Port parity, host tables and stream helpers: the canonical Huffman
baseline (``repro_torch.core.huffman``) and the codec's whole-array
helpers (``raw_words``, ``pad_to_chunks``, ``encode_stream``,
``decode_stream``, ``compressed_bits``, ``measured_compressibility``)
against the reference's, and the compressibility rows of
``benchmarks/BENCH_baseline.json`` reproduced by the port on symbols
drawn through the reference's ``core.distributions``.

Everything here is exact: integer tables and words, and float64 means
rounded as the benchmark rounds them. The baseline's rows were recorded
at the benchmark's smoke size (2^15 symbols) under JAX's earlier default
random-bit generation (``jax_threefry_partitionable`` off; newer JAX
turns it on, which draws other streams), so the rows' streams are drawn
under that setting.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TABLE1 as JTABLE1, TABLE2 as JTABLE2
from repro.core import codec as jcodec
from repro.core import huffman as jhuffman
from repro.core.distributions import (ffn1_symbols, ffn2_symbols,
                                      histogram256)
from repro.core.lut import build_tables as jbuild_tables
from repro_torch.core import TABLE1, TABLE2, build_tables
from repro_torch.core import codec as tcodec
from repro_torch.core import huffman as thuffman
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

#: ``BENCH_baseline.json``: (stream, qlc table, qlc %, huffman %).
ROWS = [("ffn1", TABLE1, 15.61, 17.65), ("ffn2", TABLE2, 22.64, 26.86)]


@pytest.fixture(scope="module")
def streams():
    return {"ffn1": ffn1_symbols(1 << 16), "ffn2": ffn2_symbols(1 << 16)}


@pytest.fixture(scope="module")
def baseline_streams():
    with jax.threefry_partitionable(False):
        return {"ffn1": ffn1_symbols(1 << 15), "ffn2": ffn2_symbols(1 << 15)}


@pytest.mark.parametrize("name,table,qlc_pct,huffman_pct", ROWS)
def test_benchmark_compressibility_rows(baseline_streams, name, table,
                                        qlc_pct, huffman_pct):
    """``compressibility_ffn1`` (qlc_t1 15.61 %, huffman 17.65 %) and
    ``compressibility_ffn2`` (qlc_t2 22.64 %, huffman 26.86 %): the port's
    measured compressibility of the stream under the table's codec, and
    its Huffman code's, to the benchmark's two decimals."""
    syms = baseline_streams[name]
    counts = histogram256(syms)
    got = tcodec.measured_compressibility(torch.from_numpy(syms.copy()),
                                          build_tables(counts, table))
    assert round(100 * got, 2) == qlc_pct
    smooth = np.maximum(counts, 1e-9)
    hc = thuffman.HuffmanCodec(smooth)
    assert round(100 * hc.compressibility(smooth), 2) == huffman_pct
    jt = jbuild_tables(counts, JTABLE1 if table is TABLE1 else JTABLE2)
    assert got == jcodec.measured_compressibility(syms, jt)


@pytest.mark.parametrize("name", ["ffn1", "ffn2"])
def test_huffman_tables_and_bitstream_match_reference(streams, name):
    counts = histogram256(streams[name]).astype(np.float64)
    counts[::7] = 0.0                   # absent symbols get length 0
    t, j = thuffman.HuffmanCodec(counts), jhuffman.HuffmanCodec(counts)
    np.testing.assert_array_equal(t.lengths, j.lengths)
    np.testing.assert_array_equal(t.codes, j.codes)
    np.testing.assert_array_equal(t.children, j.children)
    assert t.expected_bits(counts) == j.expected_bits(counts)
    syms = streams[name][:2048]
    syms = syms[counts[syms] > 0]
    data, nbits = t.encode(syms)
    jdata, jnbits = j.encode(syms)
    assert nbits == jnbits
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(t.decode(data, nbits, syms.size), syms)
    one = np.zeros(256)
    one[9] = 5.0
    np.testing.assert_array_equal(thuffman.code_lengths(one),
                                  jhuffman.code_lengths(one))
    with pytest.raises(ValueError, match="nonzero"):
        thuffman.code_lengths(np.zeros(256))


@pytest.mark.parametrize("k", [32, 1024])
def test_stream_helpers_match_reference(streams, k):
    syms = streams["ffn2"][:5 * k + 17].reshape(-1, 1).copy()
    counts = histogram256(streams["ffn2"])
    tt, jt = build_tables(counts, TABLE2), jbuild_tables(counts, JTABLE2)
    assert tcodec.raw_words(k) == jcodec.raw_words(k)
    chunks, n = tcodec.pad_to_chunks(torch.from_numpy(syms), k)
    jchunks, jn = jcodec.pad_to_chunks(jnp.asarray(syms), k)
    assert n == jn == syms.size
    np.testing.assert_array_equal(chunks.numpy(), np.asarray(jchunks))
    words, nbits, n = tcodec.encode_stream(torch.from_numpy(syms), tt, k)
    jwords, jnbits, _ = jcodec.encode_stream(jnp.asarray(syms), jt, k)
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(jwords))
    np.testing.assert_array_equal(nbits.numpy(), np.asarray(jnbits))
    out = tcodec.decode_stream(words, tt, k, n, shape=syms.shape)
    np.testing.assert_array_equal(out.numpy(), syms)
    got = tcodec.compressed_bits(torch.from_numpy(syms), tt)
    assert got.dtype == torch.float32
    assert float(got) == float(jcodec.compressed_bits(jnp.asarray(syms),
                                                      jt))
    padded = tcodec.compressed_bits(chunks, tt)
    assert float(padded) == float(nbits.sum()) >= float(got)
