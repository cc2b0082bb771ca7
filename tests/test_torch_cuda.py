"""The port's CUDA kernels against their plain PyTorch versions, bit for
bit, on the card. Imports no jax, so it also runs where only the port is
installed. Without a card every test skips.

On the H100, from the repo root (the suite's ``tests/conftest.py``
imports the JAX package, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import codec, lut, schemes
from repro_torch.kernels import ops, ref
from repro_torch.quant import e4m3


def _tables():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1 << 14) * 0.05).astype(np.float32)
    counts = np.bincount(e4m3.quantize_block32(torch.from_numpy(x))[0]
                         .numpy(), minlength=256).astype(np.float64) + 1
    return [lut.build_tables(counts, schemes.TABLE1),
            lut.build_tables(counts[::-1].copy(), schemes.TABLE2)]


def _x(rows: int, k: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, k)) * 2).astype(np.float32)
    x[0, :8] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-40, 480.0]
    x[1, :32] = 0.0
    return torch.from_numpy(x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_kernel_matches_plain(cuda, dtype):
    t1 = _tables()[0]
    x = _x(64, 1024, 8).to(cuda, getattr(torch, dtype))
    for cap in (codec.worst_case_words(1024), 20):
        got = ops.quantize_encode(x, t1, cap, emit_codes=True,
                                  emit_hist=True)
        want = ref.quantize_encode_ref(x, t1, cap, emit_codes=True,
                                       emit_hist=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["f32", "bf16", "accumulate"])
def test_k2_kernel_matches_plain(cuda, form):
    tl = _tables()
    k, rows = 1024, 40
    x = _x(rows, k, 6).to(cuda)
    cap = codec.worst_case_words(k)
    w1, _, s = ops.quantize_encode(x, tl[0], cap)
    w2, _, _ = ops.quantize_encode(x, tl[1], cap)
    sid = (torch.arange(rows, device=cuda) % 2).to(torch.int32)
    w = torch.where((sid == 1)[:, None], w2, w1)
    acc = torch.randn((rows, k), generator=torch.Generator().manual_seed(0)
                      ).to(cuda)
    if form == "accumulate":
        got = ops.decode_dequantize_accumulate(acc, w, s, tl, k,
                                               scheme_ids=sid)
        want = ref.decode_dequantize_ref(w, s, tl, sid, k, acc=acc)
    else:
        od = torch.float32 if form == "f32" else torch.bfloat16
        got = ops.decode_dequantize(w, s, tl, k, scheme_ids=sid,
                                    out_dtype=od)
        want = ref.decode_dequantize_ref(w, s, tl, sid, k, out_dtype=od)
    assert torch.equal(got, want)


def _symbols(rows: int, k: int, seed: int) -> torch.Tensor:
    """u8 chunks: most rows skewed (they code below 8 bits/symbol), every
    fourth one uniform (it runs over a tight slot)."""
    rng = np.random.default_rng(seed)
    sym = np.minimum(rng.geometric(0.08, (rows, k)), 255).astype(np.uint8)
    sym[::4] = rng.integers(0, 256, (len(sym[::4]), k), dtype=np.uint8)
    return torch.from_numpy(sym)


def _sym_tables():
    counts = np.bincount(_symbols(64, 256, 1).numpy().reshape(-1),
                         minlength=256).astype(np.float64) + 1
    return [lut.build_tables(counts, schemes.TABLE1),
            lut.build_tables(counts[::-1].copy(), schemes.TABLE2)]


def _k3_equal(sym, tables, cap, what):
    got = ops.encode(sym, tables, cap)
    want = ref.encode_ref(sym, tables, cap)
    for a, b in zip(got, want):
        assert torch.equal(a, b), what


def _k3_caps(sym, tables, k):
    """The worst-case slot, the longest chunk's, the median chunk's (half
    the chunks over capacity) and one word."""
    nbits = codec.encode_chunk_bits(sym, tables.enc_len)
    return (codec.worst_case_words(k, int(tables.enc_len.max())),
            max(1, -(-int(nbits.max()) // 32)),
            max(1, int(nbits.float().median()) // 32), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 256, 1024, 4096])
def test_k3_kernel_matches_plain(cuda, k):
    """K3 against the plain encoder, bit for bit, at each of the caps of
    ``_k3_caps``, on n = 0, 1, 7, and one below and one above a full grid
    of warps (the persistent warps' second round); on symbol views at
    byte offsets 1-15 of their buffer; and under two tables back to
    back."""
    from repro_torch.kernels import qlc_codes as qc
    tl = _sym_tables()
    caps = _k3_caps(_symbols(64, k, 2).to(cuda), tl[0], k)
    for cap in caps:
        full = qc.encode_grid_chunks(k, cap, int(tl[0].enc_len.max()))
        for n in (0, 1, 7, full - 1, full + 1):
            _k3_equal(_symbols(n, k, n).to(cuda), tl[0], cap,
                      f"cap {cap} n {n}")
    sym = _symbols(7, k, 3).to(cuda)
    for offset in range(1, 16):
        buf = torch.zeros(sym.numel() + offset, dtype=torch.uint8,
                          device=cuda)
        buf[offset:] = sym.reshape(-1)
        view = buf[offset:].view(sym.shape)
        for cap in caps:
            _k3_equal(view, tl[0], cap, f"offset {offset} cap {cap}")
    for t in tl:
        for cap in caps:
            _k3_equal(sym, t, cap, f"second table cap {cap}")


def _long_tables(longest: int):
    """A hand-made table of ``_sym_tables()[0]``'s decode side with codes
    of random lengths in [0, longest] (0, 24 and ``longest`` among them)
    and random codes below 2^length: what K3 encodes, not a prefix
    code."""
    import dataclasses
    rng = np.random.default_rng(longest)
    length = rng.integers(0, longest + 1, 256)
    length[:3] = (0, min(24, longest), longest)
    code = (rng.integers(0, 1 << 32, 256, dtype=np.uint64)
            & ((np.uint64(1) << length.astype(np.uint64)) - np.uint64(1)))
    return dataclasses.replace(_sym_tables()[0],
                               enc_code=code.astype(np.uint32),
                               enc_len=length.astype(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("longest", [16, 17, 24, 32])
@pytest.mark.parametrize("k", [32, 256, 1024, 4096])
def test_k3_long_codes_match_plain(cuda, k, longest):
    """Codes up to 16 bits take K3's two-codes-per-step pack, longer ones
    its one-code step: both bit-equal to the plain encoder, up to 32-bit
    codes, at the caps of ``_k3_caps`` and over a full grid of warps."""
    from repro_torch.kernels import qlc_codes as qc
    t = _long_tables(longest)
    for cap in _k3_caps(_symbols(64, k, 4).to(cuda), t, k):
        n = qc.encode_grid_chunks(k, cap, longest) + 1
        _k3_equal(_symbols(n, k, 5).to(cuda), t, cap, f"cap {cap}")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [256, 1024])
@pytest.mark.parametrize("entry", ["decode", "decode_block_async"])
def test_k4_k5_kernels_match_plain(cuda, k, entry):
    """Two schemes interleaved by chunk, slots cut below the longest
    chunks (cursors run past the slot), an odd word count, and words
    that start at an odd offset of their buffer (K4's ring and K5's bulk
    copy read from the 16-byte aligned address below them)."""
    tl = _sym_tables()
    rows = 1000
    sym = _symbols(rows, k, 3).to(cuda)
    sid = (torch.arange(rows, device=cuda) % 2).to(torch.int32)
    nb = torch.maximum(codec.encode_chunk_bits(sym, tl[0].enc_len),
                       codec.encode_chunk_bits(sym, tl[1].enc_len))
    fn = getattr(ops, entry)
    for cap in (-(-int(nb.max()) // 32) | 1, int(nb.float().median()) // 32):
        w1, _ = ops.encode(sym, tl[0], cap)
        w2, _ = ops.encode(sym, tl[1], cap)
        w = torch.where((sid == 1)[:, None], w2, w1)
        buf = torch.zeros(w.numel() + 1, dtype=torch.int32, device=cuda)
        buf[1:] = w.reshape(-1)
        w_odd = buf[1:].view(rows, cap)
        want = ref.decode_ref(w, tl, sid, k)
        for words in (w, w_odd):
            assert torch.equal(fn(words, tl, k, scheme_ids=sid), want), cap


@pytest.mark.cuda
def test_k5_wide_slots_take_smaller_tiles(cuda):
    """Worst-case 4096-symbol slots (1409 words): two slots of 32 chunks
    do not fit K5's shared memory, two of 16 do; bit-equal to the plain
    decode, as at 1024-symbol worst-case slots (353 words, 32 chunks)."""
    from repro_torch.kernels import qlc_codes
    t1 = _sym_tables()[0]
    for k, rows in ((1024, 32), (4096, 16)):
        cap = codec.worst_case_words(k)
        assert qlc_codes.prefetch_tile_rows(1, 3, cap) == rows
        sym = _symbols(200, k, 4).to(cuda)
        w, _ = ops.encode(sym, t1, cap)
        assert torch.equal(ops.decode_block_async(w, t1, k), sym)


def _at_offset(w: torch.Tensor, offset: int) -> torch.Tensor:
    """``w``'s values as a view that starts ``offset`` words into its
    buffer."""
    buf = torch.zeros(w.numel() + offset, dtype=torch.int32,
                      device=w.device)
    buf[offset:] = w.reshape(-1)
    return buf[offset:].view(w.shape)


def _edge_words(cuda, n: int, k: int, cw: int, tl, seed: int):
    """Words [n, cw] of skewed and uniform chunks under schemes drawn at
    random per chunk (slots the longer chunks overrun unless cw is wide),
    with a quarter of the rows replaced by random u32 words."""
    rng = np.random.default_rng(seed)
    sym = _symbols(n, k, seed)
    sid = rng.integers(0, len(tl), n).astype(np.int32)
    w = torch.zeros((n, cw), dtype=torch.int32)
    for j, t in enumerate(tl):
        wj, _ = ref.encode_ref(sym, t, cw)
        w[sid == j] = wj[sid == j]
    bad = rng.random(n) < 0.25
    w[bad] = torch.from_numpy(rng.integers(
        0, 1 << 32, (int(bad.sum()), cw), dtype=np.uint64
    ).astype(np.uint32).view(np.int32))
    return w.to(cuda), torch.from_numpy(sid).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["decode", "decode_block_async"])
@pytest.mark.parametrize("k", [4, 36, 100, 256, 1024])
@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_k4_k5_edge_cases(cuda, n, k, entry):
    """K4 / K5 against the plain decode, bit for bit: row counts around a
    warp's 32 chunks, chunks of one short block (k = 4) to 32 blocks,
    ragged last blocks (36, 100), slots of one word, of an even and an
    odd count at the longest chunk's size, corrupted rows, and words at
    word offsets 0 and 1 (odd) of their buffer."""
    tl = _sym_tables()
    fit = max(-(-int(codec.encode_chunk_bits(_symbols(n, k, n + k),
                                             t.enc_len).max()) // 32)
              for t in tl)
    fn = getattr(ops, entry)
    for cw in sorted({1, fit + (fit & 1), fit | 1}):
        w, sid = _edge_words(cuda, n, k, cw, tl, n + k)
        want = ref.decode_ref(w, tl, sid, k)
        for offset in (0, 1):
            got = fn(_at_offset(w, offset), tl, k, scheme_ids=sid)
            assert torch.equal(got, want), (cw, offset)


def _most_schemes(entry: str, cw: int) -> int:
    """The most 3-bit-prefix schemes K4 (``"decode"``) or K5 stacks at
    ``cw``-word slots: K5 takes smaller tiles to fit more."""
    from repro_torch.kernels import qlc_codes as qc
    fits = ((lambda s: qc.decode_smem(s, 3) <= qc.CTA_SMEM)
            if entry == "decode" else
            (lambda s: qc.prefetch_tile_rows(s, 3, cw) > 0))
    return max(s for s in range(1, 64) if fits(s))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["decode", "decode_block_async"])
def test_k4_k5_most_stacked_schemes(cuda, entry):
    """As many 3-bit-prefix schemes as the wrapper takes (their window
    tables fill the CTA's shared memory), ids drawn over all of them:
    bit-equal; one more scheme is refused before launch."""
    k, n = 256, 700
    cw = 45
    most = _most_schemes(entry, cw)
    rng = np.random.default_rng(21)
    tl = [lut.build_tables(rng.integers(1, 1000, 256).astype(np.float64),
                           (schemes.TABLE1, schemes.TABLE2)[i % 2])
          for i in range(most + 1)]
    w, sid = _edge_words(cuda, n, k, cw, tl[:most], 22)
    fn = getattr(ops, entry)
    assert torch.equal(fn(w, tl[:most], k, scheme_ids=sid),
                       ref.decode_ref(w, tl[:most], sid, k))
    with pytest.raises(ValueError, match="shared memory"):
        fn(w, tl, k, scheme_ids=sid)


@pytest.mark.cuda
@pytest.mark.parametrize("prefix_bits", [4, 5, 6, 8])
@pytest.mark.parametrize("entry", ["decode", "decode_block_async"])
def test_k4_k5_wide_prefixes(cuda, prefix_bits, entry):
    """Codes of up to prefix + 8 bits (16 at a prefix of 8: two codes per
    top-up, the 64-word ring) at the worst-case slot and at one the
    median chunk overruns, corrupted rows mixed in: bit-equal."""
    k, n = 1024, 70
    counts = np.bincount(_symbols(64, k, 5).numpy().reshape(-1),
                         minlength=256) + 1.0
    tl = [lut.build_tables(counts, sc) for sc in _wide_schemes(prefix_bits)]
    if prefix_bits == 8:
        tl = tl[:1]
    nb = max(int(codec.encode_chunk_bits(_symbols(n, k, 23), t.enc_len)
                 .float().median()) for t in tl)
    fn = getattr(ops, entry)
    for cw in (codec.worst_case_words(k, prefix_bits + 8), max(1, nb // 32)):
        w, sid = _edge_words(cuda, n, k, cw, tl, 23)
        assert torch.equal(fn(w, tl, k, scheme_ids=sid),
                           ref.decode_ref(w, tl, sid, k)), cw


@pytest.mark.cuda
def test_decode_entries_make_no_blocking_reads(cuda):
    """After one warm call, the decode entry points (K4, K5, K2 and its
    accumulate form) and the encode entries run with device-resident
    scheme ids and no synchronizing call: torch's sync debug mode set to
    "error" raises on none. Scheme ids given as a host list are still
    range-checked."""
    tl = _sym_tables()
    k, n = 256, 96
    sym = _symbols(n, k, 9).to(cuda)
    sid = (torch.arange(n, device=cuda) % 2).to(torch.int32)
    words = ops.encode(sym, tl[0], 89)[0]
    x = _x(n, 1024, 10).to(cuda)
    wv, _, sc = ops.quantize_encode(x, tl[0], codec.worst_case_words(1024))
    acc = torch.zeros((n, 1024), device=cuda)
    calls = [
        lambda: ops.decode(words, tl, k, scheme_ids=sid),
        lambda: ops.decode_block_async(words, tl, k, scheme_ids=sid),
        lambda: ops.decode_dequantize(wv, sc, tl, 1024, scheme_ids=sid),
        lambda: ops.decode_dequantize_accumulate(acc, wv, sc, tl, 1024,
                                                 scheme_ids=sid),
        lambda: ops.encode(sym, tl[0], 89),
        lambda: ops.quantize_encode(x, tl[0], 353),
    ]
    warm = [call() for call in calls]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = [call() for call in calls]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(warm, again):
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(u, v)
    with pytest.raises(ValueError, match="scheme ids"):
        ops.decode(words, tl, k, scheme_ids=[0, 2] * (n // 2))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 15, 4096, 100003])
@pytest.mark.parametrize("offset", [0, 3, 13])
def test_k6_kernel_matches_plain_at_any_offset(cuda, n, offset):
    """Lengths around the 16-byte vector and byte offsets off its
    alignment: K6 equals its plain version and ``torch.bincount``."""
    rng = np.random.default_rng(n + offset)
    buf = torch.from_numpy(np.minimum(rng.geometric(0.05, n + 16), 255)
                           .astype(np.uint8)).to(cuda)
    x = buf[offset:offset + n]
    got = ops.histogram(x)
    assert torch.equal(got, ref.histogram256_ref(x))
    assert torch.equal(got, torch.bincount(x.long(), minlength=256)
                       .to(torch.int32))


@pytest.mark.cuda
def test_k6_kernel_one_symbol_stream(cuda):
    """Every symbol in one bin: the contention case of the per-warp
    shared-memory bins."""
    x = torch.full((1 << 22,), 0x3C, dtype=torch.uint8, device=cuda)
    got = ops.histogram(x.reshape(1024, -1))
    assert int(got[0x3C]) == 1 << 22 and int(got.sum()) == 1 << 22


@pytest.mark.cuda
def test_k6_counts_gradient_symbols(cuda):
    """The calibration path: block-32 e4m3 symbols of a gradient-like
    vector, counted by K6 in ``symbol_counts``."""
    from repro_torch.comm import calibrate
    x = _x(512, 1024, 9).reshape(-1).to(cuda)
    x = torch.nan_to_num(x, nan=0.0, posinf=1.0, neginf=-1.0)
    syms = calibrate.quantized_symbols(x)
    want = torch.bincount(syms.long(), minlength=256).cpu().numpy()
    np.testing.assert_array_equal(calibrate.symbol_counts(syms), want)


def _x_tables(k: int, rows: int, seed: int):
    """Inputs of the K1/K2 edge cases: ``_x`` rows (adversarial values in
    the first two) and two schemes calibrated on them."""
    x = _x(rows, k, seed)
    sym = e4m3.quantize_block32(torch.nan_to_num(x, nan=0.0))[0]
    counts = np.bincount(sym.numpy().reshape(-1),
                         minlength=256).astype(np.float64) + 1
    return x, [lut.build_tables(counts, schemes.TABLE1),
               lut.build_tables(counts[::-1].copy(), schemes.TABLE2)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 256, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_kernel_edge_cases(cuda, k, dtype):
    """Chunk sizes of one block, a quarter piece and four pieces; 37 rows
    (no multiple of any CTA's warps); slots that fit every chunk, and 1
    and 20 words (every chunk over capacity: word cap-1 sums the clamped
    codes); codes and histogram on."""
    x, tl = _x_tables(k, 37, 11)
    x = x.to(cuda, getattr(torch, dtype))
    for cap in (codec.worst_case_words(k), 20, 1):
        got = ops.quantize_encode(x, tl[0], cap, emit_codes=True,
                                  emit_hist=True)
        want = ref.quantize_encode_ref(x, tl[0], cap, emit_codes=True,
                                       emit_hist=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (k, cap)


@pytest.mark.cuda
def test_k1_histogram_of_skewed_symbols(cuda):
    """Gradient-like values (most blocks one large value among small
    ones) put most symbols in a few bins: the per-warp bins' contention
    case. The histogram equals the plain one and torch.bincount."""
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((2048, 1024)) * 1e-3).astype(np.float32)
    x[:, ::32] = 1.0
    x = torch.from_numpy(x).to(cuda)
    t1 = _tables()[0]
    got = ops.quantize_encode(x, t1, codec.worst_case_words(1024),
                              emit_codes=True, emit_hist=True)
    want = ref.quantize_encode_ref(x, t1, codec.worst_case_words(1024),
                                   emit_codes=True, emit_hist=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[4], torch.bincount(got[3].reshape(-1).long(),
                                              minlength=256).to(torch.int32))


def _k2_case(cuda, k: int, rows: int, seed: int, cap_kind: str):
    """Two schemes interleaved by chunk, words cut to the longest chunk's
    slot ("fit"), to the median chunk's ("over": cursors run past the
    slot), or left at the worst case ("worst")."""
    x, tl = _x_tables(k, rows, seed)
    x = x.to(cuda)
    wc = codec.worst_case_words(k)
    w1, n1, s = ops.quantize_encode(x, tl[0], wc)
    w2, n2, _ = ops.quantize_encode(x, tl[1], wc)
    sid = (torch.arange(rows, device=cuda) % 2).to(torch.int32)
    nb = torch.where(sid == 1, n2, n1)
    cap = {"fit": -(-int(nb.max()) // 32),
           "over": max(1, int(nb.float().median()) // 32),
           "worst": wc}[cap_kind]
    w = torch.where((sid == 1)[:, None], w2, w1)[:, :cap].contiguous()
    return w, s, tl, sid


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 256, 4096])
@pytest.mark.parametrize("cap_kind", ["fit", "over"])
@pytest.mark.parametrize("form", ["f32", "bf16", "accumulate"])
def test_k2_kernel_edge_cases(cuda, k, cap_kind, form):
    w, s, tl, sid = _k2_case(cuda, k, 37, 13, cap_kind)
    rows = w.shape[0]
    if form == "accumulate":
        acc = torch.randn((rows, k), generator=torch.Generator()
                          .manual_seed(1)).to(cuda)
        got = ops.decode_dequantize_accumulate(acc, w, s, tl, k,
                                               scheme_ids=sid)
        want = ref.decode_dequantize_ref(w, s, tl, sid, k, acc=acc)
    else:
        od = torch.float32 if form == "f32" else torch.bfloat16
        got = ops.decode_dequantize(w, s, tl, k, scheme_ids=sid,
                                    out_dtype=od)
        want = ref.decode_dequantize_ref(w, s, tl, sid, k, out_dtype=od)
    assert torch.equal(got, want)


def _wide_schemes(prefix_bits: int):
    """Schemes of a ``prefix_bits``-bit area code: every code of the
    longest length, prefix + 8 bits, and one that mixes prefix-bit codes
    with that longest length."""
    a = 1 << prefix_bits
    longest = schemes.QLCScheme(areas=((256 // a, 8),) * a,
                                prefix_bits=prefix_bits)
    mixed = schemes.QLCScheme(areas=((1, 0),) * (a - 1) + ((257 - a, 8),),
                              prefix_bits=prefix_bits)
    return longest, mixed


@pytest.mark.cuda
@pytest.mark.parametrize("prefix_bits", [4, 5, 6, 8])
@pytest.mark.parametrize("cap_kind", ["worst", "over"])
def test_k1_k2_wide_prefixes(cuda, prefix_bits, cap_kind):
    """Codes of up to prefix + 8 bits, 16 at a prefix of 8 (two codes per
    cursor top-up, the widest word ring), through K1 and K2 in f32 and
    accumulate form: bit-equal to the plain versions, also on slots the
    median chunk overruns. At a prefix of 8 one scheme's table fills most
    of the shared memory, so the stack is the longest-code scheme alone."""
    k, rows = 1024, 70
    x = _x(rows, k, 15)
    counts = np.bincount(e4m3.quantize_block32(torch.nan_to_num(x))[0]
                         .numpy().reshape(-1), minlength=256) + 1.0
    tl = [lut.build_tables(counts, sc) for sc in _wide_schemes(prefix_bits)]
    if prefix_bits == 8:
        tl = tl[:1]
    x = x.to(cuda)
    wc = codec.worst_case_words(k, prefix_bits + 8)
    enc = [ops.quantize_encode(x, t, wc) for t in tl]
    for t, got in zip(tl, enc):
        for a, b in zip(got, ref.quantize_encode_ref(x, t, wc)):
            assert torch.equal(a, b)
    sid = (torch.arange(rows, device=cuda) % len(tl)).to(torch.int32)
    nb = torch.stack([e[1] for e in enc]).gather(0, sid.long()[None])[0]
    cap = wc if cap_kind == "worst" else max(
        1, int(nb.float().median()) // 32)
    w = torch.stack([e[0] for e in enc]).gather(
        0, sid.long()[None, :, None].expand(1, rows, wc))[0, :, :cap]
    w, sc = w.contiguous(), enc[0][2]
    assert torch.equal(ops.decode_dequantize(w, sc, tl, k, scheme_ids=sid),
                       ref.decode_dequantize_ref(w, sc, tl, sid, k))
    acc = torch.randn((rows, k), generator=torch.Generator().manual_seed(2)
                      ).to(cuda)
    assert torch.equal(
        ops.decode_dequantize_accumulate(acc, w, sc, tl, k, scheme_ids=sid),
        ref.decode_dequantize_ref(w, sc, tl, sid, k, acc=acc))


@pytest.mark.cuda
def test_k2_wide_slot(cuda):
    """At k = 4096 the worst-case slot (1409 words) is wider than 1024:
    two schemes interleaved, f32."""
    w, s, tl, sid = _k2_case(cuda, 4096, 70, 14, "worst")
    assert torch.equal(ops.decode_dequantize(w, s, tl, 4096, scheme_ids=sid),
                       ref.decode_dequantize_ref(w, s, tl, sid, 4096))


@pytest.mark.cuda
def test_k2_refuses_what_it_cannot_take(cuda):
    """Codes over 16 bits (a 9-bit prefix) are refused by K2's wrapper,
    and stacked schemes whose decode tables pass the shared memory by
    its launch; the plain version takes both."""
    k = 1024
    x = _x(8, k, 16)
    counts = np.bincount(e4m3.quantize_block32(torch.nan_to_num(x))[0]
                         .numpy().reshape(-1), minlength=256) + 1.0
    t9 = lut.build_tables(counts, schemes.QLCScheme(
        areas=((1, 8),) * 256, prefix_bits=9))
    wc = codec.worst_case_words(k, 17)
    w, nb, sc = ref.quantize_encode_ref(x, t9, wc)
    assert torch.isfinite(ref.decode_dequantize_ref(w, sc, [t9], 0, k)
                          ).any()
    with pytest.raises(ValueError, match="prefix_bits 9"):
        ops.decode_dequantize(w.to(cuda), sc.to(cuda), t9, k)
    t8 = lut.build_tables(counts, _wide_schemes(8)[0])
    w, nb, sc = ref.quantize_encode_ref(x, t8, wc)
    two = [t8, t8]
    sid = np.zeros(8, np.int32)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        ops.decode_dequantize(w.to(cuda), sc.to(cuda), two, k,
                              scheme_ids=sid)
    assert torch.equal(ref.decode_dequantize_ref(w, sc, two, sid, k),
                       ref.decode_dequantize_ref(w, sc, [t8], 0, k))


@pytest.mark.cuda
def test_k1_e4m3_encoder_on_every_f32(cuda):
    """K1 rounds with the hardware's e4m3 conversion and patches the two
    places where that format differs from this one (|x| > 464 and NaN
    take 480): equal to the plain encoder on all 2^32 bit patterns."""
    from repro_torch.kernels import qlc_fused as qf
    piece = 1 << 26
    for start in range(0, 1 << 32, piece):
        bits = torch.arange(start, start + piece, dtype=torch.int64,
                            device=cuda)
        x = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
            torch.int32).view(torch.float32)
        assert torch.equal(qf.e4m3_encode(x), e4m3.e4m3_encode(x)), start
