"""Port parity, codes path: the plain versions of K3 (encode), K4 (decode)
and K5 (prefetch decode), the escape-pool wire, the container format,
the local channel and the KV calibration, against the JAX reference, bit
for bit.

The reference's K3/K4 run in interpret mode on the CPU. Its K5 cannot
run on the installed jax (``pltpu.TPUMemorySpace`` is gone), so K5's
plain version is held against the reference's K4, which the reference
documents as bit-identical. Words travel as int32 in the port and uint32
in the reference; they are compared as bit patterns. Every tolerance is
exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import calibrate as jcal
from repro.comm import compressed as jcomp
from repro.comm import container as jqc
from repro.core import CodecRegistry as JRegistry
from repro.core import TABLE1, TABLE2, build_tables
from repro.kernels import ops as jops
from repro_torch.comm import calibrate as tcal
from repro_torch.comm import compressed as tcomp
from repro_torch.comm import container as tqc
from repro_torch.comm.channel import Channel, ChannelSpec, open_channels
from repro_torch.core import CodecRegistry
from repro_torch.core import codec as tcodec
from repro_torch.core import lut as t_lut, schemes as t_schemes
from repro_torch.kernels import ops as tops
from tests.torch_dist import one_cpu_thread

one_cpu_thread()


def _syms(rows: int, k: int, seed: int) -> np.ndarray:
    """u8 chunks: skewed rows that code below 8 bits/symbol, and every
    fourth row uniform (it runs over a tight slot)."""
    rng = np.random.default_rng(seed)
    sym = np.minimum(rng.geometric(0.08, (rows, k)), 255).astype(np.uint8)
    sym[::4] = rng.integers(0, 256, (len(sym[::4]), k), dtype=np.uint8)
    return sym


def _counts(seed: int) -> np.ndarray:
    return np.bincount(_syms(64, 256, seed).reshape(-1),
                       minlength=256).astype(np.float64) + 1


@pytest.fixture(scope="module")
def tables():
    """[(reference tables, port tables)] for TABLE1 and TABLE2."""
    c1, c2 = _counts(0), _counts(1)[::-1].copy()
    return [(build_tables(c1, TABLE1), t_lut.build_tables(c1, t_schemes.TABLE1)),
            (build_tables(c2, TABLE2), t_lut.build_tables(c2, t_schemes.TABLE2))]


@pytest.fixture(scope="module")
def registries():
    """The same two tensor types registered in both packages."""
    jreg, treg = JRegistry(), CodecRegistry()
    for name, seed in (("a", 0), ("b", 1)):
        c = _counts(seed)
        if name == "b":
            c = c[::-1].copy()
        jreg.register(name, c, chunk_symbols=256)
        treg.register(name, c, chunk_symbols=256)
    return jreg, treg


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _cap(kind: str, nbits: np.ndarray, k: int) -> int:
    return {"worst": tcodec.worst_case_words(k),
            "exact": -(-int(nbits.max()) // 32),
            "over": int(np.median(nbits)) // 32,
            "one": 1}[kind]


@pytest.mark.parametrize("k", [32, 256, 1024, 4096])
@pytest.mark.parametrize("cap", ["worst", "exact", "over", "one"])
def test_k3_plain_matches_reference_kernel(tables, k, cap):
    jt, tt = tables[0]
    sym = _syms(12, k, 3)
    nbits = tcodec.encode_chunk_bits(torch.from_numpy(sym), tt.enc_len)
    words_cap = _cap(cap, nbits.numpy(), k)
    wj, nj = jops.encode(jnp.asarray(sym), jt, words_cap)
    wt, nt = tops.encode(torch.from_numpy(sym), tt, words_cap)
    assert nt.dtype == torch.int32 and tuple(nt.shape) == (12,)
    np.testing.assert_array_equal(np.asarray(wj), _u32(wt))
    np.testing.assert_array_equal(np.asarray(nj), nt.numpy())


def test_k3_geometry_fits_and_refuses(monkeypatch):
    """K3's launch geometry fits one CTA's 48 KiB for every chunk size
    32..4096 and every slot up to ``ENCODE_MAX_CAP`` words, at 16- and
    32-bit codes; the wrapper refuses anything outside that domain with
    ValueError before any CUDA call."""
    from repro_torch.kernels import qlc_codes as qc
    from repro_torch.kernels import qlc_fused as qf
    assert qc.ENCODE_MAX_CAP == 11264
    for bits in (16, 32):
        lut = 256 * (8 if bits > 16 else 4)
        for cap in range(1, qc.ENCODE_MAX_CAP + 1):
            warps, chunks, smem = qc.encode_geometry(256, cap, bits)
            assert warps in (1, 2, 4, 8) and 1 <= chunks <= 4
            assert smem == lut + warps * chunks * 4 * cap <= qf.MAX_SMEM
            if chunks == 4:     # then the most warps that fit
                assert warps == 8 or lut + 8 * warps * 4 * cap > qf.MAX_SMEM
            else:               # else one warp with the most chunks
                assert warps == 1
                assert lut + (chunks + 1) * 4 * cap > qf.MAX_SMEM
    for k in range(32, 4097, 32):
        most = 1 if k > 1024 else 32 // (k // 32)
        for cap in (1, 45, 240, 1409, qc.ENCODE_MAX_CAP):
            _, chunks, smem = qc.encode_geometry(k, cap, 32)
            assert smem <= qf.MAX_SMEM and 1 <= chunks <= most

    def no_cuda(name):
        raise AssertionError("a CUDA call was made")
    monkeypatch.setattr(qc, "_lib", no_cuda)
    code = torch.zeros(256, dtype=torch.int32)
    for k, cap, bits in ((0, 45, 11), (16, 45, 11), (48, 45, 11),
                         (-32, 45, 11), (256, 0, 11), (256, 11265, 11),
                         (256, 45, -1), (256, 45, 33)):
        with pytest.raises(ValueError):
            qc.encode_geometry(k, cap, bits)
        sym = torch.zeros((4, max(k, 0)), dtype=torch.uint8)
        with pytest.raises(ValueError):
            qc.encode(sym, code, code, cap, max_code_bits=bits)
    with pytest.raises(ValueError):     # in the domain, but not on the card
        qc.encode(torch.zeros((4, 256), dtype=torch.uint8), code, code, 45)
    with pytest.raises(ValueError):
        qc.encode(torch.zeros(256, dtype=torch.uint8), code, code, 45)


def test_encode_luts_checked_on_the_host(tables):
    """``ops._encode_luts`` gives the device LUTs and the longest code,
    and refuses lengths outside [0, 32] and codes that do not fit their
    length (the kernels OR codes into place where the reference adds
    them)."""
    _, tt = tables[0]
    code, length, longest = tops._encode_luts(tt, torch.device("cpu"))
    assert longest == int(tt.enc_len.max()) == tt.max_code_length
    np.testing.assert_array_equal(code.numpy().view(np.uint32), tt.enc_code)
    np.testing.assert_array_equal(length.numpy(), tt.enc_len)
    wide = tt.enc_len.copy()
    wide[5] = 32
    full = tt.enc_code.copy()
    full[5] = 0xFFFFFFFF
    assert tops._encode_luts(dataclasses.replace(
        tt, enc_code=full, enc_len=wide), torch.device("cpu"))[2] == 32
    for c, ln in ((tt.enc_code, np.where(np.arange(256) == 3, 33,
                                         tt.enc_len)),
                  (np.where(np.arange(256) == 7, 1 << tt.enc_len[7],
                            tt.enc_code), tt.enc_len)):
        bad = dataclasses.replace(tt, enc_code=c.astype(np.uint32),
                                  enc_len=ln.astype(np.uint32))
        with pytest.raises(ValueError):
            tops._encode_luts(bad, torch.device("cpu"))


def _mixed_words(tables, k: int, rows: int, cap: str):
    """Two schemes interleaved by chunk, through the port's plain K3."""
    (_, t1), (_, t2) = tables
    sym = torch.from_numpy(_syms(rows, k, 4))
    sid = np.arange(rows) % 2
    nb = np.maximum(tcodec.encode_chunk_bits(sym, t1.enc_len).numpy(),
                    tcodec.encode_chunk_bits(sym, t2.enc_len).numpy())
    c = _cap(cap, nb, k)
    w1, _ = tops.encode(sym, t1, c)
    w2, _ = tops.encode(sym, t2, c)
    return sym, torch.where(torch.from_numpy(sid == 1)[:, None], w2, w1), sid


@pytest.mark.parametrize("cap", ["exact", "over"])
@pytest.mark.parametrize("entry", ["decode", "decode_block_async"])
def test_k4_k5_plain_match_reference_k4(tables, cap, entry):
    """K4's and K5's plain versions against the reference's K4 (interpret
    mode) on a mixed-scheme batch; at "over" the cursors of the longest
    chunks run past their slot and still agree."""
    k, rows = 256, 10
    sym, w, sid = _mixed_words(tables, k, rows, cap)
    jl = [j for j, _ in tables]
    want = jops.decode(jnp.asarray(_u32(w)), jl, k,
                       scheme_ids=jnp.asarray(sid))
    got = getattr(tops, entry)(w, [t for _, t in tables], k, scheme_ids=sid)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    if cap == "exact":
        np.testing.assert_array_equal(got.numpy(), sym.numpy())


def test_decode_rejects_bad_scheme_ids_and_devices(tables):
    _, tt = tables[0]
    w = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="scheme ids"):
        tops.decode(w, [tt], 256, scheme_ids=[0, 1, 0])
    with pytest.raises(ValueError, match="3 chunks"):
        tops.decode_block_async(w, [tt], 256, scheme_ids=[0, 0])
    with pytest.raises(ValueError, match="no kernel route"):
        tops.encode(torch.zeros((2, 256), dtype=torch.uint8, device="meta"),
                    tt, 8)


def _cfgs(cap: int, pool_per_1k: int):
    kw = dict(chunk_symbols=256, capacity_words=cap,
              pool_slots_per_1k=pool_per_1k)
    return jcomp.CommConfig(**kw), tcomp.CommConfig(**kw)


@pytest.mark.parametrize("pool", ["fits", "overflows"])
def test_codes_wire_matches(tables, pool):
    """``_compress_codes`` / ``_decompress_codes`` with a leading dim:
    equal words, flags, pool, pool_count, ok and codes, also when the
    escape pool overflows (ok False)."""
    jt, tt = tables[0]
    codes = _syms(16, 256, 5).reshape(2, -1)          # 2 x 8 chunks
    # 40 words: the uniform rows escape; 1 or 1024 pool slots per 1k
    jcfg, tcfg = _cfgs(40, 1024 if pool == "fits" else 1)
    jp = jcomp._compress_codes(jnp.asarray(codes), jt, jcfg)
    tp = tcomp._compress_codes(torch.from_numpy(codes), tt, tcfg)
    for name in ("words", "pool"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                      _u32(getattr(tp, name)), err_msg=name)
    for name in ("flags", "pool_count"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                      getattr(tp, name).numpy(),
                                      err_msg=name)
    assert int(tp.flags.sum()) > 0
    jc, jok = jcomp._decompress_codes(jp, jt, jcfg)
    tc, tok = tcomp._decompress_codes(tp, tt, tcfg)
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert bool(tok.all()) == (pool == "fits")
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    if pool == "fits":
        np.testing.assert_array_equal(tc.numpy(), codes)


def test_raw_wire_matches(tables):
    jt, tt = tables[0]
    codes = _syms(4, 256, 6).reshape(-1)
    jcfg, tcfg = (dataclasses.replace(c, enabled=False)
                  for c in _cfgs(40, 8))
    jp = jcomp._compress_codes(jnp.asarray(codes), jt, jcfg)
    tp = tcomp._compress_codes(torch.from_numpy(codes), tt, tcfg)
    np.testing.assert_array_equal(np.asarray(jp.words), _u32(tp.words))
    tc, tok = tcomp._decompress_codes(tp, None, tcfg)
    assert bool(tok)
    np.testing.assert_array_equal(tc.numpy(), codes)


@pytest.mark.parametrize("over", [False, True], ids=["fit", "overflow"])
def test_codes_container_both_ways(registries, over):
    """A container written by either package is byte-equal to the other's
    and decodes in the other. The uniform chunks escape the plan's slot;
    with a pool of one slot per chunk they fit, with a 1-word slot and
    one pool slot both packages report the overflow."""
    jreg, treg = registries
    codes = _syms(6, 256, 7).reshape(-1)[:1500]       # ragged tail
    kw = (dict(capacity_words=1, pool_slots_per_1k=1) if over
          else dict(pool_slots_per_1k=1024))
    jbuf = jqc.encode_codes(codes, jreg["a"], **kw)
    tbuf = tqc.encode_codes(torch.from_numpy(codes), treg["a"], **kw)
    assert tbuf.dtype == np.uint32
    np.testing.assert_array_equal(jbuf, tbuf)
    jout, jok, jpos = jqc.decode_codes(tbuf, jreg)
    tout, tok, tpos = tqc.decode_codes(jbuf, treg, device="cpu")
    assert (bool(jok), tok, jpos) == (not over, not over, tpos)
    np.testing.assert_array_equal(np.asarray(jout), tout.numpy())
    if not over:
        np.testing.assert_array_equal(tout.numpy(), codes)


def test_values_container_both_ways(registries):
    """e4m3 values (block-32 quantize, bf16 scales) frame byte-equal and
    decode across packages (the paged cache's ``"e4m3"`` mode)."""
    jreg, treg = registries
    x = (np.random.default_rng(8).standard_normal(768) * 3).astype(np.float32)
    jbuf = jqc.encode_values(x, jreg["a"], pool_slots_per_1k=1024)
    cfg = treg["a"].config(pool_slots_per_1k=1024)
    codes, scales = tcomp._quantize(torch.from_numpy(x), cfg)
    tbuf = tqc.pack_payload(
        tcomp._compress_codes(codes, treg["a"].tables, cfg), scales,
        scheme_id=treg["a"].scheme_id, cfg=cfg, n_valid=768)
    np.testing.assert_array_equal(jbuf, tbuf)
    jv, jok, _ = jqc.decode_values(tbuf, jreg)
    tv, tok, _ = tqc.decode_values(jbuf, treg, device="cpu")
    assert bool(jok) and tok
    np.testing.assert_array_equal(np.asarray(jv).view(np.uint32),
                                  tv.numpy().view(np.uint32))


@pytest.mark.parametrize("prefetch", [False, True], ids=["k4", "k5"])
def test_codes_stream_both_ways(registries, prefetch):
    """A mixed-scheme stream (two coded schemes at different slot widths
    plus a raw section) written by the port decodes in the reference and
    vice versa; the port's batched decode (K4, or K5 with ``prefetch``)
    equals the reference's (its K4 in interpret mode)."""
    jreg, treg = registries
    parts = [_syms(3, 256, s).reshape(-1) for s in (9, 10, 11)]
    jsec = [jqc.encode_codes(parts[0], jreg["a"]),
            jqc.encode_codes(parts[1], jreg["b"], capacity_words=30),
            jqc.encode_codes(parts[2], jreg["a"], enabled=False)]
    tsec = [tqc.encode_codes(torch.from_numpy(parts[0]), treg["a"]),
            tqc.encode_codes(torch.from_numpy(parts[1]), treg["b"],
                             capacity_words=30),
            tqc.encode_codes(torch.from_numpy(parts[2]), treg["a"],
                             enabled=False)]
    jstream, tstream = jqc.pack_stream(jsec), tqc.pack_stream(tsec)
    np.testing.assert_array_equal(jstream, tstream)
    assert [h for _, h in tqc.stream_headers(jstream)] == \
        [tqc.ContainerHeader(**dataclasses.asdict(h))
         for _, h in jqc.stream_headers(tstream)]
    want = jqc.decode_codes_stream(tstream, jreg, use_kernels=True)
    got = tqc.decode_codes_stream(jstream, treg, prefetch=prefetch,
                                  device="cpu")
    assert len(got) == 3
    for (ws, wok), (gs, gok), p in zip(want, got, parts):
        assert bool(wok) == gok
        np.testing.assert_array_equal(np.asarray(ws), gs.numpy())
    np.testing.assert_array_equal(got[0][0].numpy(), parts[0])
    np.testing.assert_array_equal(got[2][0].numpy(), parts[2])


def test_stacked_decode_tables_match(registries):
    jreg, treg = registries
    for ids in (None, [1], [1, 0, 1]):
        jl, jmap = jreg.stacked_decode_tables(ids)
        tl, tmap = treg.stacked_decode_tables(ids)
        np.testing.assert_array_equal(jmap, tmap)
        assert [t.dec_lut.tolist() for t in jl] == \
            [t.dec_lut.tolist() for t in tl]


def test_channel_local_codes_and_mesh_refused(registries):
    _, treg = registries
    chans = open_channels(treg)
    assert sorted(chans) == ["a", "b"]
    ch = chans["a"]
    assert ch.cfg == treg["a"].config()
    codes = torch.from_numpy(_syms(4, 256, 12).reshape(-1))
    p = ch.compress_codes(codes)
    ref = tcomp._compress_codes(codes, treg["a"].tables, ch.cfg)
    assert all(torch.equal(a, b) for a, b in zip(p, ref))
    out, ok = ch.decompress_codes(p)
    assert bool(ok) and torch.equal(out, codes)
    assert Channel(ChannelSpec(codec=treg["b"])).entry.name == "b"
    local = open_channels(treg, mesh=object())
    assert all(c.group is None for c in local.values())
    with pytest.raises(ValueError, match="mesh in scope"):
        Channel(ChannelSpec(codec="a", axis="data"), registry=treg)
    with pytest.raises(NotImplementedError, match="item 13"):
        Channel(ChannelSpec(codec="a", axis="pod"), registry=treg)


def _bf16_states(seed: int, shapes):
    """The same bf16 tensors in both packages, from u16 bit patterns."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        u16 = (rng.standard_normal(s).astype(np.float32) * 0.5).view(
            np.uint32) >> 16
        u16 = u16.astype(np.uint16)
        out.append((jnp.asarray(u16).view(jnp.bfloat16),
                    torch.from_numpy(u16.view(np.int16)).view(torch.bfloat16)))
    return out


def test_byte_planes_and_symbol_stream_match():
    pairs = _bf16_states(13, [(2, 1, 4, 3, 8), (2, 1, 4, 3, 8)])
    jarr, tarr = [j for j, _ in pairs], [t for _, t in pairs]
    jp, tp = jcal.byte_planes(jarr), tcal.byte_planes(tarr)
    assert list(jp) == list(tp)
    for key in jp:
        np.testing.assert_array_equal(jp[key], tp[key].numpy())
    np.testing.assert_array_equal(jcal.kv_symbol_stream(jarr, "qlc"),
                                  tcal.kv_symbol_stream(tarr, "qlc").numpy())
    np.testing.assert_array_equal(
        jcal.kv_symbol_stream(jarr, "e4m3"),
        tcal.kv_symbol_stream(tarr, "e4m3").numpy())


@pytest.mark.parametrize("mode,merge_tol", [("qlc", 0.05), ("qlc", 0.0),
                                            ("e4m3", 0.05)])
def test_calibrate_kv_entries_match(mode, merge_tol):
    """Same states in -> same names, scheme ids, tables and plans."""
    pairs = _bf16_states(14, [(2, 1, 24, 4, 16)] * 4)
    jlayers = {"l0": [j for j, _ in pairs[:2]], "l1": [j for j, _ in pairs[2:]]}
    tlayers = {"l0": [t for _, t in pairs[:2]], "l1": [t for _, t in pairs[2:]]}
    jreg, treg = JRegistry(), CodecRegistry()
    kw = dict(mode=mode, chunk_symbols=256, merge_tol=merge_tol)
    je = jcal.calibrate_kv_entries(jreg, jlayers, **kw)
    te = tcal.calibrate_kv_entries(treg, tlayers, **kw)
    assert list(je) == list(te)
    assert jreg.names() == treg.names()
    for name in je:
        a, b = je[name], te[name]
        assert a.scheme_id == b.scheme_id, name
        np.testing.assert_array_equal(a.tables.dec_lut, b.tables.dec_lut)
        np.testing.assert_array_equal(a.tables.enc_code, b.tables.enc_code)
        assert dataclasses.asdict(a.plan) == dataclasses.asdict(b.plan), name


def test_empirical_plan_matches(tables):
    jt, tt = tables[0]
    syms = _syms(40, 256, 15).reshape(-1)
    from repro.comm.planner import plan_for_tables as jplan
    from repro_torch.comm.planner import plan_for_tables as tplan
    c = _counts(0)
    for kw in ({}, {"max_pool_slots_per_1k": 16, "drift_margin_bits": 0.25}):
        a = jcal.empirical_plan(jt, syms, jplan(jt, c, chunk_symbols=256),
                                chunk_symbols=256, **kw)
        b = tcal.empirical_plan(tt, syms, tplan(tt, c, chunk_symbols=256),
                                chunk_symbols=256, **kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
