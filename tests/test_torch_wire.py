"""Port parity, value wire and collectives: the gradient wire's local
transforms (quantize-encode, decode-dequantize, decode-accumulate, and
the raw e4m3 twin), the transport planner, and the compressed
reduce-scatter / all-gather over a 4-rank gloo group, against the JAX
reference, bit for bit.

The reference runs its pure codec (``use_kernels=False``, its training
path) and, for the collectives, ``shard_map`` over 4 fake CPU devices
(``tests/md_util.run_md``) on the same shards. Inputs hold no f32
subnormals (XLA on the CPU flushes them; torch keeps them). Every
tolerance is exact: on the wire the dequantize product of an e4m3 value
and a bf16 scale is exact in f32, so no fused multiply-add can change
an accumulated sum.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import compressed as jcomp
from repro.comm import planner as jplanner
from repro.core import TABLE1, build_tables
from repro.quant import e4m3 as je4m3
from repro_torch.comm import compressed as tcomp
from repro_torch.comm import planner as tplanner
from repro_torch.comm.channel import Channel, ChannelSpec
from repro_torch.core import lut as t_lut, schemes as t_schemes
from tests.md_util import run_md
from tests.torch_dist import run_ranks
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

K = 256


def _grad_like(shape, seed: int) -> np.ndarray:
    """Heavy-tailed gradient-like f32 values with regions of different
    scale, no subnormals."""
    rng = np.random.default_rng(seed)
    x = rng.standard_t(3, shape).astype(np.float32) * 1e-3
    flat = x.reshape(-1)
    flat[: flat.size // 5] *= 50.0
    flat[7] = 0.0
    return x


def _counts(x: np.ndarray) -> np.ndarray:
    n = x.size // 32 * 32
    codes = np.asarray(je4m3.quantize_block32(jnp.asarray(x.reshape(-1)[:n]))[0])
    return np.bincount(codes, minlength=256).astype(np.float64) + 1


def _cfgs(x: np.ndarray):
    """{name: (CommConfig kwargs)}: slots at the chunks' median bit count
    with a pool for every chunk (half the chunks escape, ok holds), and a
    tight slot with a small pool (the pool overflows, ok is False)."""
    tables = t_lut.build_tables(_counts(x), t_schemes.TABLE1)
    from repro_torch.core import codec as tcodec
    codes = tcomp._quantize(torch.from_numpy(x.reshape(-1, K)),
                            tcomp.CommConfig())[0]
    nbits = tcodec.encode_chunk_bits(codes, tables.enc_len).numpy()
    med = int(np.median(nbits)) // 32
    return {"escapes": dict(chunk_symbols=K, capacity_words=med,
                            pool_slots_per_1k=1024),
            "overflow": dict(chunk_symbols=K, capacity_words=med // 2,
                             pool_slots_per_1k=8)}


def _u32(t) -> np.ndarray:
    return np.asarray(t).view(np.uint32) if isinstance(t, np.ndarray) \
        else t.numpy().view(np.uint32)


def _same_payload(jp, tp):
    np.testing.assert_array_equal(np.asarray(jp.words), _u32(tp.words))
    np.testing.assert_array_equal(np.asarray(jp.flags), tp.flags.numpy())
    np.testing.assert_array_equal(np.asarray(jp.pool), _u32(tp.pool))
    np.testing.assert_array_equal(np.asarray(jp.pool_count),
                                  tp.pool_count.numpy())


def _bf16_bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


def _wire_inputs():
    x = _grad_like((3, 12 * K), 0)
    counts = _counts(x)
    return (x, build_tables(counts, TABLE1),
            t_lut.build_tables(counts, t_schemes.TABLE1), _cfgs(x))


@pytest.fixture(scope="module")
def wire():
    return _wire_inputs()


@pytest.mark.parametrize("case", ["escapes", "overflow"])
@pytest.mark.parametrize("lead", [True, False])
def test_value_transforms_bit_equal(wire, case, lead):
    """compress / decompress / accumulate, escapes and pool overflow
    included: payload, bf16 scales, values (rows past an overflowed pool
    included) and ok, with and without lead dims."""
    x, jt, tt, cfgs = wire
    kw = cfgs[case]
    if not lead:
        x = x[0]
    jcfg, tcfg = jcomp.CommConfig(**kw), tcomp.CommConfig(**kw)
    jp, js = jax.jit(lambda v: jcomp._compress_values(v, jt, jcfg))(
        jnp.asarray(x))
    tp, ts = tcomp._compress_values(torch.from_numpy(x), tt, tcfg)
    _same_payload(jp, tp)
    np.testing.assert_array_equal(_bf16_bits(js), _bf16_bits(ts))
    assert int(np.asarray(jp.flags).sum()) > 0
    jv, jok = jax.jit(lambda p, s: jcomp._decompress_values(p, s, jt, jcfg)
                      )(jp, js)
    tv, tok = tcomp._decompress_values(tp, ts, tt, tcfg)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert bool(np.all(np.asarray(jok))) == (case == "escapes")
    acc = _grad_like(x.shape, 5)
    ja, jok2 = jax.jit(lambda a, p, s: jcomp._accumulate_values(
        a, p, s, jt, jcfg))(jnp.asarray(acc), jp, js)
    ta, tok2 = tcomp._accumulate_values(torch.from_numpy(acc), tp, ts, tt,
                                        tcfg)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jok2), tok2.numpy())


def test_raw_twin_bit_equal(wire):
    """``enabled=False``: the codes ride raw, and the decoded values are
    the compressed wire's (lossless) as well as the reference's."""
    x, jt, tt, cfgs = wire
    kw = dict(cfgs["escapes"], enabled=False)
    jp, js = jcomp._compress_values(jnp.asarray(x), jt,
                                    jcomp.CommConfig(**kw))
    tp, ts = tcomp._compress_values(torch.from_numpy(x), tt,
                                    tcomp.CommConfig(**kw))
    _same_payload(jp, tp)
    jv, _ = jcomp._decompress_values(jp, js, jt, jcomp.CommConfig(**kw))
    tv, tok = tcomp._decompress_values(tp, ts, tt, tcomp.CommConfig(**kw))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    on = tcomp.CommConfig(**cfgs["escapes"])
    cv, cok = tcomp._decompress_values(
        *tcomp._compress_values(torch.from_numpy(x), tt, on), tt, on)
    assert bool(cok.all()) and bool(tok.all())
    np.testing.assert_array_equal(cv.numpy(), tv.numpy())


def test_compress_emits_the_histogram(wire):
    x, _, tt, cfgs = wire
    cfg = tcomp.CommConfig(**cfgs["escapes"])
    *_, hist = tcomp._compress_values(torch.from_numpy(x), tt, cfg,
                                      emit_hist=True)
    codes = tcomp._quantize(torch.from_numpy(x), cfg)[0]
    np.testing.assert_array_equal(
        hist.numpy(), np.bincount(codes.numpy().reshape(-1), minlength=256))


# --------------------------------------------------------------------------
# Planner
# --------------------------------------------------------------------------

def test_planner_matches_reference():
    """Wire bytes, modeled times and the transport choice, on the same
    model constants (the port's defaults are the H100's, the
    reference's a TPU's, so the defaults differ by design)."""
    consts = dict(alpha_s=1e-5, wire_Bps=4.5e11, decode_Bps=6.9e11,
                  dispatch_s=3e-4)
    jm = jplanner.AlphaBetaModel(**consts)
    tm = tplanner.AlphaBetaModel(**consts)
    for n, cap, pool, h in ((1 << 20, 150, 8, 1), (5000, 60, 64, 2),
                            (1 << 26, 170, 16, 4)):
        assert tplanner.payload_wire_bytes(n, 1024, cap, pool,
                                           hop_chunks=h) == \
            jplanner.payload_wire_bytes(n, 1024, cap, pool, hop_chunks=h)
    for wb, vb, d in ((1e5, 4e5, 4), (1e8, 4e8, 8), (1e9, 4.2e9, 2),
                      (3e3, 1e4, 8)):
        for r in (1, 2):
            assert tplanner.modeled_ring_time(tm, wb, vb, d, r) == \
                jplanner.modeled_ring_time(jm, wb, vb, d, r)
        assert tplanner.modeled_oneshot_time(tm, wb, vb, d, d) == \
            jplanner.modeled_oneshot_time(jm, wb, vb, d, d)
        jc = jplanner.choose_transport(wb, vb, d, model=jm,
                                       n_oneshot_decode_dispatches=d)
        tc = tplanner.choose_transport(wb, vb, d, model=tm,
                                       n_oneshot_decode_dispatches=d)
        assert (jc.kind, jc.hop_chunks) == (tc.kind, tc.hop_chunks)
    for hc, nc in ((8, 12), (4, 7), (2, 1), (3, 9)):
        assert tplanner.clamp_hop_chunks(hc, nc) == \
            jplanner.clamp_hop_chunks(hc, nc)
    assert tplanner.resolve_transport(None) == tplanner.ONESHOT
    with pytest.raises(ValueError, match="unknown transport"):
        tplanner.TransportConfig("mesh")


def test_planner_link_classes_and_a2a_match_reference():
    """The link-class model, the a2a ring model and choice, the crossover
    and the compression ratio, on a grid, against the reference on the
    same constants; the payload buckets of the autotune cache."""
    from repro.core import registry as jreg_mod
    from repro_torch.core import registry as treg_mod
    consts = dict(alpha_s=1e-5, wire_Bps=4.5e11, decode_Bps=6.9e11,
                  dispatch_s=3e-4, dcn_alpha_s=2e-5, dcn_wire_Bps=2.5e10)
    jm = jplanner.AlphaBetaModel(**consts)
    tm = tplanner.AlphaBetaModel(**consts)
    for link, kw in (("ici", dict(wire_Bps=1e11)), ("dcn", dict(
            alpha_s=1e-4, wire_Bps=1e9)), ("ici", {})):
        jl, tl = jm.with_link(link, **kw), tm.with_link(link, **kw)
        assert dataclasses.asdict(jl) == dataclasses.asdict(tl)
        for b in (0.0, 1e6):
            assert jl.wire_time(b, link) == tl.wire_time(b, link)
    with pytest.raises(ValueError, match="link class"):
        tm.link_alpha("nvlink")
    for model_pair in ((jm, tm), (jm.with_link("ici", wire_Bps=1e9),
                                  tm.with_link("ici", wire_Bps=1e9))):
        jmm, tmm = model_pair
        for wb, vb, d in ((1e5, 4e5, 4), (1e8, 4e8, 8), (3e3, 1e4, 2),
                          (1e9, 4.2e9, 1)):
            for h in (1, 2, 4):
                assert tplanner.modeled_a2a_ring_time(tmm, wb, vb, d, h) == \
                    jplanner.modeled_a2a_ring_time(jmm, wb, vb, d, h)
            jc = jplanner.choose_a2a_transport(wb, vb, d, model=jmm)
            tc = tplanner.choose_a2a_transport(wb, vb, d, model=tmm)
            assert (jc.kind, jc.hop_chunks) == (tc.kind, tc.hop_chunks)
        for d, ratio in ((2, 2.1), (4, 1.3), (8, 3.0)):
            assert tplanner.transport_crossover_bytes(
                d, tmm, compression_ratio=ratio) == \
                jplanner.transport_crossover_bytes(d, jmm,
                                                   compression_ratio=ratio)
    for cap, k in ((150, 1024), (45, 256), (240, 1024)):
        jp = jplanner.CommPlan(k, cap, 8, 5.0, 1e-6)
        tp = tplanner.CommPlan(k, cap, 8, 5.0, 1e-6)
        assert tplanner.effective_compression_ratio(tp) == \
            jplanner.effective_compression_ratio(jp)
        assert tp.pool_slots(1000) == jp.pool_slots(1000)
    assert treg_mod.TRANSPORT_CACHE_KEY == jreg_mod.TRANSPORT_CACHE_KEY
    for b in (0, 1, 2, 3, 4095, 4096, 4097, 1 << 20, (1 << 20) + 1):
        assert treg_mod.payload_bucket(b) == jreg_mod.payload_bucket(b)


def test_channel_unported_parts_raise(wire):
    _, _, tt, cfgs = wire
    cfg = tcomp.CommConfig(**cfgs["escapes"])
    with pytest.raises(NotImplementedError, match="item 13"):
        Channel(ChannelSpec(codec=tt, cfg=cfg, transport="hierarchical"))
    ch = Channel(ChannelSpec(codec=tt, cfg=cfg))
    assert ch.axis is None
    for call in (ch.psum, ch.all_to_all, ch.autotune,
                 ch.reduce_scatter):
        with pytest.raises(ValueError, match="no process group"):
            call(torch.zeros(4, K))


def test_channel_psum_all_to_all_autotune_run_on_one_rank(wire):
    """On a gloo group of one: psum and all_to_all return the wire's
    lossless round trip (the e4m3 dequantize of the input) with ok, the
    payload's wire bytes are the reference's, and autotune measures the
    decode rate (no wire to probe) and keeps one-shot; the tuned
    channel's ``replace`` keeps its measured model."""
    from repro_torch.comm.channel import measure_decode_Bps
    from repro_torch.core import CodecRegistry as TRegistry
    from repro_torch.launch.mesh import data_parallel
    x, jt, tt, cfgs = wire
    cfg = tcomp.CommConfig(**cfgs["escapes"])
    xt = torch.from_numpy(x[0])
    want, _ = tcomp._decompress_values(
        *tcomp._compress_values(xt, tt, cfg), tt, cfg)
    reg = TRegistry()
    reg.register("grads", _counts(x))
    with data_parallel("cpu") as group:
        ch = Channel(ChannelSpec(codec=tt, cfg=cfg, group=group))
        assert ch.axis == "data"
        s, ok = ch.psum(xt)
        assert bool(ok) and torch.equal(s, want)
        jp, js = jcomp._compress_values(jnp.asarray(x[0]), jt,
                                        jcomp.CommConfig(**cfgs["escapes"]))
        assert ch.wire_bytes(*ch.compress(xt)) == jcomp.wire_bytes(jp, js)
        a, ok, hist = ch.all_to_all(xt[None], with_hist=True)
        assert bool(ok) and torch.equal(a[0], want)
        codes = tcomp._quantize(xt, cfg)[0]
        assert torch.equal(hist, torch.bincount(
            codes.reshape(-1).long(), minlength=256).to(hist.dtype))
        auto = Channel(ChannelSpec(codec="grads", transport="auto",
                                   group=group), registry=reg)
        tuned = auto.autotune(1 << 16, probe_symbols=4096, repeats=1,
                              device="cpu")
        assert tuned.transport == tplanner.ONESHOT
        assert tuned.model.decode_Bps > 0
        ring = tuned.replace(transport=tplanner.RING)
        assert ring.transport == tplanner.RING
        assert ring.model is tuned.model and ring.registry is reg
        assert reg.cached_transport(reg["grads"].scheme_id, "data",
                                    1 << 16) == tplanner.ONESHOT
    rate, secs = measure_decode_Bps(tt, cfg, 4 * K, repeats=2, device="cpu")
    assert rate > 0 and rate == pytest.approx(4 * 4 * K / secs)


def test_autotune_caches_round_trip_from_the_reference(monkeypatch):
    """A reference registry tuned by the reference's ``Channel.autotune``
    (decode probe stubbed) and given measured link constants loads in the
    port with the same caches, and the port's "auto" channel resolves to
    the reference's tuning; back to the reference unchanged."""
    from repro.comm import channel as jchm
    from repro.core import CodecRegistry as JRegistry
    from repro_torch.core import CodecRegistry as TRegistry
    from repro_torch.launch.mesh import data_parallel
    x, _, _, _ = _wire_inputs()
    jreg = JRegistry()
    jreg.register("grads", _counts(x))
    monkeypatch.setattr(jchm, "measure_decode_Bps",
                        lambda *a, **k: (2e6, 0.0))
    jreg.cache_link_constants("data", "ici", wire_Bps=3.0e9, alpha_s=4e-5)
    payload = 4 * 65536
    jch = jchm.Channel(jchm.ChannelSpec(codec="grads", transport="auto",
                                        axis="data", axis_size=4),
                       registry=jreg)
    jt = jch.autotune(payload, is_reduce=True).transport
    treg = TRegistry.from_json(jreg.to_json())
    assert treg.transport_cache() == {
        k: tplanner.TransportConfig(v.kind, v.hop_chunks)
        for k, v in jreg.transport_cache().items()}
    assert treg.link_cache() == jreg.link_cache()
    with data_parallel("cpu") as group:
        tch = Channel(ChannelSpec(codec="grads", transport="auto",
                                  group=group), registry=treg)
        got = tch.resolved_transport(payload // 4 * 4, is_reduce=True,
                                     axis_size=4)
    assert (got.kind, got.hop_chunks) == (jt.kind, jt.hop_chunks)
    assert JRegistry.from_json(treg.to_json()).to_json_dict() == \
        jreg.to_json_dict()


def test_channel_spec_json_matches_reference():
    from repro.comm import channel as jchm
    from repro_torch.comm import channel as tchm
    for t in (None, "auto", "ring", tplanner.TransportConfig("ring", 4)):
        jt = t if not isinstance(t, tplanner.TransportConfig) else \
            jplanner.TransportConfig(t.kind, t.hop_chunks)
        assert tchm.transport_to_json(t) == jchm.transport_to_json(jt)
        back = tchm.transport_from_json(tchm.transport_to_json(t))
        assert back == t
    spec = ChannelSpec(transport="ring", use_kernels=True,
                       scale_dtype="bfloat16")
    assert tchm.spec_to_json(spec) == jchm.spec_to_json(
        jchm.ChannelSpec(transport="ring", use_kernels=True,
                         scale_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="item 13"):
        tchm.spec_from_json({"pod_axis": "pod", "pod_axis_size": 2})
    d = jchm.spec_to_json(jchm.ChannelSpec(
        transport=jplanner.TransportConfig("ring", 2), axis="data",
        axis_size=4, enabled=False))
    back = tchm.spec_from_json(d)
    assert back.transport == tplanner.TransportConfig("ring", 2)
    assert back.enabled is False and back.axis is None


# --------------------------------------------------------------------------
# Collectives over 4 gloo ranks against the reference on 4 devices
# --------------------------------------------------------------------------

VARIANTS = [("oneshot", 1), ("ring", 1), ("ring", 2)]

_REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm import CommConfig
from repro.comm.channel import Channel, ChannelSpec
from repro.comm.planner import TransportConfig
from repro.core import TABLE1, build_tables
from repro.parallel.sharding import shard_map_compat

d = np.load({path!r}, allow_pickle=True)
xs, counts = d["xs"], d["counts"]
cfgs = d["cfgs"].item()
tables = build_tables(counts, TABLE1)
mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
n_ag = xs.shape[1] // 4
out = {{}}
for name, kw in cfgs.items():
    for kind, h in {variants!r}:
        ch = Channel(ChannelSpec(codec=tables, cfg=CommConfig(**kw),
                                 transport=TransportConfig(kind, h),
                                 axis="d", axis_size=4))

        def f(x):
            seg, valid, ok = ch.reduce_scatter(x[0])
            full, ok2 = ch.all_gather(x[0, :n_ag])
            return seg[None], valid[None], ok[None], full[None], ok2[None]

        res = jax.jit(shard_map_compat(
            f, mesh=mesh, in_specs=P("d", None),
            out_specs=(P("d"),) * 5))(jnp.asarray(xs))
        for i, r in enumerate(res):
            out[f"{{name}}|{{kind}}|{{h}}|{{i}}"] = np.asarray(r)
np.savez({out!r}, **out)
print("REFERENCE OK")
"""


def _reference_run(script, **arrays):
    """One of the reference scripts on 4 fake XLA devices, fed
    ``arrays`` -> its outputs."""
    with tempfile.TemporaryDirectory() as tmp:
        path, out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "ref.npz")
        np.savez(path, **arrays)
        run_md(script.format(path=path, out=out, variants=VARIANTS),
               n_devices=4, timeout=600)
        return dict(np.load(out))


#: the psum / all-to-all test's autotune size
TUNE_BYTES = 4 * 65536


@pytest.fixture(scope="module")
def four_ranks():
    """The two reference runs on 4 fake devices (RS and AG; psum and
    all-to-all) and one world of 4 gloo ranks for the port's side of
    both (``tests/torch_dist.wire_four``), started together in threads.
    -> {"collectives": (xs, cfgs, reference, {name: per-rank results}),
    "psum_a2a": (cfgs, reference, per-rank results)}."""
    import concurrent.futures
    xs = _grad_like((4, 6000), 11)
    counts = _counts(xs)
    cfgs = _cfgs(xs[:, :5888])
    pxs = _grad_like((4, 6000), 21)
    pys = _grad_like((4, 4, 1400), 22)
    pcounts = _counts(pxs)
    pcfgs = _cfgs(pxs[:, :5888])
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        ref = pool.submit(_reference_run, _REFERENCE, xs=xs, counts=counts,
                          cfgs=np.array(cfgs, dtype=object))
        pref = pool.submit(_reference_run, _REFERENCE_PSUM_A2A, xs=pxs,
                           ys=pys, counts=pcounts,
                           cfgs=np.array(pcfgs, dtype=object))
        port = pool.submit(run_ranks, "wire_four", 4, collectives=dict(
            xs=xs, counts=counts, cfgs=cfgs, variants=VARIANTS),
            psum=dict(xs=pxs, ys=pys, counts=pcounts, cfgs=pcfgs,
                      variants=VARIANTS, tune_bytes=TUNE_BYTES))
        got = port.result()
        return {"collectives": (xs, cfgs, ref.result(),
                                {name: [g["collectives"][name] for g in got]
                                 for name in cfgs}),
                "psum_a2a": (pcfgs, pref.result(),
                             [g["psum"] for g in got])}


def test_collectives_ring_oneshot_and_reference_agree(four_ranks):
    """RS and AG under one-shot, ring and ring with 2 hop pieces: on 4
    gloo ranks every variant gives the same segment, valid length,
    gathered values and ok on every rank, and each equals the reference's
    collective on the same shards; with half the chunks escaping, and
    with an overflowing pool (ok False on both packages)."""
    xs, cfgs, ref, port = four_ranks["collectives"]
    for name in cfgs:
        for v in VARIANTS:
            key = f"{name}|{v[0]}|{v[1]}"
            for rank in range(4):
                seg, valid, ok, full, ok_ag = port[name][rank][v]
                assert ok == bool(ref[f"{key}|2"][rank]), (key, rank)
                assert ok_ag == bool(ref[f"{key}|4"][rank]), (key, rank)
                assert ok == ok_ag == (name == "escapes"), (key, rank)
                assert valid == int(ref[f"{key}|1"][rank])
                if not ok:
                    continue      # values past an overflowed pool differ
                np.testing.assert_array_equal(seg, ref[f"{key}|0"][rank])
                np.testing.assert_array_equal(full, ref[f"{key}|3"][rank])
                base = port[name][rank][VARIANTS[0]]
                np.testing.assert_array_equal(seg, base[0])
                np.testing.assert_array_equal(full, base[3])
    # lossless: the reduced segment is the sum of the dequantized shards
    pad = (-xs.shape[1]) % (4 * K)
    flat = np.pad(xs, ((0, 0), (0, pad)))
    deq = []
    for r in range(4):
        c, s = je4m3.quantize_block32(jnp.asarray(flat[r]))
        deq.append(np.asarray(je4m3.dequantize_block32(
            c, s.astype(jnp.bfloat16).astype(jnp.float32))))
    seg_len = flat.shape[1] // 4
    for rank in range(4):
        want = np.zeros(seg_len, np.float32)
        for s in range(4):
            want = want + deq[(rank - s) % 4][rank * seg_len:
                                               (rank + 1) * seg_len]
        np.testing.assert_array_equal(
            port["escapes"][rank][VARIANTS[0]][0], want)


_REFERENCE_PSUM_A2A = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm import CommConfig
from repro.comm.channel import Channel, ChannelSpec
from repro.comm.planner import TransportConfig
from repro.core import TABLE1, build_tables
from repro.parallel.sharding import shard_map_compat

d = np.load({path!r}, allow_pickle=True)
xs, ys, counts = d["xs"], d["ys"], d["counts"]
cfgs = d["cfgs"].item()
tables = build_tables(counts, TABLE1)
mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
out = {{}}
for name, kw in cfgs.items():
    for kind, h in {variants!r}:
        ch = Channel(ChannelSpec(codec=tables, cfg=CommConfig(**kw),
                                 transport=TransportConfig(kind, h),
                                 axis="d", axis_size=4))

        def f(x, y):
            s, ok = ch.psum(x[0])
            a, ok2 = ch.all_to_all(y[0])
            return s[None], ok[None], a[None], ok2[None]

        res = jax.jit(shard_map_compat(
            f, mesh=mesh, in_specs=(P("d", None), P("d", None, None)),
            out_specs=(P("d"),) * 4))(jnp.asarray(xs), jnp.asarray(ys))
        for i, r in enumerate(res):
            out[f"{{name}}|{{kind}}|{{h}}|{{i}}"] = np.asarray(r)
np.savez({out!r}, **out)
print("REFERENCE OK")
"""


def test_psum_all_to_all_and_autotune_on_four_ranks(four_ranks):
    """psum and all_to_all under one-shot, ring and ring with 2 hop
    pieces: on 4 gloo ranks every variant gives the same values and ok,
    and each equals the reference's on 4 devices; with an overflowing
    pool ok is False in both packages. Then autotune (decode probe
    stubbed): every rank caches the same tuning, the choice is the
    planner's on the measured constants, and the caches load in the
    reference with the same keys, its "auto" channel resolving to it."""
    from repro.core import CodecRegistry as JRegistry
    from repro.comm.channel import Channel as JChannel
    from repro.comm.channel import ChannelSpec as JChannelSpec
    from repro_torch.core import CodecRegistry as TRegistry
    cfgs, ref, port = four_ranks["psum_a2a"]
    tune = TUNE_BYTES
    for name in cfgs:
        for kind, h in VARIANTS:
            key = f"{name}|{kind}|{h}"
            for rank in range(4):
                s, ok, a, ok2 = port[rank][(name, kind, h)]
                assert ok == bool(ref[f"{key}|1"][rank]), (key, rank)
                assert ok2 == bool(ref[f"{key}|3"][rank]), (key, rank)
                assert ok == ok2 == (name == "escapes"), (key, rank)
                if not ok:
                    continue      # values past an overflowed pool differ
                np.testing.assert_array_equal(s, ref[f"{key}|0"][rank])
                np.testing.assert_array_equal(a, ref[f"{key}|2"][rank])
                base = port[rank][(name,) + VARIANTS[0]]
                np.testing.assert_array_equal(s, base[0])
                np.testing.assert_array_equal(a, base[2])
                np.testing.assert_array_equal(s, port[0][(name, kind, h)][0])

    texts = {p["tuned"][0] for p in port}
    assert len(texts) == 1
    text, tuned, resolved = port[0]["tuned"]
    assert resolved == tuned
    treg = TRegistry.from_json(text)
    link = treg.cached_link_constants("data")
    assert link["link"] == "ici"
    assert link["wire_Bps"] == tuned["params"][2] > 0
    for name, is_reduce in (("grads", True), ("params", False)):
        ch = Channel(ChannelSpec(codec=name), registry=treg)
        model = dataclasses.replace(
            tplanner.AlphaBetaModel().with_link("ici",
                                                wire_Bps=tuned[name][2]),
            decode_Bps=2e6)
        want = tplanner.choose_transport(
            ch.modeled_wire_bytes(tune // 4), float(tune), 4, model=model,
            n_oneshot_decode_dispatches=4 if is_reduce else 1)
        assert tuned[name][:2] == (want.kind, want.hop_chunks), name
    tuned = {name: t[:2] for name, t in tuned.items()}
    jreg = JRegistry.from_json(text)
    assert sorted(jreg.transport_cache()) == sorted(treg.transport_cache())
    for name, is_reduce in (("grads", True), ("params", False)):
        jch = JChannel(JChannelSpec(codec=name, transport="auto",
                                    axis="data", axis_size=4),
                       registry=jreg)
        got = jch.resolved_transport(tune // 4 * (4 if is_reduce else 1),
                                     is_reduce=is_reduce)
        assert (got.kind, got.hop_chunks) == tuned[name], name
    assert TRegistry.from_json(jreg.to_json()).to_json() == text
