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


@pytest.fixture(scope="module")
def wire():
    x = _grad_like((3, 12 * K), 0)
    counts = _counts(x)
    return (x, build_tables(counts, TABLE1),
            t_lut.build_tables(counts, t_schemes.TABLE1), _cfgs(x))


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


def test_channel_unported_parts_raise(wire):
    _, _, tt, cfgs = wire
    cfg = tcomp.CommConfig(**cfgs["escapes"])
    with pytest.raises(NotImplementedError, match="item 13"):
        Channel(ChannelSpec(codec=tt, cfg=cfg, transport="hierarchical"))
    ch = Channel(ChannelSpec(codec=tt, cfg=cfg))
    for call, item in ((ch.psum, "item 6"), (ch.all_to_all, "item 6"),
                       (ch.autotune, "item 6")):
        with pytest.raises(NotImplementedError, match=item):
            call(torch.zeros(8))
    with pytest.raises(ValueError, match="no process group"):
        ch.reduce_scatter(torch.zeros(K))


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


def test_collectives_ring_oneshot_and_reference_agree():
    """RS and AG under one-shot, ring and ring with 2 hop pieces: on 4
    gloo ranks every variant gives the same segment, valid length,
    gathered values and ok on every rank, and each equals the reference's
    collective on the same shards; with half the chunks escaping, and
    with an overflowing pool (ok False on both packages)."""
    xs = _grad_like((4, 6000), 11)
    counts = _counts(xs)
    cfgs = _cfgs(xs[:, :5888])
    with tempfile.TemporaryDirectory() as tmp:
        path, out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "ref.npz")
        np.savez(path, xs=xs, counts=counts,
                 cfgs=np.array(cfgs, dtype=object))
        run_md(_REFERENCE.format(path=path, out=out, variants=VARIANTS),
               n_devices=4, timeout=600)
        ref = dict(np.load(out))
    port = {name: run_ranks("collectives", 4, xs=xs, counts=counts,
                            cfg_kw=kw, variants=VARIANTS)
            for name, kw in cfgs.items()}
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
