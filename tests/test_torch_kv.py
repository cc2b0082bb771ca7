"""Port parity, paged compressed KV serving: ``PagedKVCache`` containers
against the JAX reference's for the same state tensors, byte for byte;
device framing and the prefetch decode against the host path; the
arena race; and the sync- and async-paged ``Engine`` against the port's
dense ``Engine``, token for token, on a reduced phi3-mini-3.8b (d_model
128, 2 layer groups, bf16 KV states as on the card).

The two packages' models round bf16 differently, so containers are held
equal for the SAME state tensors (made from a numpy seed), and the
engines are held to the port's own dense engine. Every tolerance is
exact. On the CPU the kernels' plain versions run (K3, K4, K5).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import calibrate as jcal
from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core import CodecRegistry as JRegistry
from repro.serving import KVCacheSpec as JSpec, PagedKVCache as JCache
from repro_torch.comm import calibrate as tcal
from repro_torch.comm import container as tqc
from repro_torch.comm.blockpool import (ArenaStale, BlockArena, BlockPool,
                                        PoolExhausted)
from repro_torch.configs import get_config, reduced
from repro_torch.core import CodecRegistry
from repro_torch.launch import serve
from repro_torch.models import init_params
from repro_torch.serving import (Engine, GenerationRequest, KVCacheSpec,
                                 KVCacheOverflowError, PagedKVCache,
                                 kv_cache_manifest, kv_spec_from_manifest)
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

KW = dict(d_model=128, d_ff=512)
SHAPE = (2, 1, 12, 4, 16)          # [groups, batch, tokens, kv heads, hd]


def _states(seed: int):
    """K and V of 12 tokens as bf16 bit patterns, in both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        f = (rng.standard_normal(SHAPE) * 0.7).astype(np.float32)
        u16 = (f.view(np.uint32) >> 16).astype(np.uint16)
        out.append((jnp.asarray(u16).view(jnp.bfloat16),
                    torch.from_numpy(u16.view(np.int16)).view(torch.bfloat16)))
    return [j for j, _ in out], [t for _, t in out]


def _caches(mode="qlc", exact_capacity=True, seed=0):
    """Reference and port caches calibrated on the same tensors."""
    jarr, tarr = _states(seed)
    jreg, treg = JRegistry(), CodecRegistry()
    jcal.calibrate_kv_entries(jreg, {"l0": jarr}, mode=mode,
                              chunk_symbols=256)
    tcal.calibrate_kv_entries(treg, {"l0": tarr}, mode=mode,
                              chunk_symbols=256)
    kw = dict(block_tokens=4, mode=mode, exact_capacity=exact_capacity)
    jc = JCache(JSpec(**kw), j_reduced(j_get_config("phi3-mini-3.8b"), **KW),
                jreg)
    tc = PagedKVCache(KVCacheSpec(**kw),
                      reduced(get_config("phi3-mini-3.8b"), **KW), treg,
                      device="cpu")
    return jc, tc, jarr, tarr


def _block(arrs, t0=0, t1=4):
    return [a[:, :, t0:t1] for a in arrs]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("mode,exact", [("qlc", True), ("qlc", False),
                                        ("e4m3", True)])
def test_containers_byte_equal_to_reference(mode, exact):
    """Same registries, same block -> the same container bytes; each
    package decodes the other's container to the same tensors."""
    jc, tc, jarr, tarr = _caches(mode, exact)
    assert jc.registry.names() == tc.registry.names()
    name = tc.spec.layer_codec(0)
    for t0 in (0, 4, 8):
        jb = jc.encode_block_arrays(name, "l0", _block(jarr, t0, t0 + 4),
                                    start=t0, tokens=4)
        tb = tc.encode_block_arrays(name, "l0", _block(tarr, t0, t0 + 4),
                                    start=t0, tokens=4)
        np.testing.assert_array_equal(jb.container, tb.container)
        assert (tb.coded, tb.shapes, tb.dtypes) == \
            (jb.coded, jb.shapes, jb.dtypes)
        assert tb.dense_bytes == jb.dense_bytes
        got = tc.decode_block_arrays(jb)
        want = jc.decode_block_arrays(tb)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                _bits(g), np.asarray(w).view(np.int16))
        if mode == "qlc":
            for g, a in zip(got, _block(tarr, t0, t0 + 4)):
                assert torch.equal(g, a)
    if mode == "qlc":
        hs = [h for _, h in tqc.stream_headers(tb.container)]
        assert len(hs) == 2 and any(h.coded for h in hs), hs


def test_device_frame_and_prefetch_decode_match_host_path():
    """Device framing is byte-identical to the host container; the plan
    decode (K5's plain version) and the host decode through K5 both give
    back the block."""
    _, tc, _, tarr = _caches(exact_capacity=False)
    name = tc.spec.layer_codec(0)
    blk = _block(tarr)
    host = tc.encode_block_arrays(name, "l0", blk, start=0, tokens=4)
    dev = tc.encode_block_device(name, "l0", blk, start=0, tokens=4)
    np.testing.assert_array_equal(host.container, dev.words.numpy().view(
        np.uint32))
    assert dev.coded == host.coded
    assert dev.plan.total_words == host.container.size
    decoded, oks = tc.decode_block_device(dev.plan, dev.words)
    assert oks and all(bool(ok) for ok in oks)
    for routes in (decoded, tc.decode_block_arrays(host, prefetch=True)):
        for g, a in zip(routes, blk):
            assert torch.equal(g, a)
    with pytest.raises(ValueError, match="exact_capacity"):
        _caches()[1].frame_plan(name, ((2, 4),), ("float32",))


def _scheduled(tc, tarr, slots=2):
    name = tc.spec.layer_codec(0)
    dev = tc.encode_block_device(name, "l0", _block(tarr), start=0, tokens=4)
    arena = BlockArena(slots, int(dev.words.shape[0]), device="cpu")
    tc.arena = arena
    dev.slot, dev.gen = arena.alloc()
    arena.write(dev.slot, dev.words)
    return arena, dev, tc.prefetcher.schedule(dev)


def test_eviction_under_prefetch_raises_stale():
    """An arena slot freed between schedule and consume raises
    ``ArenaStale`` instead of handing out the slot's new words."""
    _, tc, _, tarr = _caches(exact_capacity=False)
    arena, dev, handle = _scheduled(tc, tarr)
    arena.free(dev.slot)
    with pytest.raises(ArenaStale):
        tc.prefetcher.consume(handle)
    assert arena.stale_reads == 1


def test_consume_counts_hit_and_returns_block():
    _, tc, _, tarr = _caches(exact_capacity=False)
    _, _, handle = _scheduled(tc, tarr)
    out = tc.prefetcher.consume(handle)
    st = tc.stats()["prefetch"]
    assert (st["scheduled"], st["hits"], st["stalled"]) == (1, 1, 0)
    for g, a in zip(out, _block(tarr)):
        assert torch.equal(g, a)


def test_encode_overflow_falls_back_to_raw():
    """A plan capacity too small for the block's chunks overflows the
    pool at encode: the block is wired raw and counted, never corrupt."""
    _, tc, _, tarr = _caches(exact_capacity=False)
    for name in tc.registry.names():
        e = tc.registry[name]
        object.__setattr__(e, "plan", dataclasses.replace(
            e.plan, capacity_words=1, pool_slots_per_1k=1,
            expected_bits_per_symbol=0.1, escape_prob_bound=0.0))
    tc = PagedKVCache(tc.spec, tc.cfg, tc.registry, device="cpu")
    name = tc.spec.layer_codec(0)
    block = tc.encode_block_arrays(name, "l0", _block(tarr), start=0,
                                   tokens=4)
    assert tc.overflow_sections == 2 and not block.coded
    assert tc.encode_block_device(name, "l0", _block(tarr), start=0,
                                  tokens=4) is None
    for g, a in zip(tc.decode_block_arrays(block), _block(tarr)):
        assert torch.equal(g, a)


def test_decode_of_overflowed_container_raises():
    _, tc, _, tarr = _caches()
    entry = tc.registry[tc.registry.names()[0]]
    buf = tqc.encode_codes(torch.arange(1024, dtype=torch.int32).to(
        torch.uint8), entry, capacity_words=1, pool_slots_per_1k=1,
        chunk_symbols=256)
    assert tqc.parse_header(buf).coded
    good = tc.encode_block_arrays(tc.spec.layer_codec(0), "l0", _block(tarr),
                                  start=0, tokens=4)
    fake = dataclasses.replace(good, container=tqc.pack_stream([buf, buf]))
    with pytest.raises(KVCacheOverflowError):
        tc.decode_block_arrays(fake)


def test_manifest_round_trip():
    _, tc, _, _ = _caches()
    m = kv_cache_manifest(tc.spec, tc.registry)
    spec, sids = kv_spec_from_manifest(m)
    assert spec == tc.spec
    assert sids == {n: tc.registry[n].scheme_id for n in tc.registry.names()}


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("phi3-mini-3.8b"), **KW)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 10) for _ in range(5)]
    for p in prompts[3:]:
        p[:8] = prompts[2][:8]                 # a shared 8-token prefix
    return cfg, params, prompts


def _run(model, max_batch=3, new=9, **kw):
    cfg, params, prompts = model
    eng = Engine(params, cfg, max_seq_len=32, max_batch=max_batch, **kw)
    hs = [eng.submit(GenerationRequest(prompt=p, max_new_tokens=new))
          for p in prompts]
    eng.run()
    return [eng.poll(h) for h in hs], eng.stats()


@pytest.fixture(scope="module")
def dense(model):
    outs, _ = _run(model)
    return [o.tokens.tolist() for o in outs]


@pytest.mark.parametrize("paging", ["sync", "async"])
def test_paged_engine_token_identical_to_dense(model, dense, paging):
    spec = KVCacheSpec(block_tokens=4, exact_capacity=paging == "sync")
    outs, st = _run(model, kv_spec=spec, kv_paging=paging)
    assert all(o.state == "finished" for o in outs)
    assert [o.tokens.tolist() for o in outs] == dense
    pool = st["pool"]
    assert pool["unique_blocks"] > 0 and pool["dedup_hits"] >= 2
    if paging == "async":
        a, pf = st["async"], st["prefetch"]
        assert a["window_h2d"] == 2 * a["windows"]
        assert a["window_d2h"] == a["windows"] > 0
        assert pf["scheduled"] == pf["hits"] > 0
        assert st["arena"]["writes"] == pf["scheduled"]


def test_sync_and_async_engines_share_one_pool(model, dense):
    """The async engine's device-framed blocks are the sync engine's
    host containers, byte for byte: run after it on the same pool and
    registry, every block it pools is a dedup hit."""
    spec = KVCacheSpec(block_tokens=4, exact_capacity=False)
    reg, pool = CodecRegistry(), BlockPool(1 << 30)
    _run(model, kv_spec=spec, registry=reg, pool=pool)
    before = pool.stats()
    outs, st = _run(model, kv_spec=spec, registry=reg, pool=pool,
                    kv_paging="async")
    assert [o.tokens.tolist() for o in outs] == dense
    after = st["pool"]
    assert after["unique_blocks"] == before["unique_blocks"]
    assert after["dedup_hits"] - before["dedup_hits"] == \
        st["prefetch"]["scheduled"]


def test_engine_rejects_when_pool_exhausted(model):
    outs, st = _run(model, kv_spec=KVCacheSpec(block_tokens=4),
                    pool=BlockPool(64, spill_host=False))
    assert {o.state for o in outs} == {"rejected"}
    assert all("PoolExhausted" in o.error for o in outs)
    assert st["requests"]["rejected"] == 5
    with pytest.raises(PoolExhausted):
        BlockPool(64, spill_host=False).check_admission(65)


def test_segmented_prefill_and_window_step(model):
    """``prefill(start_pos=)`` in two segments gives the states and
    logits of one whole-prompt prefill; ``window_step`` gives the tokens
    of the same greedy steps run one by one."""
    from repro_torch.models import decode_step, init_decode_states
    from repro_torch.serving import prefill, window_step
    cfg, params, prompts = model
    p = torch.from_numpy(np.stack(prompts[:2]))
    lw, sw = prefill(params, cfg, p, init_decode_states(cfg, 2, 32, "cpu"))
    _, s1 = prefill(params, cfg, p[:, :6],
                    init_decode_states(cfg, 2, 32, "cpu"))
    ls, ss = prefill(params, cfg, p[:, 6:], s1, start_pos=6)
    assert torch.equal(lw, ls)
    for a, b in zip(sw["l0"], ss["l0"]):
        assert torch.equal(a, b)
    tok = torch.argmax(lw, dim=-1).to(torch.int32)[:, None]
    pos = torch.full((2, 1), 10, dtype=torch.int32)
    gen, _ = window_step(params, cfg, tok, pos, ss, 4)
    steps, st = [], sw
    for t in range(4):
        lg, st = decode_step(params, cfg, tok, st, pos + t)
        tok = torch.argmax(lg[:, 0], dim=-1).to(torch.int32)[:, None]
        steps.append(tok)
    assert torch.equal(gen, torch.cat(steps, dim=1))


def test_async_needs_qlc_with_plan_geometry(model):
    cfg, params, _ = model
    for spec in (None, KVCacheSpec(mode="e4m3", exact_capacity=False),
                 KVCacheSpec(mode="qlc", exact_capacity=True)):
        with pytest.raises(ValueError, match="async"):
            Engine(params, cfg, max_seq_len=32, kv_spec=spec,
                   kv_paging="async")


@pytest.mark.parametrize("argv", [
    ["--kv-cache", "qlc", "--kv-paging", "sync"],
    ["--kv-cache", "qlc", "--kv-paging", "async"],
    ["--kv-cache", "e4m3", "--wire", "qlc"],
], ids=["qlc-sync", "qlc-async", "e4m3"])
def test_launcher_on_cpu(argv, capsys):
    res = serve.main(["--arch", "phi3-mini-3.8b", "--reduced", "--device",
                      "cpu", "--batch", "2", "--requests", "3",
                      "--prompt-len", "6", "--new-tokens", "6",
                      "--kv-block", "4", *argv])
    assert all(o.state == "finished" for o in res["outs"])
    out = capsys.readouterr().out
    assert "kv-cache=" in out
    if "qlc" == argv[1]:
        assert res["solo_tokens"].tolist() == res["outs"][0].tokens.tolist()
    assert ("async paging:" in out) == ("async" in argv)


def test_launcher_refuses_async_without_qlc():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "phi3-mini-3.8b", "--reduced", "--device",
                    "cpu", "--kv-paging", "async"])
