"""Port parity, paged SSM-state serving: recurrent layers' snapshot
containers against the JAX reference's ``PagedKVCache`` byte for byte,
for the same state tensors and for the states the port's ``Engine``
pools (re-based and live); the engine's tokens against the reference's
dense engine; and the port's own contracts: sync and async paging are
token-identical to the dense engine, re-based snapshots of a shared
prompt prefix dedup in the pool, the launcher serves xlstm on the CPU,
and a dropped async engine frees its tensors without the cycle
collector.

Reduced xlstm-125m (d_model 64, one sLSTM and one mLSTM layer) and, for
the hybrid stack, reduced jamba-1.5-large-398b (attention, mamba and MoE
layers). Every tolerance is exact. The containers of the engine are held
against the reference's codec over the port's own states (the two
packages' models round differently), and the reference's engine is
compared in f32, where greedy tokens agree.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import calibrate as jcal
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import CodecRegistry as JRegistry
from repro.models import init_params as jinit_params
from repro.serving import Engine as JEngine
from repro.serving import GenerationRequest as JRequest
from repro.serving import KVCacheSpec as JSpec, PagedKVCache as JCache
from repro_torch.comm import calibrate as tcal
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import CodecRegistry
from repro_torch.launch import serve
from repro_torch.models import init_decode_states, init_params, ssm
from repro_torch.serving import (BlockPool, Engine, GenerationRequest,
                                 KVCacheSpec, PagedKVCache, prefill)
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

XL = "xlstm-125m"


def _seeded_states(seed: int):
    """An sLSTM and an mLSTM decode state of the reduced config, f32 from
    a numpy seed, in both packages: {"l0": arrays, "l1": arrays}."""
    rng = np.random.default_rng(seed)
    shapes = {"l0": [(1, 1, 4, 16), (1, 1, 4), (1, 1, 4)],
              "l1": [(1, 1, 4, 16, 16), (1, 1, 4, 16), (1, 1, 4)]}
    arrs = {k: [(rng.standard_normal(s) * 0.5).astype(np.float32)
                for s in v] for k, v in shapes.items()}
    return ({k: [jnp.asarray(a) for a in v] for k, v in arrs.items()},
            {k: [torch.from_numpy(a) for a in v] for k, v in arrs.items()})


@pytest.mark.parametrize("exact", [True, False])
def test_snapshot_containers_byte_equal_to_reference(exact):
    """Same registries, same recurrent states -> the same containers;
    each package decodes the other's; with the plan geometry the
    device-framed words are the host container and decode back through
    K5's plain version."""
    jarr, tarr = _seeded_states(0)
    jreg, treg = JRegistry(), CodecRegistry()
    jcal.calibrate_kv_entries(jreg, jarr, mode="qlc", chunk_symbols=256)
    tcal.calibrate_kv_entries(treg, tarr, mode="qlc", chunk_symbols=256)
    assert jreg.names() == treg.names()
    kw = dict(block_tokens=4, exact_capacity=exact)
    jc = JCache(JSpec(**kw), jreduced(jget_config(XL)), jreg)
    tc = PagedKVCache(KVCacheSpec(**kw), reduced(get_config(XL)), treg,
                      device="cpu")
    jnext, tnext = _seeded_states(1)
    for key in ("l0", "l1"):
        name = tc.spec.layer_codec(int(key[1:]))
        jb = jc.encode_block_arrays(name, key, jnext[key], start=8,
                                    tokens=4)
        tb = tc.encode_block_arrays(name, key, tnext[key], start=8,
                                    tokens=4)
        np.testing.assert_array_equal(jb.container, tb.container)
        assert (tb.coded, tb.shapes, tb.dtypes) == \
            (jb.coded, jb.shapes, jb.dtypes)
        got, want = tc.decode_block_arrays(jb), jc.decode_block_arrays(tb)
        for g, w, a in zip(got, want, tnext[key]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert torch.equal(g, a)
        if not exact:
            dev = tc.encode_block_device(name, key, tnext[key], start=8,
                                         tokens=4)
            np.testing.assert_array_equal(dev.words.numpy().view(np.uint32),
                                          tb.container)
            for g, a in zip(tc.decode_block_device(dev.plan, dev.words)[0],
                            tnext[key]):
                assert torch.equal(g, a)


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config(XL))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (11, 10, 9, 6)]
    prompts[1][:8] = prompts[0][:8]         # a shared two-block prefix
    return cfg, params, prompts


def _run(model, prompts=None, max_batch=2, new=6, **kw):
    cfg, params, all_prompts = model
    eng = Engine(params, cfg, max_seq_len=32, max_batch=max_batch, **kw)
    hs = [eng.submit(GenerationRequest(prompt=p, max_new_tokens=new))
          for p in (all_prompts if prompts is None else prompts)]
    eng.run()
    return [eng.poll(h) for h in hs], eng


@pytest.fixture(scope="module")
def dense(model):
    outs, _ = _run(model)
    return [o.tokens.tolist() for o in outs]


@pytest.mark.parametrize("paging,rebase", [("sync", True), ("sync", False),
                                           ("async", True),
                                           ("async", False)])
def test_paged_engine_token_identical_to_dense(model, dense, paging, rebase):
    """Every request's tokens equal the dense engine's. Re-based
    snapshots of the shared 8-token prefix (boundaries 4 and 8, both
    layers) dedup; the cumulative live snapshots of the two requests
    never coincide."""
    spec = KVCacheSpec(block_tokens=4, exact_capacity=paging == "sync",
                       ssm_rebase=rebase)
    outs, eng = _run(model, kv_spec=spec, kv_paging=paging)
    assert [o.tokens.tolist() for o in outs] == dense
    st = eng.stats()
    pool = st["pool"]
    assert pool["unique_blocks"] > 0 and pool["logical_bytes"] == 0
    assert pool["dedup_hits"] == (4 if rebase else 0)
    if paging == "async":
        pf = st["prefetch"]
        assert pf["scheduled"] == pf["hits"] > 0 and pf["misses"] == 0


def test_identical_prompts_dedup_every_snapshot(model):
    """Two identical prompts (the reference's ``tests/test_scheduler.py``
    case for xlstm): every snapshot of the second is a dedup hit, and
    both equal the request run alone."""
    cfg, params, prompts = model
    twins = [prompts[0], prompts[0].copy()]
    solo, _ = _run(model, prompts=twins[:1])
    outs, eng = _run(model, prompts=twins,
                     kv_spec=KVCacheSpec(block_tokens=4))
    assert [o.tokens.tolist() for o in outs] == [solo[0].tokens.tolist()] * 2
    st = eng.stats()["pool"]
    assert st["dedup_hits"] >= len(cfg.layer_kinds())
    assert st["peak_logical_bytes"] > st["peak_referenced_bytes"]


@pytest.mark.parametrize("rebase", [True, False])
def test_engine_pools_the_reference_codecs_containers(model, rebase):
    """One request (11-token prompt, 6 new tokens, blocks of 4) through
    the sync engine; every recurrent container it pools is the
    reference ``PagedKVCache``'s container of the port's own state
    (re-based: the state at each boundary 4, 8, 12, 16; live: the state
    when each block is evicted, 11 for the prompt's two blocks, then 12
    and 16), with the registry the engine calibrated."""
    cfg, params, prompts = model
    spec = KVCacheSpec(block_tokens=4, ssm_rebase=rebase)
    pool = BlockPool(1 << 30)
    outs, eng = _run(model, prompts=prompts[:1], max_batch=1, kv_spec=spec,
                     pool=pool)
    seq = np.concatenate([prompts[0], outs[0].tokens[:-1]])
    jreg = JRegistry.from_json(eng.registry.to_json())
    jc = JCache(JSpec(block_tokens=4, ssm_rebase=rebase),
                jreduced(jget_config(XL)), jreg)
    want = set()
    for t in ((4, 8, 12, 16) if rebase else (11, 12, 16)):
        _, st = prefill(params, cfg, torch.from_numpy(seq[None, :t]),
                        init_decode_states(cfg, 1, 32, "cpu"))
        for i in range(len(cfg.layer_kinds())):
            arrays = [jnp.asarray(a[0].numpy())
                      for a in ssm.state_snapshot(st[f"l{i}"])]
            want.add(jc.encode_block_arrays(
                spec.layer_codec(i), f"l{i}", arrays, start=t,
                tokens=4).container.tobytes())
    got = {e.block.container.tobytes() for e in pool._entries.values()}
    assert got == want


def test_engine_tokens_equal_reference_dense_engine():
    """f32 compute, the same weights: the port's engine (paged, sync)
    gives the reference's dense engine's tokens for every request."""
    jc = jreduced(jget_config(XL), dtype="float32")
    cfg = reduced(get_config(XL), dtype="float32")
    jp = jax.jit(lambda k: jinit_params(jc, k))(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompts = [np.random.default_rng(2).integers(0, 256, n)
               for n in (7, 5, 9)]
    jeng = JEngine(jp, jc, max_seq_len=24, max_batch=2)
    jh = [jeng.submit(JRequest(prompt=p, max_new_tokens=5)) for p in prompts]
    jeng.run()
    outs, _ = _run((cfg, tp, prompts), new=5,
                   kv_spec=KVCacheSpec(block_tokens=4))
    assert [o.tokens.tolist() for o in outs] == \
        [list(jeng.poll(h).tokens) for h in jh]


def test_hybrid_engine_paged_token_identical_to_dense():
    """Reduced jamba (attention, mamba and MoE layers): the async paged
    engine gives the dense engine's tokens for the same requests at the
    same batch (MoE capacity is shared by the batch's rows)."""
    cfg = reduced(get_config("jamba-1.5-large-398b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = [np.random.default_rng(3).integers(0, 256, n) for n in (9, 6)]
    model = (cfg, params, prompts)
    dense, _ = _run(model, new=4)
    outs, eng = _run(model, new=4, kv_paging="async",
                     kv_spec=KVCacheSpec(block_tokens=4,
                                         exact_capacity=False))
    assert [o.tokens.tolist() for o in outs] == \
        [o.tokens.tolist() for o in dense]
    assert eng.stats()["prefetch"]["scheduled"] > 0


@pytest.mark.parametrize("paging", ["sync", "async"])
def test_launcher_serves_xlstm_on_the_cpu(paging, capsys):
    res = serve.main(["--arch", XL, "--reduced", "--device", "cpu",
                      "--wire", "qlc", "--kv-cache", "qlc", "--kv-block", "4",
                      "--kv-paging", paging, "--batch", "2", "--requests",
                      "3", "--prompt-len", "6", "--new-tokens", "6"])
    assert all(o.state == "finished" for o in res["outs"])
    assert res["solo_tokens"].tolist() == res["outs"][0].tokens.tolist()
    out = capsys.readouterr().out
    assert "kv-cache=qlc" in out
    assert ("async paging:" in out) == (paging == "async")


def test_dropped_async_engine_frees_its_tensors_without_collect(model):
    """With the cycle collector off, dropping an async paged engine frees
    its device arena and decode states at once: the paged cache, its
    prefetcher and the arena hold no reference cycle."""
    gc.collect()
    gc.disable()
    try:
        _, eng = _run(model, kv_paging="async",
                      kv_spec=KVCacheSpec(block_tokens=4,
                                          exact_capacity=False))
        refs = [weakref.ref(eng._codec.arena._buf),
                weakref.ref(eng._states["l1"].c)]
        assert all(r() is not None for r in refs)
        del eng
        assert [r() is None for r in refs] == [True, True]
    finally:
        gc.enable()
