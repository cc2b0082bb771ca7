"""Port parity, serving over the data column: ``Engine(mesh=)`` with the
slots split over a ``2 x 2`` mesh (the default rules, ``batch ->
data``), and the sequence-split decode of
``make_rules(decode_seq_shard=True)`` (``kv_seq -> data``), against the
port's own row and one-rank engines and the JAX reference's unsharded
decode.

Reduced configs at f32 on gloo CPU ranks (``tests/torch_dist``): one
world of 4 (2 x 2, and 4 x 1 for the sequence split) and one of 2
(2 x 1), each started once for all its cases, beside this process,
which runs the reference and the one-rank engines. Stated tolerances
and why:

* slots over the data column: a replica's rows are its own batch, so
  each replica equals the ``1 x 2`` engine of its row fed the requests
  the 2 x 2 schedule put on it: tokens and every step's logits bit for
  bit, dense, sync and async; events, tokens, KV registries and
  ``stats()``'s counts equal on all four ranks; a bounded pool's
  rejections agreed; an MoE, whose capacity a replica's rows share, held
  against its dense engine on the same mesh (the launcher's check);
* the sequence-split decode: its partial-statistics softmax sums the
  same terms as one softmax in another order, so its logits meet the
  reference's unsharded ``decode_step`` to rtol 1e-5 / atol 1e-5; the
  partials are all-gathered and combined in rank order, so every rank
  gets the same bits, and so does one process combining the same
  shards' partials (``combine_partials``);
* a sequence-split engine at 2 x 1: tokens equal to the one-rank
  engine's, and its sync paging to its dense cache (lossless).
"""
import concurrent.futures

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.serving import Engine, GenerationRequest
from tests.test_torch_tp_serve import _reference_decode, _whole
from tests.torch_dist import _serve_cfg, run_ranks
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = dict(dtype="float32")
PROMPT, STEPS, NEW_TOKENS, KV_BLOCK = 8, 4, 8, 4
MOE64 = dict(num_experts=64, top_k=6, d_expert=16, num_shared_experts=2)
#: slots over the data column: name -> (arch, reduced-config overrides,
#: extra keywords of the case)
SPLIT = {
    "phi3": ("phi3-mini-3.8b", F32, dict(pool_bytes=6000)),
    "xlstm": ("xlstm-125m", F32, {}),
    # experts widened past the weight wire's minimum, as the MoE serving
    # tests do; through the launcher on the mesh
    "moe": ("deepseek-moe-16b", dict(F32, moe=MOE64), dict(serve=True)),
}
#: the sequence-split decode: full attention (4 heads, 4 KV heads), GQA
#: (4 heads over 2 KV heads, rotary on half the head dims) and a
#: sliding window of 4, so that a shard past the length or outside the
#: window weighs nothing
SEQ = {"full": ("phi3-mini-3.8b", F32),
       "gqa": ("chatglm3-6b", F32),
       "window": ("chatglm3-6b", dict(F32, sliding_window=4))}
#: layout id -> (world, model)
LAYOUTS = {"2x1": (2, 1), "4x1": (4, 1), "2x2": (4, 2)}
ENGINE_ARCH = "chatglm3-6b"


def _prompts(cfg, n=6):
    return np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (n, PROMPT)).astype(np.int64)


def _layer_inputs(cfg, batch=3, seq=16, seed=3):
    """One attention layer's decode inputs at f32: q, the whole k / v
    caches and positions, one row's query at the last position, one's
    near the front (later shards hold nothing valid), one's in the
    middle."""
    rng = np.random.default_rng(seed)
    hd = cfg.resolved_head_dim
    q = rng.standard_normal((batch, 1, cfg.num_heads, hd), np.float32)
    k, v = (rng.standard_normal((batch, seq, cfg.num_kv_heads, hd),
                                np.float32) for _ in range(2))
    pos = np.array([[seq - 1], [2], [seq // 2 + 1]], np.int32)[:batch]
    return q, k, v, pos


def _one_rank_engine(cfg, tree, prompts):
    params = params_from_numpy(tree, "cpu")
    eng = Engine(params, cfg, max_seq_len=PROMPT + NEW_TOKENS + 3,
                 max_batch=4)
    ids = [f"r{i}" for i in range(len(prompts))]
    for rid, p in zip(ids, prompts):
        eng.submit(GenerationRequest(prompt=p, max_new_tokens=NEW_TOKENS,
                                     request_id=rid))
    eng.run()
    return {rid: eng.poll(rid).tokens for rid in ids}


@pytest.fixture(scope="module")
def worlds():
    """The world of 4 (slots over 2 x 2; the sequence split at 4 x 1 and
    2 x 2) and the world of 2 (the sequence split and its engine at
    2 x 1) started together, each in a thread; meanwhile this process
    runs the reference's decodes and the one-rank engine. -> (seq:
    {case: (cfg, tokens, the reference's logits, layer inputs)},
    the one-rank engine's tokens, {world: per-rank results})."""
    split = []
    for name, (arch, kw, extra) in SPLIT.items():
        cfg, tree = _whole(arch, kw)
        split.append(dict(name=name, arch=arch, cfg_kw=kw, params=tree,
                          prompts=_prompts(cfg), **extra))
    seq, want = [], {}
    for name, (arch, kw) in SEQ.items():
        cfg, tree = _whole(arch, kw)
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, PROMPT + STEPS)).astype(np.int64)
        layer = _layer_inputs(cfg)
        seq.append(dict(name=name, arch=arch, cfg_kw=kw, params=tree,
                        tokens=tokens, prompt=PROMPT, layer=layer))
        want[name] = (cfg, tree, tokens, layer)
    ecfg, etree = _whole(ENGINE_ARCH, F32)
    engine = dict(arch=ENGINE_ARCH, cfg_kw=F32, params=etree,
                  prompts=_prompts(ecfg), new_tokens=NEW_TOKENS,
                  kv_block=KV_BLOCK)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        four = pool.submit(run_ranks, "dp_serve", 4, split=split, seq=seq,
                           models=[1, 2], new_tokens=NEW_TOKENS,
                           kv_block=KV_BLOCK)
        two = pool.submit(run_ranks, "dp_serve", 2, seq=seq, models=[1],
                          engine=engine)
        refs = {name: (cfg, tokens, _reference_decode(cfg, tree, tokens),
                       layer)
                for name, (cfg, tree, tokens, layer) in want.items()}
        solo = _one_rank_engine(ecfg, etree, engine["prompts"])
        got = {4: four.result(), 2: two.result()}
    return refs, solo, got


# --------------------------------------------------------------------------
# (i) Slots split over the data column
# --------------------------------------------------------------------------

def _equal_tokens(a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)


@pytest.mark.parametrize("paging", ["dense", "sync", "async"])
@pytest.mark.parametrize("case", ["phi3", "xlstm"])
def test_split_replicas_equal_their_rows(worlds, case, paging):
    """Each replica of the 2 x 2 engine equals its row's ``1 x 2`` engine
    fed that replica's requests, tokens and every step's logits bit for
    bit; events, tokens, KV registries and counts are the same on all
    four ranks; paged tokens equal dense ones."""
    ranks = [g["split"][case] for g in worlds[2][4]]
    whole0 = ranks[0][paging][0]
    served = set()
    for r, runs in enumerate(ranks):
        whole, row, mine = runs[paging]
        assert _equal_tokens(whole[0], whole0[0]), f"rank {r}"
        assert whole[1] == whole0[1], f"rank {r} events"
        assert whole[2] == whole0[2], f"rank {r} registry"
        assert whole[3] == whole0[3], f"rank {r} counts"
        assert mine, f"rank {r}'s replica served nothing"
        for rid in mine:
            np.testing.assert_array_equal(whole[0][rid], row[0][rid])
        assert len(whole[4]) == len(row[4]), f"rank {r}"
        for a, b in zip(whole[4], row[4]):
            np.testing.assert_array_equal(a, b)
        served.update(mine)
        if paging != "dense":
            # the replica that served the first request calibrated
            assert "r0" not in mine or whole[2] == row[2]
    assert served == set(whole0[0])
    assert _equal_tokens(whole0[0], ranks[0]["dense"][0][0])
    assert all(len(t) == NEW_TOKENS for t in whole0[0].values())


def test_bounded_pool_rejections_agreed(worlds):
    """A bounded pool without host spill that the requests overrun: each
    rank's pool holds its own replica's blocks, and every rank's events,
    rejections included, and tokens are the same."""
    runs = [g["split"]["phi3"]["bounded"][0] for g in worlds[2][4]]
    assert any(ev[1].startswith("reject") for ev in runs[0][1]), runs[0][1]
    for r in runs[1:]:
        assert r[1] == runs[0][1]
        assert _equal_tokens(r[0], runs[0][0])


@pytest.mark.parametrize("paging", ["sync", "async"])
def test_split_moe_through_the_launcher(worlds, paging):
    """An MoE served on the 2 x 2 mesh by ``launch.serve.serve`` from the
    QLC weight wire: the launcher holds the paged run against a dense
    run of the same requests on the mesh (a replica's rows share expert
    capacity), and every rank returns the same tokens, events and KV
    registry."""
    ranks = [g["split"]["moe"][paging] for g in worlds[2][4]]
    for toks, events, dense, reg in ranks:
        assert len(toks) == 6 and all(len(t) == NEW_TOKENS for t in toks)
        assert all(np.array_equal(a, b) for a, b in zip(toks, dense))
        assert all(np.array_equal(a, b) for a, b in zip(toks, ranks[0][0]))
        assert events == ranks[0][1] and reg == ranks[0][3]


# --------------------------------------------------------------------------
# (ii) The sequence-split decode
# --------------------------------------------------------------------------

def _emulate(cfg, layer, data, model, m):
    """One process: model rank ``m``'s heads of the layer's decode over
    ``data`` shards of the cache, each shard's partial and their
    combine, as the ranks compute them."""
    q, k, v, pos = (torch.from_numpy(a) for a in layer)
    heads, kvh = q.shape[2] // model, k.shape[2] // model
    s_loc = k.shape[1] // data
    qm = q[:, :, m * heads:(m + 1) * heads].contiguous()
    need = [j // (heads // kvh) for j in range(heads)]
    parts = []
    for d in range(data):
        cache = attn.KVCache(
            k=k[:, d * s_loc:(d + 1) * s_loc, m * kvh:(m + 1) * kvh]
            .contiguous(),
            v=v[:, d * s_loc:(d + 1) * s_loc, m * kvh:(m + 1) * kvh]
            .contiguous(), length=pos[:, 0])
        parts.append(attn.decode_partial(qm, cache, pos, cfg, need,
                                         d * s_loc))
    return attn.combine_partials(parts).reshape(qm.shape).numpy()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case", sorted(SEQ))
def test_seq_split_decode(worlds, case, layout):
    """``decode_step`` under ``make_rules(decode_seq_shard=True)``: the
    logits meet the reference's unsharded decode at the stated
    tolerance and are the same on every rank; one attention layer's
    decode is bit-equal on every rank of a data column and to one
    process combining the same shards, and close to the unsharded
    decode."""
    refs, _, got = worlds
    cfg, tokens, ref, layer = refs[case]
    world, model = LAYOUTS[layout]
    ranks = [g["seq"][(model, case)] for g in got[world]]
    for r, (logits, _) in enumerate(ranks):
        np.testing.assert_array_equal(logits, ranks[0][0],
                                      err_msg=f"rank {r}")
    np.testing.assert_allclose(ranks[0][0], ref, **TOL)
    data = world // model
    q, k, v, pos = (torch.from_numpy(a) for a in layer)
    whole = attn._grouped_decode(
        q, attn.KVCache(k=k, v=v, length=pos[:, 0]), pos, cfg,
        [j // (cfg.num_heads // cfg.num_kv_heads)
         for j in range(cfg.num_heads)]).numpy()
    heads = cfg.num_heads // model
    for r, (_, out) in enumerate(ranks):
        m = r % model
        np.testing.assert_array_equal(out, _emulate(cfg, layer, data, model,
                                                    m), err_msg=f"rank {r}")
        np.testing.assert_allclose(out, whole[:, :, m * heads:
                                              (m + 1) * heads], **TOL)


def test_combine_weighs_an_empty_shard_zero():
    """A shard with no valid position (every score ``NEG_INF``, so its
    max is finite) adds nothing: the combine over it and a shard with
    the real positions equals that shard alone."""
    cfg = _serve_cfg("chatglm3-6b", F32)
    q, k, v, pos = (torch.from_numpy(a) for a in _layer_inputs(cfg))
    pos = torch.full_like(pos, 3)
    need = [j // 2 for j in range(cfg.num_heads)]
    parts = [attn.decode_partial(q, attn.KVCache(
        k=k[:, s:s + 8], v=v[:, s:s + 8], length=pos[:, 0]), pos, cfg, need,
        s) for s in (0, 8)]
    assert torch.all(parts[1].l == 0) and torch.all(parts[1].m == attn.NEG_INF)
    alone = attn.combine_partials(parts[:1])
    assert torch.equal(attn.combine_partials(parts), alone)


# --------------------------------------------------------------------------
# (iii) A sequence-split engine
# --------------------------------------------------------------------------

def test_seq_split_engine_equals_one_rank(worlds):
    """An engine under ``make_rules(decode_seq_shard=True)`` at 2 x 1:
    ``max_seq_len`` rounded up to whole blocks on each rank; dense
    tokens equal to the one-rank engine's, sync paging equal to dense,
    events and counts the same on both ranks."""
    _, solo, got = worlds
    ranks = [g["engine"] for g in got[2]]
    assert ranks[0]["positions"] == (24, 12)
    for r in ranks:
        for kind in ("dense", "sync"):
            assert _equal_tokens(r[kind][0], solo), kind
            assert r[kind][1] == ranks[0][kind][1]
            assert r[kind][3] == ranks[0][kind][3]
        assert r["sync"][2] == ranks[0]["sync"][2]


# --------------------------------------------------------------------------
# What the data column refuses, and the chunked prefill
# --------------------------------------------------------------------------

def test_engine_refuses_what_the_data_column_cannot_hold():
    """Slots that do not divide over the data column raise a
    ``ValueError`` naming both numbers; async paging over a
    sequence-split cache is served: the engine holds its rank's range of
    the rounded positions."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import make_rules, use_rules
    from repro_torch.serving import KVCacheSpec
    cfg = _serve_cfg(ENGINE_ARCH, F32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    layout = Mesh(data=2, model=1, rank=0, world_group=None,
                  data_group=None, model_group=None)
    with pytest.raises(ValueError, match="max_batch 3 .* data axis of 2"):
        Engine(params, cfg, max_seq_len=16, max_batch=3, mesh=layout)
    with use_rules(make_rules(decode_seq_shard=True)):
        eng = Engine(params, cfg, max_seq_len=18, mesh=layout,
                     kv_paging="async",
                     kv_spec=KVCacheSpec(block_tokens=4,
                                         exact_capacity=False))
    assert eng.max_seq_len == 24 and eng._shard.size == 2
    assert eng._states["l0"].k.shape[2] == 12 and eng._offset() == 0


@pytest.mark.parametrize("chunk", [3, 8])
def test_chunked_prefill_matches_token_by_token(chunk):
    """``prefill(chunk=N)`` of an attention stack writes the same caches
    and ends on the same logits as the token-by-token prefill, to rtol
    1e-5 / atol 1e-5 (a chunk's matmuls sum in another order); a
    recurrent stack refuses it."""
    from repro_torch.models import init_decode_states, init_params
    from repro_torch.serving import prefill
    cfg = _serve_cfg(ENGINE_ARCH, dict(F32, sliding_window=4))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_prompts(cfg, 2)).long()
    with torch.no_grad():
        one, s1 = prefill(params, cfg, toks,
                          init_decode_states(cfg, 2, 16, "cpu"))
        many, sn = prefill(params, cfg, toks,
                           init_decode_states(cfg, 2, 16, "cpu"), chunk=chunk)
    np.testing.assert_allclose(many.numpy(), one.numpy(), **TOL)
    for key in s1:
        for a, b in zip(sn[key], s1[key]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    xcfg = _serve_cfg("xlstm-125m", F32)
    with pytest.raises(ValueError, match="attention-only"):
        prefill(init_params(xcfg, torch.Generator().manual_seed(0), "cpu"),
                xcfg, toks, init_decode_states(xcfg, 2, 16, "cpu"),
                chunk=chunk)
