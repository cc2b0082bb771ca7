"""Port parity, the reference's sequence-split decode in full: a KV
cache's sequence over the model row (``kv_seq -> model``), over the
whole mesh at a batch of 1 (``kv_seq -> ("data", "model")``, ``batch ->
None``) and over the data column with a row whose ranks read each
other's KV heads, in ``decode_step`` and ``Engine(mesh=)`` (dense, sync
and async paging), against the JAX reference's unsharded decode and the
port's one-rank engine; and ``parallel.sharding.decode_rules`` against
the reference's ``cell_rules``.

Reduced configs at f32 on gloo CPU ranks (``tests/torch_dist``): one
world of 2 (1 x 2) and one of 4 (1 x 4 and 2 x 2), each started once for
all its cases, beside this process, which runs the reference's decodes
and the one-rank engines. Stated tolerances and why:

* the split decode sums the same softmax terms as one softmax, in
  another order (each shard's partial statistics, combined in rank
  order), so its logits meet the reference's unsharded ``decode_step``
  to rtol 1e-5 / atol 1e-5; the partials are all-gathered over the
  shard and combined in the same order on every rank, so every rank
  that decodes the same rows gets the same bits;
* an engine's tokens equal the one-rank engine's at the same batch,
  dense and paged (the paged cache is lossless), and its events, counts
  and KV registry are the same on every rank.
"""
import concurrent.futures
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.parallel import sharding
from repro_torch.serving import Engine, GenerationRequest
from tests.md_util import run_md
from tests.test_torch_tp_serve import _reference_decode, _whole
from tests.torch_dist import SEQ_RULES, run_ranks
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = dict(dtype="float32")
PROMPT, STEPS, NEW_TOKENS, KV_BLOCK = 8, 4, 8, 4
#: the decode's cases: chatglm3's 4 heads over 2 KV heads (split and
#: gathered at 1 x 2, whole at 1 x 4), 6 heads over 3 KV heads (whole
#: KV heads on either row), 4 heads padded to 6 (a rank of padding
#: heads; at 1 x 2 over the data split its query heads read the other
#: rank's KV heads) and a sliding window of 4, so that ranges outside
#: it weigh nothing
CASES = {"gqa": ("chatglm3-6b", F32),
         "kv3": ("chatglm3-6b", dict(F32, num_heads=6, num_kv_heads=3)),
         "padded": ("phi3-mini-3.8b", dict(F32, pad_heads_multiple=3)),
         "window": ("chatglm3-6b", dict(F32, sliding_window=4))}
#: layout id -> (world, model axis, rule of ``torch_dist.SEQ_RULES``,
#: batch, cases)
LAYOUTS = {"model-1x2": (2, 2, "model", 2, tuple(CASES)),
           # a model axis of 1: a shard of one rank, each rank's row of
           # one running the row's decode branch over every KV head
           "model-2x1": (2, 1, "model", 2, tuple(CASES)),
           "model-1x4": (4, 4, "model", 2, tuple(CASES)),
           # the batch over the data column, the sequence over each row
           "model-2x2": (4, 2, "model", 2, tuple(CASES)),
           "both-2x2": (4, 2, "both", 1, tuple(CASES)),
           # rank 0's query heads read rank 1's KV heads
           "data-2x2": (4, 2, "data", 2, ("padded",))}
#: the engine's layouts: (world, model axis, rule, max_batch)
ENGINES = {"model-1x2": (2, 2, "model", 4),
           "model-2x1": (2, 1, "model", 4),
           "model-2x2": (4, 2, "model", 4),
           "both-2x2": (4, 2, "both", 1),
           "data-2x2": (4, 2, "data", 4)}
ENGINE_ARCH = "chatglm3-6b"
ENGINE_KW = dict(F32, num_heads=6, pad_heads_multiple=4)


def _tokens(cfg, batch):
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, PROMPT + STEPS)).astype(np.int64)


def _prompts(cfg, n=6):
    return np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (n, PROMPT)).astype(np.int64)


def _one_rank_engine(cfg, tree, prompts, batch):
    eng = Engine(params_from_numpy(tree, "cpu"), cfg,
                 max_seq_len=PROMPT + NEW_TOKENS + 3, max_batch=batch)
    ids = [f"r{i}" for i in range(len(prompts))]
    for rid, p in zip(ids, prompts):
        eng.submit(GenerationRequest(prompt=p, max_new_tokens=NEW_TOKENS,
                                     request_id=rid))
    eng.run()
    return {rid: eng.poll(rid).tokens for rid in ids}


@pytest.fixture(scope="module")
def worlds():
    """The world of 2 and the world of 4 started together, each in a
    thread; meanwhile this process runs the reference's decodes and the
    one-rank engines. -> ({(layout, case): (cfg, tokens, the
    reference's logits)}, {max_batch: the one-rank engine's tokens},
    {world: per-rank results})."""
    trees = {name: _whole(arch, kw) for name, (arch, kw) in CASES.items()}
    decode = {2: [], 4: []}
    want = {}
    for lay, (world, model, rule, batch, names) in LAYOUTS.items():
        for name in names:
            cfg, tree = trees[name]
            arch, kw = CASES[name]
            toks = _tokens(cfg, batch)
            decode[world].append(dict(
                name=f"{lay}/{name}", arch=arch, cfg_kw=kw, params=tree,
                tokens=toks, prompt=PROMPT, model=model, rule=rule))
            want[(lay, name)] = (cfg, tree, toks)
    ecfg, etree = _whole(ENGINE_ARCH, ENGINE_KW)
    prompts = _prompts(ecfg)
    engine = {2: [], 4: []}
    for lay, (world, model, rule, batch) in ENGINES.items():
        engine[world].append(dict(
            name=lay, arch=ENGINE_ARCH, cfg_kw=ENGINE_KW, params=etree,
            prompts=prompts, model=model, rule=rule, batch=batch))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {w: pool.submit(run_ranks, "seq_serve", w, decode=decode[w],
                               engine=engine[w], new_tokens=NEW_TOKENS,
                               kv_block=KV_BLOCK) for w in (2, 4)}
        refs = {key: (cfg, toks, _reference_decode(cfg, tree, toks))
                for key, (cfg, tree, toks) in want.items()}
        solo = {b: _one_rank_engine(ecfg, etree, prompts, b)
                for b in sorted({e[3] for e in ENGINES.values()})}
        got = {w: f.result() for w, f in futs.items()}
    return refs, solo, got


def _equal_tokens(a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)


@pytest.mark.parametrize("layout,case", [(lay, name) for lay, v in
                                         LAYOUTS.items() for name in v[4]])
def test_split_decode(worlds, layout, case):
    """``decode_step`` under the layout's rule: the logits of each rank's
    rows meet the reference's unsharded decode at the stated tolerance
    and are bit-equal on every rank that decodes the same rows; over the
    model axis a rank's caches hold ``S / size`` positions of every KV
    head, over the data column ``S / data`` of the heads its row's cut
    gives it."""
    refs, _, got = worlds
    cfg, toks, ref = refs[(layout, case)]
    world, model, rule, batch, _ = LAYOUTS[layout]
    ranks = [g["decode"][f"{layout}/{case}"] for g in got[world]]
    by_rows = {}
    for r, (logits, first, shape) in enumerate(ranks):
        np.testing.assert_allclose(
            logits, ref[:, first:first + logits.shape[1]], **TOL,
            err_msg=f"rank {r}")
        same = by_rows.setdefault(first, logits)
        np.testing.assert_array_equal(logits, same, err_msg=f"rank {r}")
        size = {"model": model, "both": world,
                "data": world // model}[rule]
        assert shape[0] == toks.shape[1] // size, (r, shape)
        if rule != "data":
            assert shape[1] == cfg.num_kv_heads, (r, shape)
    assert len(by_rows) == (world // model if rule == "model" else 1)


@pytest.mark.parametrize("layout", sorted(ENGINES))
def test_split_engine_equals_one_rank(worlds, layout):
    """An engine under the layout's rule: ``max_seq_len`` rounded up to
    whole blocks on every rank of the shard; dense, sync and async
    tokens equal to the one-rank engine's at the same batch (so the
    paged runs equal the dense one); events, counts, KV registries and
    async windows the same on every rank; a rank pages blocks (async, through prefetch
    decodes) where its range holds completed ones, and only there."""
    _, solo, got = worlds
    world, model, rule, batch = ENGINES[layout]
    ranks = [g["engine"][layout] for g in got[world]]
    size = {"model": model, "both": world, "data": world // model}[rule]
    first = set()
    for r, runs in enumerate(ranks):
        max_len, off, positions, _ = runs["positions"]
        assert max_len % (size * KV_BLOCK) == 0 and \
            positions == max_len // size, (r, runs["positions"])
        first.add(off)
        for kind in ("dense", "sync", "async"):
            assert _equal_tokens(runs[kind][0], solo[batch]), (r, kind)
            assert runs[kind][1] == ranks[0][kind][1], (r, kind, "events")
            assert runs[kind][3] == ranks[0][kind][3], (r, kind, "counts")
        for kind in ("sync", "async"):
            assert runs[kind][2] == ranks[0][kind][2], (r, kind, "registry")
        # every rank computes its async windows from the same host state
        assert runs["windows"] == ranks[0]["windows"], r
        # a rank pages the completed blocks of its own range alone
        pages = off + KV_BLOCK <= PROMPT + NEW_TOKENS - 1
        assert (runs["sync_pages"][0] > 0) == pages, (r, off)
        assert (runs["async_pages"][1] > 0) == pages, (r, off)
    assert len(first) == size


def test_async_under_a_split_is_served():
    """An async engine over a sequence-split cache is built (it raised
    before): its window step pages each rank's range; slots that do not
    divide over the data column still raise, naming both numbers."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import make_rules, use_rules
    from repro_torch.serving import KVCacheSpec
    from tests.torch_dist import _serve_cfg
    cfg = _serve_cfg(ENGINE_ARCH, F32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    layout = Mesh(data=2, model=1, rank=1, world_group=None,
                  data_group=None, model_group=None)
    for extra in SEQ_RULES.values():
        with use_rules(make_rules(extra=extra)):
            eng = Engine(params, cfg, max_seq_len=16, mesh=layout,
                         kv_paging="async",
                         kv_spec=KVCacheSpec(block_tokens=4,
                                             exact_capacity=False))
        if extra["kv_seq"] == "model":          # a model axis of 1
            assert eng._shard.size == 1 and eng._offset() == 0
            assert eng._states["l0"].k.shape[2] == 16
            continue
        assert eng._shard.size == 2 and eng._offset() == 8
        assert eng._states["l0"].k.shape[2] == 8
    with use_rules(make_rules(extra={"kv_seq": "model"})), \
            pytest.raises(ValueError, match="max_batch 3 .* data axis of 2"):
        Engine(params, cfg, max_seq_len=16, max_batch=3, mesh=layout)


# --------------------------------------------------------------------------
# The reference's decode rules
# --------------------------------------------------------------------------

REFERENCE_RULES = """
import json, types
from repro.launch import dryrun as jd
from repro.configs import ASSIGNED, get_config
from repro.configs.base import ShapeConfig
out = {{}}
for arch in ASSIGNED:
    cfg = get_config(arch)
    for data, model in {meshes}:
        mesh = types.SimpleNamespace(shape={{"data": data, "model": model}})
        for batch in (1, 128):
            r = jd.cell_rules(cfg, ShapeConfig("d", 64, batch, "decode"), mesh)
            out[f"{{arch}}/{{data}}x{{model}}/{{batch}}"] = [
                r.rules, r.param_overrides]
print("RULES" + json.dumps(out))
"""
MESHES = ((16, 16), (2, 2), (1, 4), (4, 1))


def test_decode_rules_match_reference_cell_rules():
    """``parallel.sharding.decode_rules`` gives the rules of the
    reference's decode ``cell_rules`` for every assigned config on the
    production 16 x 16 layout and on 2 x 2, 1 x 4 and 4 x 1, at a batch
    of 1 and of 128, its FSDP parameter overrides included, so that the
    dry run's ``rules_differ`` is empty for every decode cell; and
    ``launch.mesh.kv_seq_shard`` resolves them to the model row or every
    rank (a shard of one rank on an axis of 1), or to none."""
    out = run_md(REFERENCE_RULES.format(meshes=MESHES), n_devices=1)
    want = json.loads(out.split("RULES", 1)[1])
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh, kv_seq_shard, use_mesh
    for arch in ASSIGNED:
        cfg = get_config(arch)
        for data, model in MESHES:
            layout = Mesh(data=data, model=model, rank=data * model - 1,
                          world_group="world", data_group="column",
                          model_group="row")
            for batch in (1, 128):
                got = sharding.decode_rules(cfg, batch, layout)
                rules, over = want[f"{arch}/{data}x{model}/{batch}"]
                assert json.loads(json.dumps(got.rules)) == rules, \
                    (arch, data, model, batch)
                assert json.loads(json.dumps(got.param_overrides)) == \
                    over, (arch, data, model, batch)
                _, differ = dryrun.cell_rules(
                    cfg, ShapeConfig("d", 64, batch, "decode"), layout,
                    "baseline")
                assert differ == [], (arch, data, model, batch)
                with sharding.use_rules(got), use_mesh(layout):
                    shard = kv_seq_shard()
                seq = got.rules["kv_seq"]
                if batch == 1:
                    assert shard.group == "world" and \
                        shard.index == data * model - 1 and \
                        shard.size == data * model
                elif seq == "model":
                    assert shard.group == "row" and \
                        shard.index == model - 1 and shard.size == model
                else:
                    assert seq is None and shard is None, \
                        (arch, data, model, batch)
