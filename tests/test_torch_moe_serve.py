"""Port parity, MoE serving slice: decoding deepseek-moe-16b (reduced)
from the QLC weight wire, against the JAX reference.

The reduced config keeps the full model's routing (64 routed experts
top-6, 2 shared) at d_model 64 with experts of width 16, so each expert
leaf holds 64 x 64 x 16 = 65536 symbols a layer, the wire's minimum, and
goes on the wire. At batch 4 a decode step's capacity is
``max(1, int(4 * 6 * 1.25 // 64)) = 1`` per expert, so decode steps drop
assignments, as the full model's do; prefill runs at batch 1, with no
drops. Compute is f32 so the logits compare tightly.

Stated tolerances and why:

* decode-step logits: rtol 1e-4 / atol 1e-5, the serving slice's (f32
  matmul summation order differs between the frameworks);
* routing (expert indices), the keep mask and the drops: exact, on the
  port's own MoE inputs (the reference's router on the same states); a
  near-tie among the top-k + 1 router logits is reported with its gap;
* Engine tokens, paged against dense, wire trees and manifests: exact.
"""
import contextlib
import gc
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import CodecRegistry as JRegistry
from repro.models import decode_step as j_decode_step
from repro.models import init_decode_states as j_init_states
from repro.models import moe as jmoe
from repro.parallel import sharding as shd
from repro.serving import Engine as JEngine
from repro.serving import GenerationRequest as JRequest
from repro.serving import compress_params_for_serving as j_compress
from repro.serving import open_params as j_open
from repro.serving import serving_manifest as j_manifest
from repro_torch.comm.calibrate import histogram_of_tree as t_hist
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_numpy, wire_from_numpy, \
    wire_to_numpy
from repro_torch.core import CodecRegistry
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.mesh import data_parallel, make_test_mesh, use_mesh
from repro_torch.models import (decode_step, init_decode_states,
                                init_params, moe)
from repro_torch.models.transformer import tree_leaves
from repro_torch.serving import (Engine, GenerationRequest, KVCacheSpec,
                                 compress_params_for_serving, open_params,
                                 serving_manifest)
from tests.torch_dist import assert_same_tree
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

MOE = dict(num_experts=64, top_k=6, d_expert=16, num_shared_experts=2)
TOL = dict(rtol=1e-4, atol=1e-5)
#: six requests at batch 4; the short first one frees slot 0 while the
#: others run, so a free row precedes active rows in later steps.
BUDGETS = (3, 6, 6, 6, 5, 6)
PROMPT = 4


def _cfgs(impl="gspmd"):
    j = j_reduced(j_get_config("deepseek-moe-16b"), dtype="float32",
                  moe=JMoEConfig(**MOE, impl=impl))
    t = reduced(get_config("deepseek-moe-16b"), dtype="float32",
                moe=MoEConfig(**MOE, impl=impl))
    return j, t


@pytest.fixture(scope="module")
def slice_():
    """Both packages' weights, numpy-seeded in the reference's layout,
    calibrated (one codec, the reference's registry loaded from the
    port's JSON), wired and opened."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(0)

    def draw(node):          # numpy normals at each init leaf's scale
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        if bool((node == 1).all()):
            return np.ones(node.shape, np.float32)
        return (rng.standard_normal(node.shape) * float(node.std())
                ).astype(np.float32)

    host = draw(init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    tp = params_from_numpy(host, device="cpu")
    jp = jax.tree.map(jnp.asarray, host)
    treg = CodecRegistry()
    treg.register("default", t_hist(tp))
    jreg = JRegistry.from_json_dict(treg.to_json_dict())
    jw, jwc = j_compress(jp, jreg, use_kernels=False)
    tw, twc = compress_params_for_serving(tp, treg, use_kernels=False)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (len(BUDGETS), PROMPT))
    return dict(jcfg=jcfg, cfg=cfg, tp=tp, jw=jw, jwc=jwc, tw=tw, twc=twc,
                jopen=j_open(jw, jwc), topen=open_params(tw, twc),
                prompts=prompts)


def test_expert_leaves_on_the_wire_and_between_packages(slice_):
    """The three expert leaves (and only they) are wired; the wired tree
    and its manifest move between the packages bit for bit, both ways,
    and open to the reference's values."""
    twc, tw, jw = slice_["twc"], slice_["tw"], slice_["jw"]
    assert sorted(twc.meta) == [f"groups/l0/ffn/{k}"
                                for k in ("w_gate", "w_in", "w_out")]
    assert_same_tree(jax.tree.map(np.asarray, jw),
                     wire_to_numpy(tw, twc)[0])
    manifest = json.loads(json.dumps(j_manifest(slice_["jwc"])))
    assert json.loads(json.dumps(serving_manifest(twc))) == manifest
    pw, pwc = wire_from_numpy(jax.tree.map(np.asarray, jw), manifest,
                              device="cpu")
    assert_same_tree(tw, pw)
    assert_same_tree(slice_["jopen"], open_params(pw, pwc))
    assert_same_tree(slice_["jopen"], slice_["topen"])


def _ref_keep(router, x, cfg) -> np.ndarray:
    """The reference's routing and capacity keep mask on the port's MoE
    input ``x`` [B, 1, D] (decode: the step's B tokens are the batch)."""
    m = cfg.moe
    xf = jnp.asarray(x.reshape(-1, cfg.d_model).numpy())
    idx, _, _ = jmoe._route({"router": jnp.asarray(router.numpy())}, xf, m)
    n = xf.shape[0]
    if m.impl == "grouped_local":           # one token a group here
        g = min(m.dispatch_groups, n)
        while n % g:
            g -= 1
        flat = idx.reshape(g, -1)
        keep = [jmoe._positions_in_expert(f, m.num_experts)
                < jmoe._capacity(n // g, m) for f in flat]
        return np.asarray(idx), np.concatenate([np.asarray(k) for k in keep])
    pos = jmoe._positions_in_expert(idx.reshape(-1), m.num_experts)
    return np.asarray(idx), np.asarray(pos < jmoe._capacity(n, m))


def _top_gap(router, x, k) -> float:
    logits = x.reshape(-1, router.shape[0]).double().numpy() \
        @ router.double().numpy()
    srt = -np.sort(-logits, axis=-1)[:, :k + 1]
    return float(np.abs(np.diff(srt, axis=-1)).min())


@pytest.mark.parametrize("impl", ["gspmd", "grouped_local", "shardmap_a2a"])
def test_moe_decode_step_matches_reference(slice_, impl):
    """The four prompt tokens and one generated token at batch 4, step
    by step through both packages' decode steps on the opened wire: logits
    within tolerance at every step; at every MoE layer the routing, the
    keep mask and so the drops equal the reference's on the same input.
    gspmd and shardmap_a2a (1 x 1) drop at batch 4, grouped_local (one
    token a dispatch group) does not."""
    jc, tc = _cfgs(impl)
    tokens = slice_["prompts"][:4]
    jmesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
    port_ctx = contextlib.ExitStack()
    if impl == "shardmap_a2a":
        port_ctx.enter_context(data_parallel("cpu"))
        port_ctx.enter_context(use_mesh(make_test_mesh(model=1)))
    jstep = jax.jit(lambda p, t, s, pos: j_decode_step(p, jc, t, s, pos))
    js = j_init_states(jc, 4, 8)
    ts = init_decode_states(tc, 4, 8, device="cpu")
    captured, routing = [], []
    tok = tokens[:, :1].astype(np.int32)
    with port_ctx, shd.use_mesh(jmesh):
        for t in range(PROMPT + 1):
            pos = np.full((4, 1), t, np.int32)
            jl, js = jstep(slice_["jopen"], jnp.asarray(tok), js,
                           jnp.asarray(pos))
            with moe.capture_moe_traffic(captured), \
                    moe.capture_moe_routing(routing):
                tl, ts = decode_step(slice_["topen"], tc,
                                     torch.from_numpy(tok), ts,
                                     torch.from_numpy(pos))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                       err_msg=f"step {t}")
            nxt = np.argmax(np.asarray(jl)[:, 0], axis=-1)[:, None]
            tok = (tokens[:, t + 1:t + 2] if t + 1 < PROMPT
                   else nxt).astype(np.int32)
    assert len(captured) == len(routing) == (PROMPT + 1) * tc.num_layers
    drops = 0
    for (p, x), r in zip(captured, routing):
        idx, keep = _ref_keep(p["router"], x, tc)
        gap = _top_gap(p["router"], x, tc.moe.top_k)
        assert np.array_equal(r["idx"].numpy(), idx), \
            f"routing differs; smallest top-k gap {gap:.3g}"
        np.testing.assert_array_equal(r["keep"].numpy(), keep)
        drops += int((~keep).sum())
    assert (drops > 0) == (impl != "grouped_local"), drops


def test_weight_codec_decode_equals_opened(slice_):
    """The MoE decode step opening each group's wire inside the layer
    loop gives exactly the opened-params step's logits and states."""
    cfg, tp = slice_["cfg"], slice_["tp"]
    wired_g, wc = compress_params_for_serving(tp["groups"],
                                              slice_["twc"].registry)
    tok = torch.tensor([[3], [200], [7], [7]], dtype=torch.int32)
    pos = torch.zeros((4, 1), dtype=torch.int32)
    lw, sw = decode_step({**tp, "groups": wired_g}, cfg, tok,
                         init_decode_states(cfg, 4, 8, device="cpu"), pos,
                         weight_codec=wc)
    lo, so = decode_step(slice_["topen"], cfg, tok,
                         init_decode_states(cfg, 4, 8, device="cpu"), pos)
    assert torch.equal(lw, lo)
    for a, b in zip(tree_leaves(sw), tree_leaves(so)):
        assert torch.equal(a, b)


def _run_port(slice_, **kw):
    eng = Engine(slice_["topen"], slice_["cfg"], max_seq_len=PROMPT + 8,
                 max_batch=4, **kw)
    hs = [eng.submit(GenerationRequest(prompt=p, max_new_tokens=b))
          for p, b in zip(slice_["prompts"], BUDGETS)]
    eng.run()
    return [eng.poll(h).tokens.tolist() for h in hs]


@pytest.fixture(scope="module")
def dense(slice_):
    """The port's dense engine's tokens for the six requests."""
    return _run_port(slice_)


def test_engine_tokens_match_reference(slice_, dense):
    """The port's Engine and the reference's, on the same opened wire
    and the same six requests at batch 4 (free rows fed token 0 at
    position 0 in both), give the same tokens."""
    eng = JEngine(slice_["jopen"], slice_["jcfg"], max_seq_len=PROMPT + 8,
                  max_batch=4)
    hs = [eng.submit(JRequest(prompt=p, max_new_tokens=b))
          for p, b in zip(slice_["prompts"], BUDGETS)]
    eng.run()
    assert dense == [eng.poll(h).tokens.tolist() for h in hs]
    assert [len(t) for t in dense] == list(BUDGETS)


@pytest.mark.parametrize("paging", ["sync", "async"])
def test_paged_qlc_kv_equals_dense(slice_, dense, paging):
    """The paged QLC KV cache, sync (K3/K4's plain versions) and async
    (K5's), is token-identical to the dense engine on the same requests,
    also after request 0 finishes and its free row precedes active
    ones (an async window feeds it token 0 at position 0 throughout)."""
    spec = KVCacheSpec(block_tokens=2, mode="qlc",
                       exact_capacity=paging == "sync")
    assert _run_port(slice_, kv_spec=spec, kv_paging=paging) == dense


def test_launcher_path_with_the_qlc_wire(monkeypatch):
    """``serve(wire="qlc", kv_cache="qlc")`` on the MoE config: of the
    tree it makes, the leaves now on the wire are freed before it opens
    (the others live on inside the wire), the expert leaves are wired, and every request's paged tokens equal the dense run's of
    the same requests at the same batch (checked inside ``serve``)."""
    import repro_torch.serving as serving
    refs, alive_at_open = [], []
    real_init, real_open = serve_mod.init_params, serving.open_params

    def init_spy(*a, **k):
        tree = real_init(*a, **k)
        refs.extend(weakref.ref(t) for t in tree_leaves(tree))
        return tree

    def open_spy(wired, wc):
        gc.collect()
        alive = [r() for r in refs if r() is not None]
        dense = tree_leaves(wired)        # leaves the wire keeps as they are
        alive_at_open.append((len(refs) - len(alive), all(
            any(a is d for d in dense) for a in alive)))
        return real_open(wired, wc)

    monkeypatch.setattr(serve_mod, "init_params", init_spy)
    monkeypatch.setattr(serving, "open_params", open_spy)
    res = serve_mod.serve(_cfgs()[1], batch=4, requests=6,
                          prompt_len=PROMPT, new_tokens=5, wire="qlc",
                          kv_cache="qlc", kv_block=2, device="cpu")
    assert alive_at_open == [(len(res["wire_codec"].meta), True)]
    assert len(res["wire_codec"].meta) == 3
    assert all(o.state == "finished" for o in res["outs"])
    assert [o.tokens.tolist() for o in res["outs"]] == \
        [t.tolist() for t in res["dense_tokens"]]
