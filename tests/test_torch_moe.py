"""Port parity, MoE slice: routing, capacity and positions, the three
dispatch impls, the expert wire's calibration and the MoE train steps,
against the JAX reference; and the port's own contracts on gloo ranks
laid out ``data x model`` (1 x 4 and 2 x 2): expert-parallel dispatch
equals gspmd on the whole batch, the QLC expert wire equals its raw e4m3
twin bit for bit, ring equals one-shot.

Stated tolerances and why:

* router gates and probabilities, the aux loss: rtol 1e-6 — the router
  matmul sums in another order in each framework (expert indices, which
  decide the routing, must be equal, and the seeded logits hold no
  near-tie);
* MoE outputs and the combine buffer against the reference, expert
  parallelism's gradients against gspmd: rtol 1e-5 / atol 1e-6 (the
  reference's own tolerance for its expert-parallel gradients);
* expert parallelism's outputs against gspmd: max abs err <= 1e-6 (the
  reference's own expert parallelism is 2.4e-7 off its gspmd);
* the QLC wire against gspmd: relative l2 in (0, 0.15), the reference's
  bounds (e4m3 quantization on the wire);
* training losses: 1e-5 absolute (over 2 x 2 ranks against one rank on
  the same wire); against the reference's compressed
  step the tolerances of ``tests/test_torch_train.py`` (losses rtol
  1e-5, parameters equal on at least 99.9% of entries).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core.registry import CodecRegistry as JRegistry
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JDataset
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.parallel import sharding as shd
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_compressed_opt_state as jinit_opt
from repro.training import make_compressed_step as jmake_step
from repro.training import optimizer as jopt
from repro_torch import adaptive as tad
from repro_torch.comm import calibrate as tcal
from repro_torch.comm.calibrate import histogram_of_quantized
from repro_torch.comm.channel import Channel, ChannelSpec, open_channels
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.convert import params_from_numpy, shard_params
from repro_torch.core import CodecRegistry
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import (Mesh, data_parallel, make_test_mesh,
                                     use_mesh)
from repro_torch.models import init_params, moe
from repro_torch.models.transformer import pytree_leaves, pytree_unflatten
from repro_torch.training import TrainConfig, make_compressed_step
from repro_torch.training import optimizer as topt
from tests.torch_dist import run_ranks
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

TINY = {"model": dict(name="t", family="moe", num_layers=1, d_model=16,
                      num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64),
        "moe": dict(num_experts=4, top_k=2, d_expert=8,
                    num_shared_experts=1)}
TOL = dict(rtol=1e-5, atol=1e-6)


def _cfgs(name, impl="gspmd", **moe_over):
    """(reference, port) configs, f32: the tiny one of the reference's
    ``tests/test_moe.py`` or reduced deepseek-moe-16b."""
    if name == "tiny":
        j = JModelConfig(moe=JMoEConfig(**TINY["moe"]), **TINY["model"])
        t = ModelConfig(moe=MoEConfig(**TINY["moe"]), **TINY["model"])
    else:
        j = jreduced(jget_config("deepseek-moe-16b"), dtype="float32")
        t = reduced(get_config("deepseek-moe-16b"), dtype="float32")
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, impl=impl, **moe_over)) for c in (j, t))


def _setup(name, seed=0):
    jc, tc = _cfgs(name)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jc, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed + 1).standard_normal(
        (4, 8, jc.d_model)).astype(np.float32)
    return jc, tc, jp, tp, x


def _port(tp, x, cfg, **kw):
    routing = []
    with moe.capture_moe_routing(routing):
        y = moe.moe_block(tp, torch.from_numpy(x), cfg, **kw)
    return y.detach().numpy(), routing[0]


def _ref(jp, x, cfg):
    return np.asarray(jax.jit(lambda p, t: jmoe.moe_block(p, t, cfg))(
        jp, jnp.asarray(x)))


def _ref_keep(jp, x, cfg):
    m = cfg.moe
    xf = jnp.asarray(x).reshape(-1, cfg.d_model)
    idx, _, _ = jmoe._route(jp, xf, m)
    pos = jmoe._positions_in_expert(idx.reshape(-1), m.num_experts)
    return np.asarray(pos < jmoe._capacity(xf.shape[0], m))


@pytest.mark.parametrize("name", ["tiny", "deepseek-moe-16b-smoke"])
def test_routing_capacity_positions_match_reference(name):
    jc, tc, jp, tp, x = _setup(name)
    xf = x.reshape(-1, jc.d_model)
    logits = xf.astype(np.float64) @ np.asarray(jp["router"], np.float64)
    srt = -np.sort(-logits, axis=-1)
    assert np.abs(np.diff(srt[:, :jc.moe.top_k + 1], axis=-1)).min() > 1e-4
    ji, jg, jpr = jmoe._route(jp, jnp.asarray(xf), jc.moe)
    ti, tg, tpr = moe._route(tp, torch.from_numpy(xf), tc.moe)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), rtol=1e-6)
    np.testing.assert_allclose(
        float(moe.aux_load_balance_loss(tpr, ti, tc.moe)),
        float(jmoe.aux_load_balance_loss(jpr, ji, jc.moe)), rtol=1e-6)
    for n in (1, 7, 32, 33, 2048, 4096):
        for cf in (0.25, 1.0, 1.25, 2.0):
            jm = dataclasses.replace(jc.moe, capacity_factor=cf)
            tm = dataclasses.replace(tc.moe, capacity_factor=cf)
            assert moe._capacity(n, tm) == jmoe._capacity(n, jm)
    flat = np.asarray(ji).reshape(-1).astype(np.int64)
    np.testing.assert_array_equal(
        moe._positions_in_expert(torch.from_numpy(flat),
                                 tc.moe.num_experts).numpy(),
        np.asarray(jmoe._positions_in_expert(jnp.asarray(flat),
                                             jc.moe.num_experts)))


def test_dispatch_traffic_matches_reference():
    jc, tc, jp, tp, x = _setup("tiny")
    jb, je = jmoe.dispatch_traffic(jp, jnp.asarray(x), jc)
    tb, te = moe.dispatch_traffic(tp, torch.from_numpy(x), tc)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)


@pytest.mark.parametrize("impl,over", [
    ("gspmd", {}), ("grouped_local", {}),
    ("grouped_local", {"dispatch_groups": 4}),
    ("gspmd", {"capacity_factor": 0.25})])
def test_moe_block_matches_reference(impl, over):
    _, _, jp, tp, x = _setup("tiny")
    jc, tc = _cfgs("tiny", impl, **over)
    y, routing = _port(tp, x, tc)
    np.testing.assert_allclose(y, _ref(jp, x, jc), **TOL)
    if impl == "gspmd":
        np.testing.assert_array_equal(routing["keep"].numpy(),
                                      _ref_keep(jp, x, jc))


def test_capacity_drops_and_grouped_single_group():
    """At capacity factor 0.25 the drops are the reference's and the
    output moves; ``grouped_local`` over one group is bit-equal to
    ``gspmd`` (the reference's own check, red there by one f32 ulp
    under XLA)."""
    _, tc, jp, tp, x = _setup("tiny")
    jof, tof = _cfgs("tiny", capacity_factor=0.25)
    y_g, r_g = _port(tp, x, tc)
    y_of, r_of = _port(tp, x, tof)
    keep = _ref_keep(jp, x, jof)
    assert not keep.all()
    np.testing.assert_array_equal(r_of["keep"].numpy(), keep)
    assert (y_of != y_g).any()
    _, t1 = _cfgs("tiny", "grouped_local", dispatch_groups=1)
    y_1, r_1 = _port(tp, x, t1)
    np.testing.assert_array_equal(y_1, y_g)
    np.testing.assert_array_equal(r_1["keep"].numpy(),
                                  r_g["keep"].numpy())


def test_errors_and_geometry_match_reference():
    _, tc, _, tp, x = _setup("tiny")
    with pytest.raises(ValueError, match="supported impls"):
        moe.moe_block(tp, torch.from_numpy(x), _cfgs("tiny", "bogus")[1])
    with pytest.raises(ValueError, match="mesh with a 'model' axis"):
        moe.moe_block(tp, torch.from_numpy(x),
                      _cfgs("tiny", "shardmap_a2a")[1])

    class M:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 4}

    class M8:
        axis_names = ("model",)
        shape = {"model": 8}

    jc, tc = _cfgs("tiny")
    for n, mesh in ((33, M()), (32, M8())):
        with pytest.raises(ValueError) as want:
            jmoe.shardmap_a2a_geometry(jc, n, mesh)
        with pytest.raises(ValueError) as got:
            moe.shardmap_a2a_geometry(tc, n, mesh)
        assert str(got.value) == str(want.value)
    assert moe.shardmap_a2a_geometry(tc, 32, M()) == \
        jmoe.shardmap_a2a_geometry(jc, 32, M())
    assert moe.SUPPORTED_IMPLS == jmoe.SUPPORTED_IMPLS
    assert (moe.MOE_DISPATCH, moe.MOE_COMBINE) == \
        (jmoe.MOE_DISPATCH, jmoe.MOE_COMBINE)
    assert moe.moe_param_specs(tc) == jmoe.moe_param_specs(jc)


def _registry(tp, x, tc) -> CodecRegistry:
    """The expert wire's codecs from the tiny layer's traffic, at
    256-symbol chunks (the reference's multi-device check's recipe)."""
    buf, out_e = moe.dispatch_traffic(tp, torch.from_numpy(x), tc)
    reg = CodecRegistry()
    for name, t in ((moe.MOE_DISPATCH, buf), (moe.MOE_COMBINE, out_e)):
        reg.register(name, np.maximum(histogram_of_quantized(t.detach()),
                                      1e-6), chunk_symbols=256)
    return reg


def _grads(tp, x, tc):
    live = [t.clone().requires_grad_(True) for t in pytree_leaves(tp)]
    y = moe.moe_block(pytree_unflatten(tp, live), torch.from_numpy(x), tc)
    return [g.numpy() for g in torch.autograd.grad((y ** 2).sum(), live)]


#: the 2 x 2 case's two training steps through ``launch.train.train``
EP_TRAIN = {"cfg": {"dtype": "float32"},
            "run": dict(steps=2, seq_len=16, global_batch=4)}


@pytest.fixture(scope="module")
def ep_layouts():
    """Both layouts of :func:`test_expert_parallel_on_gloo_ranks` in one
    world of 4 gloo ranks -> {model: every rank's result}."""
    _, tc, jp, tp, x = _setup("tiny")
    out = run_ranks("moe_layouts", 4, models=[4, 2], cfg_kw=TINY,
                    params=jax.tree.map(np.asarray, jp), x=x,
                    registry_json=_registry(tp, x, tc).to_json(),
                    train_kw={2: EP_TRAIN})
    return {model: [r[model] for r in out] for model in (4, 2)}


@pytest.mark.parametrize("model", [4, 2], ids=["1x4", "2x2"])
def test_expert_parallel_on_gloo_ranks(ep_layouts, model):
    """``shardmap_a2a`` over 4 gloo ranks laid out 1 x 4 and 2 x 2, each
    rank's FFN leaves cut by their specs (experts and router columns by
    experts, the shared expert by its mlp dim), each model row holding
    its data shard and cutting its tokens over the row, the batch
    declared over the data column, against the port's ``gspmd`` on the
    whole batch in one process: the ranks' pieces in rank order route
    and drop as gspmd, outputs within 1e-6, gradients (summed over the
    data column) within the reference's tolerance of the cut of gspmd's;
    the QLC wire equal to its raw e4m3 twin and ring to one-shot, bit
    for bit, and within the reference's bounds of gspmd. On 2 x 2 also
    two baseline training steps of reduced
    deepseek-moe through ``launch.train.train`` against one rank: raw
    expert parallelism against gspmd, the QLC wire against the same wire
    on one rank (e4m3 on the wire moves the loss by ~2e-3, so the wire's
    run is held against its own single-rank run; block-32 scales lie
    inside a token's row, so the layout does not change them)."""
    _, tc, jp, tp, x = _setup("tiny")
    y_g, r_g = _port(tp, x, tc)
    y_of, r_of = _port(tp, x, _cfgs("tiny", capacity_factor=0.25)[1])
    g_g = _grads(tp, x, tc)
    train_kw = EP_TRAIN if model == 2 else None
    out = ep_layouts[model]
    cat = {k: np.concatenate([o[k] for o in out])
           for k in ("raw", "raw_cf025", "qlc", "ring", "twin", "idx",
                     "keep", "keep_cf025")}
    np.testing.assert_array_equal(cat["idx"], r_g["idx"].numpy())
    np.testing.assert_array_equal(cat["keep"], r_g["keep"].numpy())
    np.testing.assert_array_equal(cat["keep_cf025"], r_of["keep"].numpy())
    assert np.abs(cat["raw"] - y_g.reshape(cat["raw"].shape)).max() <= 1e-6
    assert np.abs(cat["raw_cf025"]
                  - y_of.reshape(cat["raw"].shape)).max() <= 1e-6
    np.testing.assert_array_equal(cat["qlc"], cat["twin"])
    np.testing.assert_array_equal(cat["ring"], cat["qlc"])
    rel = (np.linalg.norm(cat["qlc"] - y_g.reshape(cat["qlc"].shape))
           / np.linalg.norm(y_g))
    assert 0 < rel < 0.15, rel
    whole = pytree_unflatten(tp, [torch.from_numpy(g) for g in g_g])
    for rank, o in enumerate(out):
        cut = shard_params(whole, tc, rank % model, model,
                           specs=moe.moe_param_specs(tc))
        for want, got, got_q in zip(pytree_leaves(cut), o["grads_raw"],
                                    o["grads_qlc"]):
            np.testing.assert_allclose(got, want.numpy(), **TOL)
            assert np.isfinite(got_q).all()
        assert any((g != 0).any() for g in o["grads_qlc"])
    if train_kw is not None:
        cfg = reduced(get_config("deepseek-moe-16b"), dtype="float32")
        one = {wire: train_mod.train(cfg, comm="baseline", moe_wire=wire,
                                     device="cpu", **train_kw["run"])
               for wire in ("raw", "qlc")}
        for o in out:
            for name, wire in (("train_raw_ep", "raw"), ("train_qlc", "qlc")):
                want = [h["loss"] for h in one[wire]["history"]]
                np.testing.assert_allclose(o[name], want, rtol=0, atol=1e-5)
            for r in o["train_moe"].values():
                assert r["wire_bytes_per_symbol"] == \
                    r["modeled_wire_bytes_per_symbol"]


#: ``grouped_local`` over 2 data ranks: 24 tokens, 12 a rank, in 1 group
#: (both ranks' tokens) and in 3 groups of 8 (the middle one straddles
#: the ranks); capacity factor 0.5, so that every group drops
GROUPS = (1, 3)
GROUPS_MOE = dict(TINY["moe"], capacity_factor=0.5)
GROUPS_TRAIN = {"cfg": {"dtype": "float32"},
                "run": dict(steps=2, seq_len=16, global_batch=4)}


@pytest.fixture(scope="module")
def straddling():
    """``torch_dist.moe_groups`` on a world of 2 gloo ranks laid out
    2 x 1 -> (the reference's config maker, its params, x, the ranks'
    results)."""
    jc = JModelConfig(moe=JMoEConfig(**GROUPS_MOE), **TINY["model"])
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jc, jnp.float32)
    x = np.random.default_rng(4).standard_normal(
        (2, 12, jc.d_model)).astype(np.float32)
    out = run_ranks("moe_groups", 2,
                    cfg_kw={"model": TINY["model"], "moe": GROUPS_MOE},
                    params=jax.tree.map(np.asarray, jp), x=x, groups=GROUPS,
                    train_kw=GROUPS_TRAIN)
    return jc, jp, x, out


def _ref_grouped(jp, x, jc, g):
    """The reference's unsharded ``grouped_local`` over ``g`` groups: its
    output, the gradients of ``sum(y ** 2)`` and its kept assignments
    (each group's arrival positions under its capacity)."""
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, impl="grouped_local", dispatch_groups=g))
    m = jc.moe

    def loss(p):
        return (jmoe.moe_block(p, jnp.asarray(x), jc) ** 2).sum()

    y = np.asarray(jmoe.moe_block(jp, jnp.asarray(x), jc))
    grads = jax.grad(loss)(jp)
    xf = jnp.asarray(x).reshape(-1, jc.d_model)
    idx, _, _ = jmoe._route(jp, xf, m)
    ng = xf.shape[0] // g
    keep = [np.asarray(jmoe._positions_in_expert(e, m.num_experts)
                       < jmoe._capacity(ng, m))
            for e in np.asarray(idx).reshape(g, -1)]
    return y, grads, np.concatenate(keep)


def test_grouped_local_one_group_over_ranks_is_gspmd(straddling):
    """``grouped_local`` at one dispatch group over 2 data ranks (the
    group holds both ranks' tokens) is ``gspmd`` under ``batch_over``
    on the same ranks, bit for bit: each rank's output, kept
    assignments and the gradients summed over the column; and two
    baseline training steps of reduced deepseek-moe-16b give the same
    losses and parameters."""
    _, _, _, out = straddling
    for r in out:
        for a, b in zip(r["grouped_local/1"][:2], r["gspmd/1"][:2]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r["grouped_local/1"][2], r["gspmd/1"][2]):
            np.testing.assert_array_equal(a, b)
        (lg, pg), (ls, ps) = r["train"]["grouped_local"], r["train"]["gspmd"]
        assert lg == ls and len(lg) == GROUPS_TRAIN["run"]["steps"]
        for a, b in zip(pg, ps):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("g", GROUPS)
def test_grouped_local_straddling_groups_match_reference(straddling, g):
    """``grouped_local`` over 2 data ranks at each group count, the
    middle of 3 groups straddling the ranks: the ranks' outputs in rank
    order within the stated tolerance of the reference's unsharded
    ``_moe_grouped`` on the whole batch, and the kept assignments
    exactly the reference's (some are dropped); the gradients summed over
    the column within the reference's tolerance of the port's own
    unsharded ``grouped_local``, and within rtol 1e-5 of the
    reference's, with an absolute 1e-6 of each leaf's largest entry:
    the gradients' f32 sums of terms up to ~40 round differently in
    each framework, and the port's one-process ``grouped_local`` itself
    sits up to 2.3e-5 from the reference on leaves of magnitude 47."""
    jc, jp, x, out = straddling
    y, grads, keep = _ref_grouped(jp, x, jc, g)
    got = np.concatenate([r[f"grouped_local/{g}"][0] for r in out])
    np.testing.assert_allclose(got, y, **TOL)
    kept = np.concatenate([r[f"grouped_local/{g}"][1] for r in out])
    np.testing.assert_array_equal(kept, keep)
    assert not keep.all()
    tc = ModelConfig(moe=MoEConfig(**GROUPS_MOE, impl="grouped_local",
                                   dispatch_groups=g), **TINY["model"])
    one = _grads(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), x,
                 tc)
    want = [np.asarray(a) for a in jax.tree.leaves(grads)]
    for r in out:
        for a, b, w in zip(r[f"grouped_local/{g}"][2], one, want):
            np.testing.assert_allclose(a, b, **TOL)
            np.testing.assert_allclose(a, w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max())


def test_calibrate_moe_entries_matches_reference(monkeypatch):
    """The same captured streams into both packages' calibration give
    the same registry (scheme-ids, tables, plans), which loads in both
    directions; a second call keeps the registered names."""
    jc = jreduced(jget_config("deepseek-moe-16b"), dtype="float32")
    tc = reduced(get_config("deepseek-moe-16b"), dtype="float32")
    jp = jax.jit(lambda k: jinit_params(jc, k))(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tok = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 32)
                                            ).astype(np.int32)
    streams = []
    real = moe.dispatch_traffic

    def record(*a):
        out = real(*a)
        streams.append(tuple(t.numpy() for t in out))
        return out

    monkeypatch.setattr(moe, "dispatch_traffic", record)
    treg = CodecRegistry()
    tcal.calibrate_moe_entries(treg, tc, tp, {
        "tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok)},
        chunk_symbols=256)
    assert len(streams) == jc.num_layers
    feed = iter(streams)
    monkeypatch.setattr(jmoe, "dispatch_traffic",
                        lambda *a: tuple(jnp.asarray(t) for t in next(feed)))
    from repro.comm import calibrate_moe_entries as jcal
    jreg = JRegistry()
    jcal(jreg, jc, jp, {"tokens": jnp.asarray(tok),
                        "labels": jnp.asarray(tok)}, chunk_symbols=256)
    assert json.loads(treg.to_json())["entries"] == \
        json.loads(jreg.to_json())["entries"]
    for src, dst_cls in ((treg, JRegistry), (jreg, CodecRegistry)):
        back = dst_cls.from_json(src.to_json())
        assert [e.scheme_id for e in back.entries()] == \
            [e.scheme_id for e in src.entries()]
    ids = {n: treg[n].scheme_id for n in treg.names()}
    again = tcal.calibrate_moe_entries(treg, tc, tp, {
        "tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok)})
    assert {n: e.scheme_id for n, e in again.items()} == ids


def test_compressed_step_tracks_reference_with_moe():
    """``train(comm="qlc")`` of reduced deepseek-moe (gspmd dispatch) on
    one gloo rank against the reference's compressed step on a 1 x 1
    mesh, from the same parameters, batches and registry, 3 steps."""
    jc = jreduced(jget_config("deepseek-moe-16b"), dtype="float32")
    tc = reduced(get_config("deepseek-moe-16b"), dtype="float32")
    jp = jax.jit(lambda k: jinit_params(jc, k))(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    res = train_mod.train(tc, comm="qlc", steps=3, seq_len=32,
                          global_batch=4, device="cpu", params=tp)
    assert all(h["ok"] for h in res["history"]) and "moe" not in res
    jreg = JRegistry.from_json(res["registry"].to_json())
    mesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    opt_cfg = jopt.OptConfig(lr=3e-4, total_steps=3, warmup_steps=10)
    step = jax.jit(jmake_step(jc, opt_cfg, JTrainConfig(), mesh, jreg))
    data = JDataset(JDataConfig(vocab_size=jc.vocab_size, seq_len=32,
                                global_batch=4))
    with shd.use_mesh(mesh):
        o = jinit_opt(jc, mesh, JTrainConfig(), jreg, opt_cfg)
        p, losses = jp, []
        for s in range(3):
            batch = {k: jnp.asarray(v) for k, v in data.batch_at(s).items()}
            p, o, m = step(p, o, batch)
            assert bool(m["ok"])
            losses.append(float(m["loss"]))
    np.testing.assert_allclose([h["loss"] for h in res["history"]], losses,
                               rtol=1e-5)
    a = np.concatenate([np.asarray(t).reshape(-1)
                        for t in jax.tree.leaves(p)])
    b = np.concatenate([t.reshape(-1).numpy()
                        for t in pytree_leaves(res["params"])])
    assert (a == b).mean() >= 0.999


def test_compressed_step_refuses_a_model_axis():
    """The compressed step takes an MoE over a model axis now (``gspmd``
    at 1 x 2, ``shardmap_a2a`` at 2 x 1 and 1 x 2 build, their wire on
    the data column); what it refuses is what the reference refuses or
    the port has not ported: ``shardmap_a2a`` without a mesh or with
    experts that do not divide the model axis (``ValueError``, the
    reference's message) and the pods' hierarchical wire (item 13)."""
    cfg = reduced(get_config("deepseek-moe-16b"))
    ep = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl="shardmap_a2a"))
    opt_cfg = topt.OptConfig()
    reg = CodecRegistry()
    reg.register("grads", np.ones(256), chunk_symbols=256)
    with data_parallel("cpu") as world:
        for c, (data, model) in ((cfg, (1, 2)), (ep, (2, 1)), (ep, (1, 2))):
            mesh = Mesh(data=data, model=model, rank=0, world_group=world,
                        data_group=world, model_group=world)
            step = make_compressed_step(c, opt_cfg, TrainConfig(), None, reg,
                                        mesh=mesh)
            assert step.group is world
        with pytest.raises(NotImplementedError, match="item 13"):
            make_compressed_step(cfg, opt_cfg, TrainConfig(), None, reg,
                                 hierarchical_wire=True)
    three = Mesh(data=1, model=3, rank=0, world_group=None,
                 data_group=None, model_group=None)
    with pytest.raises(ValueError, match=r"num_experts \(4\) divisible by "
                                         r"the model axis \(3\)"):
        make_compressed_step(ep, opt_cfg, TrainConfig(), None, None,
                             mesh=three)
    with pytest.raises(ValueError, match="'model' axis"):
        make_compressed_step(ep, opt_cfg, TrainConfig(), None, None)


def test_one_rank_layout_and_channels_on_the_model_axis():
    """One gloo rank is a 1 x 1 layout whose groups are the world's;
    ``ChannelSpec(axis=...)`` resolves its group from the mesh in scope
    and raises without one; ``shard_params`` cuts one MoE FFN (its
    ``moe_param_specs``) or a whole model to a rank's experts, router
    columns and shared-expert block."""
    _, tc, _, tp, _ = _setup("tiny")
    reg = CodecRegistry()
    reg.register(moe.MOE_DISPATCH, np.ones(256), chunk_symbols=256)
    with data_parallel("cpu") as world:
        mesh = make_test_mesh()
        assert (mesh.shape, mesh.coords) == ({"data": 1, "model": 1},
                                             (0, 0))
        assert mesh.model_group is world and mesh.data_group is world
        with pytest.raises(ValueError, match="mesh in scope"):
            Channel(ChannelSpec(codec=moe.MOE_DISPATCH, axis="model"),
                    registry=reg)
        with use_mesh(mesh):
            ch = Channel(ChannelSpec(codec=moe.MOE_DISPATCH, axis="model"),
                         registry=reg)
        assert ch.group is world and ch.axis == "model"
        opened = open_channels(reg, mesh, axis="model")
        assert opened[moe.MOE_DISPATCH].group is world
        with pytest.raises(NotImplementedError, match="item 13"):
            mesh.group("pod")
    cut = shard_params(tp, tc, 1, 2, specs=moe.moe_param_specs(tc))
    for key in moe.EXPERT_LEAVES:
        assert torch.equal(cut[key], tp[key][2:])
    assert torch.equal(cut["router"], tp["router"][:, 2:])
    assert torch.equal(cut["shared"]["w_in"], tp["shared"]["w_in"][:, 4:])
    rcfg = reduced(get_config("deepseek-moe-16b"))
    full = init_params(rcfg, torch.Generator().manual_seed(0), "cpu")
    flat = shard_params(full, rcfg, 0, 4)
    ffn = full["groups"]["l0"]["ffn"]
    for key in moe.EXPERT_LEAVES:          # one stacked MoE layer group
        assert flat["groups"]["l0"]["ffn"][key].numel() == \
            ffn[key].numel() // 4


def test_adaptive_moe_channels_put_the_revision_on_the_wire():
    """``adaptive_moe_channels``: a controller swap of ``moe/dispatch``
    rebinds the wrapped map, and the next expert-parallel call encodes
    with the new codec (its payload's wire bytes are the revision's)."""
    from repro.core.distributions import ffn1_counts, ffn2_counts
    _, _, _, tp, x = _setup("tiny")
    _, tc = _cfgs("tiny", "shardmap_a2a")
    reg = CodecRegistry()
    reg.register(moe.MOE_DISPATCH, ffn1_counts(1 << 14, 1),
                 chunk_symbols=256)
    reg.register(moe.MOE_COMBINE, ffn1_counts(1 << 14, 2),
                 chunk_symbols=256)
    controller = tad.AdaptiveController(reg, drift=tad.DriftConfig(
        min_events=2, hysteresis=2, cooldown=0, min_symbols=1024))
    with data_parallel("cpu"):
        mesh = make_test_mesh(model=1)
        with use_mesh(mesh):
            chans = moe.adaptive_moe_channels(controller, {
                name: Channel(ChannelSpec(codec=name, axis="model"),
                              registry=reg)
                for name in (moe.MOE_DISPATCH, moe.MOE_COMBINE)})
        before = chans[moe.MOE_DISPATCH].entry.scheme_id
        for _ in range(4):
            controller.observe(moe.MOE_DISPATCH, ffn2_counts(1 << 14, 2))
            controller.check()
        after = chans[moe.MOE_DISPATCH].entry
        assert after.scheme_id != before and after is reg[moe.MOE_DISPATCH]
        wire = {}
        with use_mesh(mesh), moe.bind_moe_channels(chans), \
                moe.record_moe_wire(wire):
            moe.moe_block(tp, torch.from_numpy(x), tc)
    nbytes, n = wire[moe.MOE_DISPATCH]
    assert nbytes == chans[moe.MOE_DISPATCH].modeled_wire_bytes(n)
    assert chans[moe.MOE_DISPATCH].cfg == after.config()


def test_launcher_trains_moe_on_the_qlc_wire(capsys):
    res = train_mod.main(["--arch", "deepseek-moe-16b", "--reduced",
                          "--device", "cpu", "--comm", "qlc", "--moe-wire",
                          "qlc", "--steps", "2"])
    assert len(res["history"]) == 2 and all(h["ok"] for h in res["history"])
    out = capsys.readouterr().out
    for name in (moe.MOE_DISPATCH, moe.MOE_COMBINE):
        assert f"moe codec {name}: scheme-id" in out
        r = res["moe"][name]
        assert r["wire_bytes_per_symbol"] == \
            r["modeled_wire_bytes_per_symbol"]
