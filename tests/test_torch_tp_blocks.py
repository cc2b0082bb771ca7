"""Port parity, tensor parallelism of MoE and recurrent blocks: the cut
of every block kind by its resolved specs, the leaf-by-leaf local init,
the flat ZeRO-1 geometry of a model rank, and the 2-D compressed and
baseline steps of reduced deepseek-moe-16b, xlstm-125m and
jamba-1.5-large (``attn_every=2``: an attention layer with a dense FFN
and a mamba layer with an MoE FFN), against the JAX reference or the
port's own runs.

Reduced configs at f32 on gloo CPU ranks (``tests/torch_dist``): one
world of 4 ranks (2 x 2 and 1 x 4) and one of 2 (1 x 2), beside one
subprocess of the reference a config, each on a (2, 2) mesh of 4 fake
CPU devices, which take the port's registry instead of calibrating. Stated
tolerances and why:

* specs, geometry, the cut, its inverse and the local init: exact;
* routing and capacity drops on the first batch: equal (the whole
  router's logits come from one einsum on every rank; the reference's
  ``_route`` on the port's MoE input gives the same experts, the seeded
  logits holding no near-tie);
* the 2 x 2 compressed steps against the reference's: losses to rtol
  1e-5, each rank's flat vector equal on at least 99.9 % of entries and
  the ZeRO-1 state to rtol 1e-5 / atol 1e-6 of its largest entry on at
  least 99.9 % of entries, as ``tests/test_torch_tp.py`` states for the
  dense step: the row sums of ``x_proj``, ``out_proj``, ``wo`` and the
  experts' outputs add in another order than the reference's unsplit
  einsums, so an e4m3 code may round the other way. So may a block's
  bf16 scale, which moves all 32 values of the block at once: a block
  of the state most of whose entries are off counts as one entry (one
  such block on a segment of 16384 entries is 0.2 % of them; seen once
  in deepseek-moe's runs, an aligned block of ``shared/w_out``).
  xLSTM's state is held at rtol 1e-4: its exponential gates leave the
  two frameworks' moments ~2e-5 apart even on one rank (the port's 1 x 1
  compressed step against the reference's, measured: 99.77 % of ``m``
  and 99.67 % of ``v`` within rtol 1e-5, 99.92 % and 99.96 % within
  1e-4), and the 2 x 2 run is no further (at least 99.92 % within 1e-4
  on every rank);
* the QLC wire against its raw e4m3 twin, and the replicated leaves
  over each model row: bit for bit;
* the baseline steps on 1 x 2 / 1 x 4 against the one-rank step, and
  ``shardmap_a2a`` against ``gspmd`` on the same 2 x 2 layout: losses to
  rtol 1e-5, parameters to rtol 1e-5 / atol 1e-6 on at least 99.9 % of
  entries and every entry within 2 x lr x steps (AdamW's normalized
  step turns the last-bit difference of a near-zero gradient entry into
  a sizeable part of lr). ``shardmap_a2a`` sums each token's top-k
  outputs on the rank that routed it, ``gspmd`` over the row: another
  order again.

The reference cannot run ``shardmap_a2a`` inside its compressed step on
this jax (ROADMAP queue 3, reference caveats), so the port's
``shardmap_a2a`` is held against its own ``gspmd`` run, itself held
against the reference.
"""
import concurrent.futures
import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import (flat_opt_state_from_numpy, gather_params,
                                 init_local_params, shard_params)
from repro_torch.core import CodecRegistry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.train import train
from repro_torch.models import init_params
from repro_torch.models.transformer import pytree_leaves
from repro_torch.parallel import sharding
from repro_torch.training import TrainConfig, make_compressed_step
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import flat_geometry, weight_vec
from tests.md_util import run_md
from tests.torch_dist import flat_tree, run_ranks, tree_bits
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

F32 = dict(dtype="float32")
#: the reduced configs of this slice and their overrides
ARCHS = {
    "deepseek-moe-16b": F32,
    "xlstm-125m": F32,
    "jamba-1.5-large-398b": dict(F32, num_layers=2, attn_every=2),
}
MOE_ARCHS = ("deepseek-moe-16b", "jamba-1.5-large-398b")
#: the ZeRO-1 state's rtol against the reference (module docstring)
STATE_RTOL = {"xlstm-125m": 1e-4}
TRAIN = dict(steps=2, seq_len=16, global_batch=8, lr=3e-4)
#: experts that do not divide a row of 2: the router whole, each
#: expert's mlp dim split (the reference's divisibility fallback)
THREE = dict(F32, moe=dict(num_experts=3, top_k=2, d_expert=32,
                           num_shared_experts=1))
A2A = dict(F32, moe=dict(num_experts=4, top_k=2, d_expert=32,
                         num_shared_experts=1, impl="shardmap_a2a"))
#: baseline cases against one rank: (name, arch, cfg overrides, model)
BASELINE = (
    ("deepseek_1x4", "deepseek-moe-16b", F32, 4),
    ("xlstm_1x4", "xlstm-125m", F32, 4),
    ("jamba_1x2", "jamba-1.5-large-398b", ARCHS["jamba-1.5-large-398b"],
     2),
    ("experts_3_1x2", "deepseek-moe-16b", THREE, 2),
    ("grouped_1x2", "deepseek-moe-16b",
     dict(F32, moe=dict(num_experts=4, top_k=2, d_expert=32,
                        num_shared_experts=1, impl="grouped_local",
                        dispatch_groups=2)), 2),
)


def _cfg(arch, kw):
    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = MoEConfig(**kw["moe"])
    return reduced(get_config(arch), **kw)


def _layout(data, model):
    return tmesh.Mesh(data=data, model=model, rank=0, world_group=None,
                      data_group=None, model_group=None)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _flat(tree):
    return np.concatenate([np.asarray(x).reshape(-1).astype(np.float32)
                           for x in pytree_leaves(tree)])


def _wide_pools(calibrated):
    """The calibrated codecs with a pool slot for every chunk: the wire,
    not the fallback, is under test."""
    reg = CodecRegistry()
    for name in calibrated.names():
        e = calibrated[name]
        reg.register_tables(name, e.tables, dataclasses.replace(
            e.plan, pool_slots_per_1k=1024), counts=e.counts)
    return reg


# --------------------------------------------------------------------------
# Specs, the cut, the local init
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shard_and_gather_round_trip(arch):
    """``shard_params`` cuts every leaf of the MoE and recurrent configs
    to the contiguous block of its resolved spec on model axes of 2 and
    4 (tensors and numpy alike), and ``gather_params`` puts the whole
    tree back bit for bit."""
    cfg = _cfg(arch, ARCHS[arch])
    p = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    for model in (2, 4):
        specs = sharding.param_pspecs(cfg, _layout(1, model))
        parts = [shard_params(p, cfg, m, model) for m in range(model)]
        n_split = 0
        for leaf, part, spec in zip(pytree_leaves(p),
                                    pytree_leaves(parts[1]),
                                    pytree_leaves(specs)):
            dim = sharding.model_dim(spec)
            if dim is None:
                assert part is leaf
            else:
                n = leaf.shape[dim] // model
                assert torch.equal(part, leaf.narrow(dim, n, n))
                n_split += 1
        assert n_split >= len(pytree_leaves(p)) // 2
        for a, b in zip(pytree_leaves(gather_params(parts, cfg)),
                        pytree_leaves(p)):
            assert torch.equal(a, b)
        np_parts = [shard_params(_numpy_tree(p), cfg, m, model)
                    for m in range(model)]
        for a, b in zip(pytree_leaves(gather_params(np_parts, cfg)),
                        pytree_leaves(p)):
            np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_local_init_equals_init_then_cut(arch):
    """``init_local_params`` draws each leaf and keeps the rank's block
    at once: bit-equal to the whole init cut by ``shard_params``, on
    every rank of model axes of 2 and 4."""
    cfg = _cfg(arch, ARCHS[arch])
    whole = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for model in (2, 4):
        for m in range(model):
            local = init_local_params(cfg, torch.Generator().manual_seed(3),
                                      "cpu", m, model)
            want = shard_params(whole, cfg, m, model)
            assert flat_tree(local).keys() == flat_tree(want).keys()
            for a, b in zip(pytree_leaves(local), pytree_leaves(want)):
                np.testing.assert_array_equal(tree_bits(a), tree_bits(b))


def test_expert_to_mlp_fallback():
    """Three experts on a model axis of 2: the ``expert`` dim does not
    divide, so the experts' ``mlp`` dim is split and the router stays
    whole (first dim that divides wins); four experts split by experts,
    the router by its expert columns."""
    def specs(kw):
        return flat_tree(sharding.param_pspecs(
            _cfg("deepseek-moe-16b", kw), _layout(1, 2)))
    three = specs(THREE)
    ffn = "groups/l0/ffn"
    assert three[f"{ffn}/router"] == (None, None, None)
    assert three[f"{ffn}/w_in"] == (None, None, None, "model")
    assert three[f"{ffn}/w_out"] == (None, None, "model", None)
    assert three[f"{ffn}/shared/w_in"] == (None, None, "model")
    four = specs(F32)
    assert four[f"{ffn}/router"] == (None, None, "model")
    assert four[f"{ffn}/w_in"] == (None, "model", None, None)
    ssm = flat_tree(sharding.param_pspecs(
        _cfg("jamba-1.5-large-398b", ARCHS["jamba-1.5-large-398b"]),
        _layout(2, 2)))
    assert ssm["groups/l1/mixer/in_proj"] == (None, None, "model")
    assert ssm["groups/l1/mixer/x_proj"] == (None, "model", None)
    assert ssm["groups/l1/mixer/A_log"] == (None, "model", None)


def test_refusals_that_remain():
    """``shardmap_a2a`` with experts that do not divide the model axis
    raises ``ValueError`` (the reference's message), as without a mesh;
    pods and the hierarchical wire stay unported (item 13)."""
    cfg = _cfg("deepseek-moe-16b", A2A)
    opt_cfg = topt.OptConfig()
    with pytest.raises(ValueError, match=r"num_experts \(4\) divisible by "
                                         r"the model axis \(3\)"):
        make_compressed_step(cfg, opt_cfg, TrainConfig(), None, None,
                             mesh=_layout(1, 3))
    with pytest.raises(ValueError, match="'model' axis"):
        make_compressed_step(cfg, opt_cfg, TrainConfig(), None, None)
    with pytest.raises(NotImplementedError, match="item 13"):
        make_compressed_step(cfg, opt_cfg, TrainConfig(), None, None,
                             hierarchical_wire=True, mesh=_layout(2, 2))
    with pytest.raises(NotImplementedError, match="item 13"):
        tmesh.make_test_mesh(pods=2)


# --------------------------------------------------------------------------
# The runs: the reference's 2 x 2 step beside the port's worlds
# --------------------------------------------------------------------------

REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.comm import CommConfig
from repro.configs import get_config, reduced
from repro.core import CodecRegistry
from repro.data import DataConfig, SyntheticDataset
from repro.parallel import sharding as shd
from repro.training import (TrainConfig, init_compressed_opt_state,
                            make_compressed_step)
from repro.training import optimizer as jopt
from repro.training.train_step import flat_geometry
args = pickle.load(open({path!r}, "rb"))
arch = {arch!r}
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
t = args["train"]
opt_cfg = jopt.OptConfig(lr=t["lr"], total_steps=t["steps"],
                         warmup_steps=max(10, t["steps"] // 20))
case = args["cases"][arch]
cfg = reduced(get_config(arch), **case["cfg_kw"])
reg = CodecRegistry.from_json(case["registry_json"])
g = flat_geometry(cfg, mesh, TrainConfig(),
                  CommConfig(chunk_symbols=case["chunk"]))
data = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=t["seq_len"],
                                   global_batch=t["global_batch"]))
params = jax.tree.map(jnp.asarray, case["params"])
with shd.use_mesh(mesh):
    step = jax.jit(make_compressed_step(cfg, opt_cfg, TrainConfig(), mesh,
                                        reg))
    o = init_compressed_opt_state(cfg, mesh, TrainConfig(), reg, opt_cfg)
    losses, oks = [], []
    for s in range(t["steps"]):
        batch = {{k: jnp.asarray(v) for k, v in data.batch_at(s).items()}}
        params, o, m = step(params, o, batch)
        losses.append(float(m["loss"]))
        oks.append(bool(m["ok"]))
out = dict(geometry=(int(g[0]), int(g[1]), int(g[2]), np.asarray(g[3])),
           losses=losses, oks=oks, params=jax.tree.map(np.asarray, params),
           state=jax.tree.map(np.asarray, o))
pickle.dump(out, open({path!r} + "." + arch, "wb"))
"""


@pytest.fixture(scope="module")
def setup():
    """Per config: its whole initial tree (numpy, seed 0) and a registry
    the port calibrated with a pool slot for every chunk; the same for
    ``shardmap_a2a`` with the expert wire's two codecs."""
    out = {}
    for arch, kw in dict(ARCHS, a2a=A2A).items():
        cfg = _cfg("deepseek-moe-16b" if arch == "a2a" else arch, kw)
        p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        cal = train(cfg, comm="qlc", steps=0, seq_len=TRAIN["seq_len"],
                    global_batch=TRAIN["global_batch"], device="cpu",
                    params=p, moe_wire="qlc" if arch == "a2a" else "auto")
        out[arch] = (cfg, _numpy_tree(p), _wide_pools(cal["registry"]))
    return out


def _case(name, arch, cfg_kw, model, runs, params=None, registry=None,
          routing=False):
    return dict(name=name, arch=arch, cfg_kw=cfg_kw, model=model,
                params=params, runs=runs, routing=routing,
                registry_json=None if registry is None
                else registry.to_json(), train_kw=TRAIN)


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The reference's subprocesses (one a config), the world of 4 ranks
    (each config's compressed step at 2 x 2, QLC and twin;
    ``shardmap_a2a`` at 2 x 2 on the raw expert wire, the QLC one and
    its twin; the 1 x 4 baseline cases) and the world of 2 (the 1 x 2
    baseline cases), all at once."""
    path = str(tmp_path_factory.mktemp("tp_blocks") / "args.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(train=TRAIN, cases={
            arch: dict(cfg_kw=ARCHS[arch], params=setup[arch][1],
                       registry_json=setup[arch][2].to_json(),
                       chunk=setup[arch][2]["grads"].config().chunk_symbols)
            for arch in ARCHS}), f)
    four = [_case(arch, arch, ARCHS[arch], 2,
                  [("qlc", "qlc", True), ("twin", "qlc", False)],
                  params=setup[arch][1], registry=setup[arch][2],
                  routing=arch in MOE_ARCHS) for arch in ARCHS]
    four.append(_case("a2a", "deepseek-moe-16b", A2A, 2, [
        ("raw", "qlc", True, {"moe_wire": "raw"}),
        ("wire", "qlc", True, {"moe_wire": "qlc"}),
        ("wire_twin", "qlc", False, {"moe_wire": "qlc"})],
        params=setup["a2a"][1], registry=setup["a2a"][2], routing=True))
    base = {n: _case(n, arch, kw, model, [("base", "baseline", True)])
            for n, arch, kw, model in BASELINE}
    four += [base[n] for n, *_, model in BASELINE if model == 4]
    two = [base[n] for n, *_, model in BASELINE if model == 2]
    with concurrent.futures.ThreadPoolExecutor(len(ARCHS) + 2) as pool:
        refs = [pool.submit(run_md, REFERENCE.format(path=path, arch=arch),
                            n_devices=4, timeout=600) for arch in ARCHS]
        w4 = pool.submit(run_ranks, "tp_layouts", 4, cases=four)
        w2 = pool.submit(run_ranks, "tp_layouts", 2, cases=two)
        for r in refs:
            r.result()
        out = {"world4": w4.result(), "world2": w2.result(),
               "reference": {}}
    for arch in ARCHS:
        with open(f"{path}.{arch}", "rb") as f:
            out["reference"][arch] = pickle.load(f)
    return out


def _rank_runs(runs, case, run, world="world4"):
    return [r[case][run] for r in runs[world]]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_flat_geometry_matches_reference(runs, setup, arch):
    """``(n_local, n_padded, seg, weight_vec)`` of a model rank's flat
    vector on 2 x 2 equal the reference's ``flat_geometry``, exactly."""
    cfg, _, reg = setup[arch]
    local = shard_params(init_params(cfg, None, "meta"), cfg, 0, 2)
    g = flat_geometry(local, 2, reg["grads"].config(), cfg, _layout(2, 2))
    n_local, n_padded, seg, w = runs["reference"][arch]["geometry"]
    assert (g.n_local, g.n_padded, g.seg) == (n_local, n_padded, seg)
    np.testing.assert_array_equal(weight_vec(g), w)


def _state_close(got, want, rtol):
    """The fraction of ZeRO-1 state entries within ``rtol`` / atol 1e-6
    of the largest, a wire block of 32 most of whose entries are off (its
    scale rounded the other way) counting as one entry. Segments start
    at multiples of the chunk, so the blocks are the wire's."""
    bad = ~np.isclose(got, want, rtol=rtol, atol=1e-6 * np.abs(want).max())
    blocks = bad[:bad.size // 32 * 32].reshape(-1, 32)
    moved = blocks.sum(1) > 16
    n_bad = bad.sum() - blocks[moved].sum() + moved.sum()
    return 1.0 - n_bad / bad.size


def _reference_routing(x, router, cfg):
    """The reference's routing and drops of one MoE layer on ``x`` [B, S,
    D], with ``x``'s tokens as the batch."""
    m = cfg.moe
    xf = jnp.asarray(x).reshape(-1, cfg.d_model)
    idx, _, _ = jmoe._route({"router": jnp.asarray(router)}, xf, m)
    pos = jmoe._positions_in_expert(idx.reshape(-1), m.num_experts)
    return np.asarray(idx), np.asarray(pos < jmoe._capacity(xf.shape[0], m))


def _routers(params, cfg):
    """Each MoE layer's whole router in layer order (group, then block)."""
    kinds = cfg.layer_kinds()
    groups = params["groups"]
    n_groups = cfg.num_layers // len(kinds)
    return [groups[f"l{i}"]["ffn"]["router"][g] for g in range(n_groups)
            for i in range(len(kinds)) if cfg.ffn_kind(i) == "moe"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_compressed_2x2_matches_reference(runs, setup, arch):
    """Two compressed steps at 2 x 2 against the reference's on a (2, 2)
    mesh from the same tree, batches and registry. Routing first: each
    MoE layer's experts and drops on the first batch, on every rank,
    equal the reference's ``_route`` on that layer's input; then every
    ``ok``, the losses, each rank's flat vector against the reference's
    cut for its model index, and each rank's ZeRO-1 state against the
    ``[d, m]`` row of the reference's."""
    cfg, p0, _ = setup[arch]
    ref = runs["reference"][arch]
    if arch in MOE_ARCHS:
        routers = _routers(p0, cfg)
        for layers in _rank_runs(runs, arch, "qlc/routing"):
            assert len(layers) == len(routers) > 0
            for (idx, keep, x), router in zip(layers, routers):
                want_idx, want_keep = _reference_routing(x, router, cfg)
                np.testing.assert_array_equal(idx, want_idx)
                np.testing.assert_array_equal(keep, want_keep)
    assert ref["oks"] == [True, True]
    rank_runs = _rank_runs(runs, arch, "qlc")
    for rank, (losses, oks, fallbacks, local, state) in enumerate(rank_runs):
        assert all(oks) and fallbacks == 0
        np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
        want = _flat(shard_params(ref["params"], cfg, rank % 2, 2))
        assert (want == _flat(local)).mean() >= 0.999, rank
        conv = flat_opt_state_from_numpy(ref["state"], rank, "cpu")
        assert int(conv["step"]) == 2
        for k in ("m", "v"):
            frac = _state_close(state[k], conv[k].numpy(),
                                STATE_RTOL.get(arch, 1e-5))
            assert frac >= 0.999, (rank, k, frac)


@pytest.mark.parametrize("arch", sorted(ARCHS) + ["a2a"])
def test_compressed_2x2_equals_raw_twin(runs, arch):
    """The QLC wire and its raw e4m3 twin give the same losses, local
    trees and states, bit for bit, on every rank: the gradient and
    parameter wires, and for ``shardmap_a2a`` the expert wire too."""
    qlc, twin = ("wire", "wire_twin") if arch == "a2a" else ("qlc", "twin")
    for a, b in zip(_rank_runs(runs, arch, qlc), _rank_runs(runs, arch, twin)):
        assert a[0] == b[0] and all(a[1]) and a[2] == 0
        np.testing.assert_array_equal(tree_bits(_flat(a[3])),
                                      tree_bits(_flat(b[3])))
        for k in ("m", "v"):
            np.testing.assert_array_equal(tree_bits(a[4][k]),
                                          tree_bits(b[4][k]))


#: split leaves that start alike on every channel (mamba's)
ALIKE = ("mixer/A_log", "mixer/D")


def _check_rows(locals_by_rank, cfg, model):
    """Leaves that the model axis does not split are bit-identical over
    each model row; split leaves differ between its ranks (but for
    :data:`ALIKE`, whose blocks the parameter wire's e4m3 may keep
    alike)."""
    specs = flat_tree(sharding.param_pspecs(cfg, _layout(1, model)))
    for start in range(0, len(locals_by_rank), model):
        row = [flat_tree(t) for t in locals_by_rank[start:start + model]]
        for key, spec in specs.items():
            if sharding.model_dim(spec) is None:
                for other in row[1:]:
                    np.testing.assert_array_equal(
                        tree_bits(row[0][key]), tree_bits(other[key]),
                        err_msg=key)
            elif not key.endswith(ALIKE):
                assert not np.array_equal(row[0][key], row[1][key]), key


def test_replicated_leaves_stay_identical_over_model_rows(runs, setup):
    """After 2 steps, every leaf that the specs keep whole (the norms,
    the router of three experts on a row of 2) holds the same bits on
    every rank of a model row: the 2 x 2 compressed runs,
    ``shardmap_a2a``'s, and the baseline cases."""
    for arch in ARCHS:
        for run in ("qlc", "twin"):
            _check_rows([r[3] for r in _rank_runs(runs, arch, run)],
                        setup[arch][0], 2)
    for run in ("raw", "wire"):
        _check_rows([r[3] for r in _rank_runs(runs, "a2a", run)],
                    setup["a2a"][0], 2)
    for name, arch, kw, model in BASELINE:
        world = "world4" if model == 4 else "world2"
        _check_rows([r[3] for r in _rank_runs(runs, name, "base", world)],
                    _cfg(arch, kw), model)


def _tracks(a, b, what):
    close = np.isclose(a, b, rtol=1e-5, atol=1e-6)
    assert close.mean() >= 0.999, (what, (~close).sum())
    assert np.abs(a - b).max() <= 2 * TRAIN["lr"] * TRAIN["steps"], what


@pytest.mark.parametrize("case", BASELINE, ids=[c[0] for c in BASELINE])
def test_baseline_tracks_one_rank(runs, case):
    """The baseline step over a model row (1 x 4: deepseek-moe's experts
    one a rank, xlstm's heads one a rank; 1 x 2: jamba's attention,
    dense FFN, mamba and MoE blocks, three experts split by their mlp
    dim, ``grouped_local``) against the port's step on one rank, 2 steps
    from the seed's tree."""
    name, arch, kw, model = case
    cfg = _cfg(arch, kw)
    one = train(cfg, comm="baseline", device="cpu", **TRAIN)
    world = "world4" if model == 4 else "world2"
    rank_runs = _rank_runs(runs, name, "base", world)
    for losses, *_ in rank_runs:
        np.testing.assert_allclose(
            losses, [h["loss"] for h in one["history"]], rtol=1e-5)
    whole = gather_params([r[3] for r in rank_runs[:model]], cfg)
    _tracks(_flat(whole), _flat(one["params"]), name)


def test_shardmap_a2a_matches_gspmd_on_2x2(runs, setup):
    """``shardmap_a2a`` at 2 x 2 (tokens cut over the row, experts split
    over it, the router gathered) against ``gspmd`` on the same layout
    from the same tree: on the first batch each layer's pieces, put back
    in row order, route and drop exactly as ``gspmd``'s data shard; after
    2 compressed steps the losses and the parameters track it. The
    capacity of both is the data shard's."""
    g_routing = _rank_runs(runs, "deepseek-moe-16b", "qlc/routing")
    a_routing = _rank_runs(runs, "a2a", "raw/routing")
    for start in (0, 2):
        for layer, want in enumerate(g_routing[start]):
            idx = np.concatenate([a_routing[r][layer][0]
                                  for r in (start, start + 1)])
            keep = np.concatenate([a_routing[r][layer][1]
                                   for r in (start, start + 1)])
            np.testing.assert_array_equal(idx, want[0])
            np.testing.assert_array_equal(keep, want[1])
    g_runs = _rank_runs(runs, "deepseek-moe-16b", "qlc")
    a_runs = _rank_runs(runs, "a2a", "raw")
    cfg = setup["a2a"][0]
    for g, a in zip(g_runs, a_runs):
        assert all(a[1]) and a[2] == 0
        np.testing.assert_allclose(a[0], g[0], rtol=1e-5)
    whole = [gather_params([r[3] for r in rr[:2]], cfg)
             for rr in (a_runs, g_runs)]
    _tracks(_flat(whole[0]), _flat(whole[1]), "a2a vs gspmd")


def test_shardmap_a2a_expert_wire_moves_qlc(runs, setup):
    """The expert wire's QLC run at 2 x 2 moves lossy e4m3 values (it
    differs from the raw expert wire) and stays finite; its twin equality
    is ``test_compressed_2x2_equals_raw_twin[a2a]``."""
    for raw, wire in zip(_rank_runs(runs, "a2a", "raw"),
                         _rank_runs(runs, "a2a", "wire")):
        assert np.isfinite(wire[0]).all()
        assert not np.array_equal(_flat(raw[3]), _flat(wire[3]))
