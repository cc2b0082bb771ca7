"""Port parity, tensor-parallel slice: the sharding rules and every
leaf's resolved spec, the flat ZeRO-1 geometry of a model rank, the
compressed step over a 2 x 2 ``data x model`` layout, the
tensor-parallel baseline step, and checkpoints of both read by the
other package, against the JAX reference or the port's own one-rank
step.

Reduced configs at f32 on gloo CPU ranks (``tests/torch_dist``): one
world of 2 ranks (the 1 x 2 cases) and one of 4 (2 x 2 and 1 x 4),
each reused across its cases; the reference's 2 x 2 step runs in one
subprocess with 4 fake CPU devices (``tests/md_util``). Stated
tolerances and why:

* specs, geometry, the cut and its inverse: exact;
* the 2 x 2 compressed step against the reference's: losses to rtol
  1e-5, each rank's flat parameter vector equal on at least 99.9 % of
  entries (the two frameworks' gradients differ in their last bits, so
  an e4m3 code may round the other way), the ``[data, model, seg]``
  state converted to each rank's equal to rtol 1e-5 / atol 1e-6 of its
  largest entry on at least 99.9 % of entries: the clip scales every
  moment by ``1 / norm``, and the two global norms differ by a few f32
  ulps (the port sums the squares in f64, the reference in f32; at 1 x
  1 alike), so the moments carry that relative difference (about 6e-7
  here) and do not match bit for bit, as the parameters, which Adam's
  normalized step leaves untouched by it, do; where the second step's
  gradient cancels the first's momentum the difference grows relative
  to the entry, and an e4m3 code that rounds the other way moves one by
  up to 1/8;
* the QLC wire against its raw e4m3 twin, and the replicated leaves
  over each model row: bit for bit;
* checkpoints across the packages, bit for bit: the port's 2 x 2
  compressed state (written by all 4 ranks) in the reference's
  ``restore``, and the reference's 2 x 2 compressed and (2, 1) baseline
  states restored by port ranks at 2 x 2 (and 1 x 2); the reference's
  subprocess and the worlds wait for each other's files;
* the tensor-parallel baseline step against the one-rank step: losses
  to rtol 1e-5; parameters to rtol 1e-5 / atol 1e-6 on at least 99.9 %
  of entries and every entry within 2 x lr x steps. The split matmuls
  sum in another order, and AdamW's normalized update turns the
  last-bit differences of a near-zero gradient entry (a sum that
  cancels) into a difference of a sizeable part of lr: one entry in
  ~10^4 in these runs.
"""
import concurrent.futures
import dataclasses
import os
import pickle
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import reduced as jreduced
from repro.models import init_params as jinit_params
from repro.models import param_specs as jparam_specs
from repro.parallel import sharding as jshd
from repro_torch.configs import REGISTRY, get_config, reduced
from repro_torch.convert import (flat_opt_state_from_numpy, gather_params,
                                 shard_params)
from repro_torch.core import CodecRegistry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.train import train
from repro_torch.models import init_params
from repro_torch.models.transformer import param_specs, pytree_leaves
from repro_torch.parallel import sharding
from repro_torch.training import TrainConfig, make_compressed_step
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import flat_geometry, weight_vec
from tests.md_util import run_md
from tests.torch_dist import flat_tree, run_ranks, tree_bits
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

F32 = dict(dtype="float32")
LAYOUTS = ((1, 2), (2, 2), (1, 4), (16, 16))
DENSE = ("phi3-mini-3.8b", "phi-3-vision-4.2b", "chatglm3-6b",
         "deepseek-coder-33b", "gemma-2b-sft", "nemotron-4-340b",
         "musicgen-medium")
TRAIN = dict(steps=2, seq_len=32, global_batch=8, lr=3e-4)
#: the 1 x 2 baseline cases: (name, arch, config overrides, seq_len)
BASE_1X2 = (
    ("swiglu", "phi3-mini-3.8b", F32, 32),
    ("gelu", "musicgen-medium", F32, 40),
    ("squared_relu", "nemotron-4-340b", F32, 32),
    ("padded_heads", "phi3-mini-3.8b", dict(F32, pad_heads_multiple=3), 32),
    ("sliding_window", "phi3-mini-3.8b",
     dict(F32, sliding_window=8, attn_q_block=8, attn_kv_block=8), 32),
)
#: the 1 x 4 baseline case: 4 query heads split, 2 KV heads whole
BASE_1X4 = ("kv_whole", "chatglm3-6b", F32, 32)


def _layout(data, model):
    return tmesh.Mesh(data=data, model=model, rank=0, world_group=None,
                      data_group=None, model_group=None)


def _spec_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _spec_leaves(tree[key],
                                         f"{prefix}/{key}").items()}
    return {prefix: tuple(tree)}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _flat(tree):
    return np.concatenate([np.asarray(x).reshape(-1).astype(np.float32)
                           for x in pytree_leaves(tree)])


# --------------------------------------------------------------------------
# Specs, geometry, the cut
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_specs_match_reference(arch):
    """Every leaf's logical axes, global shape and resolved spec (default
    rules without overrides, as the compressed step resolves them; and
    ``make_rules()``'s FSDP overrides) equal the reference's, full size
    and reduced, on 1 x 2, 2 x 2, 1 x 4 and 16 x 16. The reference's
    ``_resolve`` reads only ``axis_names`` and ``shape``."""
    for full in (True, False):
        jc = JREGISTRY[arch] if full else jreduced(JREGISTRY[arch])
        tc = REGISTRY[arch] if full else reduced(REGISTRY[arch])
        jspecs = _spec_leaves(jparam_specs(jc))
        assert _spec_leaves(param_specs(tc)) == jspecs
        jshapes = flat_tree(jax.eval_shape(
            lambda k: jinit_params(jc, k), jax.random.PRNGKey(0)))
        shapes = sharding.param_shapes(tc)
        assert {f"/{k}": tuple(v.shape) for k, v in jshapes.items()} == \
            {f"/{k}": v for k, v in flat_tree(shapes).items()}
        for data, model in LAYOUTS:
            stand_in = types.SimpleNamespace(
                axis_names=("data", "model"),
                shape={"data": data, "model": model})
            got = _spec_leaves(sharding.param_pspecs(tc, _layout(data,
                                                                  model)))
            rules = (jshd.ShardingRules(dict(jshd.DEFAULT_RULES)),
                     jshd.make_rules())
            trules = (sharding.get_rules(), sharding.make_rules())
            for jr, tr, param in zip(rules, trules, (False, True)):
                for key, spec in jspecs.items():
                    shape = tuple(jshapes[key[1:]].shape)
                    used = set()
                    want = tuple(jr._resolve(n, d, stand_in, param, used)
                                 for n, d in zip(spec, shape))
                    mine = tr.spec(spec, shape=shape, param=param,
                                   mesh=_layout(data, model))
                    assert mine == want, (arch, full, data, model, key)
                    if not param:
                        assert got[key] == want


def test_divisibility_fallbacks():
    """The reference's examples: deepseek-coder's 56 heads stay whole on
    a 16-way model axis, chatglm3's 2 KV heads stay whole while its 32
    heads split 4 ways, phi3's vocab of 32064 splits 2, 4 and 16 ways."""
    def spec(arch, key, model):
        return _spec_leaves(sharding.param_pspecs(
            REGISTRY[arch], _layout(1, model)))[key]
    assert spec("deepseek-coder-33b", "/groups/l0/mixer/wq", 16) == \
        (None, None, None, None)
    assert spec("chatglm3-6b", "/groups/l0/mixer/wq", 4) == \
        (None, None, "model", None)
    assert spec("chatglm3-6b", "/groups/l0/mixer/wk", 4) == \
        (None, None, None, None)
    for m in (2, 4, 16):
        assert spec("phi3-mini-3.8b", "/head", m) == (None, "model")
        assert spec("phi3-mini-3.8b", "/embed", m) == ("model", None)


@pytest.mark.parametrize("arch", DENSE)
def test_shard_and_gather_round_trip(arch):
    """``shard_params`` cuts each leaf to the contiguous block of its
    spec, tensors and numpy alike, and ``gather_params`` puts the whole
    tree back bit for bit; a whole leaf is shared, not copied."""
    cfg = reduced(REGISTRY[arch], **F32)
    p = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    for model in (2, 4):
        specs = sharding.param_pspecs(cfg, _layout(1, model))
        parts = [shard_params(p, cfg, m, model) for m in range(model)]
        for leaf, part, spec in zip(pytree_leaves(p),
                                    pytree_leaves(parts[1]),
                                    pytree_leaves(specs)):
            dim = sharding.model_dim(spec)
            if dim is None:
                assert part is leaf
            else:
                n = leaf.shape[dim] // model
                assert torch.equal(part, leaf.narrow(dim, n, n))
        back = gather_params(parts, cfg)
        for a, b in zip(pytree_leaves(back), pytree_leaves(p)):
            assert torch.equal(a, b)
        np_parts = [shard_params(_numpy_tree(p), cfg, m, model)
                    for m in range(model)]
        for a, b in zip(pytree_leaves(np_parts[model - 1]),
                        pytree_leaves(parts[model - 1])):
            np.testing.assert_array_equal(a, b.numpy())
        for a, b in zip(pytree_leaves(gather_params(np_parts, cfg)),
                        pytree_leaves(p)):
            np.testing.assert_array_equal(a, b.numpy())
    assert shard_params(p, cfg, 0, 1) is p


def test_moe_and_ssm_keep_their_layout():
    """MoE and recurrent configs take the layout of their resolved specs
    like the dense ones (ROADMAP queue 1, item 15): ``shard_params`` cuts
    them (``tests/test_torch_tp_blocks.py`` trains them), a model row
    reaches their layers whatever the config, and what is still refused
    is the pods' hierarchical wire (item 13) and ``shardmap_a2a`` with
    experts that do not divide the model axis (``ValueError``, as the
    reference's ``shardmap_a2a_geometry``)."""
    for arch in ("deepseek-moe-16b", "xlstm-125m", "jamba-1.5-large-398b"):
        cfg = reduced(REGISTRY[arch])
        meta = init_params(cfg, None, "meta")
        cut = shard_params(meta, cfg, 1, 2)
        assert sum(a.shape != b.shape for a, b in zip(
            pytree_leaves(cut), pytree_leaves(meta))) >= 4
        with pytest.raises(NotImplementedError, match="item 13"):
            make_compressed_step(cfg, topt.OptConfig(), TrainConfig(), None,
                                 None, mesh=_layout(1, 2),
                                 hierarchical_wire=True)
    ep = reduced(REGISTRY["deepseek-moe-16b"])
    ep = dataclasses.replace(ep, moe=dataclasses.replace(
        ep.moe, impl="shardmap_a2a"))
    with pytest.raises(ValueError, match="divisible by the model axis"):
        make_compressed_step(ep, topt.OptConfig(), TrainConfig(), None,
                             None, mesh=_layout(1, 3))
    assert tmesh.model_row(_layout(2, 1)) is None
    assert tmesh.model_row(_layout(1, 2)).size == 2
    x = torch.ones(3)
    for fn in (tmesh.copy_to_model, tmesh.reduce_from_model):
        assert fn(x, None) is x
    assert tmesh.gather_from_model(x, 0, None) is x


# --------------------------------------------------------------------------
# The reference's 2 x 2 compressed step (one subprocess, 4 fake devices)
# --------------------------------------------------------------------------

REFERENCE = """
import os, pickle, time
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.checkpoint import CheckpointManager
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
devs = np.array(jax.devices()[:4])
out = {{"geometry": {{}}}}
for arch in args["geometry"]:
    cfg = reduced(get_config(arch), **args["cfg_kw"])
    for shape in ((2, 2), (1, 4)):
        mesh = Mesh(devs.reshape(shape), ("data", "model"))
        g = flat_geometry(cfg, mesh, TrainConfig(),
                          CommConfig(chunk_symbols=args["chunk"]))
        out["geometry"][arch, shape] = (int(g[0]), int(g[1]), int(g[2]),
                                        np.asarray(g[3]))
cfg = reduced(get_config(args["arch"]), **args["cfg_kw"])
mesh = Mesh(devs.reshape(2, 2), ("data", "model"))
reg = CodecRegistry.from_json(args["registry_json"])
t = args["train"]
opt_cfg = jopt.OptConfig(lr=t["lr"], total_steps=t["steps"],
                         warmup_steps=max(10, t["steps"] // 20))
data = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=t["seq_len"],
                                   global_batch=t["global_batch"]))
params = jax.tree.map(jnp.asarray, args["params"])
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
out["losses"], out["oks"] = losses, oks
out["params"] = jax.tree.map(np.asarray, params)
out["state"] = jax.tree.map(np.asarray, o)
CheckpointManager(args["ref_comp"]).save(t["steps"], (params, o),
                                         extra={{"step": t["steps"]}})
# the port's 2 x 2 checkpoint, once its world has written it
end = time.monotonic() + 240
while not os.path.exists(os.path.join(args["port_comp"], "latest")):
    assert time.monotonic() < end, "the port's checkpoint did not appear"
    time.sleep(0.2)
got, extra = CheckpointManager(args["port_comp"]).restore((params, o))
out["port_restored"] = (jax.tree.map(np.asarray, got), extra)
pickle.dump(out, open({path!r} + ".out", "wb"))
"""


#: the reference's baseline step on a (2, 1) mesh, one step from the same
#: tree, checkpointed (a subprocess of its own, beside ``REFERENCE``)
REFERENCE_BASE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.checkpoint import CheckpointManager
from repro.configs import get_config, reduced
from repro.data import DataConfig, SyntheticDataset
from repro.parallel import sharding as shd
from repro.training import TrainConfig, make_baseline_step
from repro.training import optimizer as jopt
args = pickle.load(open({path!r}, "rb"))
cfg = reduced(get_config(args["arch"]), **args["cfg_kw"])
t = args["train"]
opt_cfg = jopt.OptConfig(lr=t["lr"], total_steps=t["steps"],
                         warmup_steps=max(10, t["steps"] // 20))
data = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=t["seq_len"],
                                   global_batch=t["global_batch"]))
devs = np.array(jax.devices()[:2])
with shd.use_mesh(Mesh(devs.reshape(2, 1), ("data", "model"))):
    step = jax.jit(make_baseline_step(cfg, opt_cfg, TrainConfig()))
    p0 = jax.tree.map(jnp.asarray, args["params"])
    batch = {{k: jnp.asarray(v) for k, v in data.batch_at(0).items()}}
    bp, bo, _ = step(p0, jopt.init_state(p0, opt_cfg), batch)
CheckpointManager(args["ref_base"]).save(1, (bp, bo), extra={{"step": 1}})
pickle.dump(jax.tree.map(np.asarray, (bp, bo)),
            open({path!r} + ".base", "wb"))
"""


@pytest.fixture(scope="module")
def gemma():
    """Reduced gemma (4 query heads, 1 KV head: the query heads split
    over a model axis of 2, the KV head whole), its whole initial tree
    as numpy, and a registry calibrated by the port with a pool slot for
    every chunk (the wire, not the fallback, is under test)."""
    cfg = reduced(get_config("gemma-2b-sft"), **F32)
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cal = train(cfg, comm="qlc", steps=0, seq_len=TRAIN["seq_len"],
                global_batch=TRAIN["global_batch"], device="cpu",
                params=p)["registry"]
    reg = CodecRegistry()
    for name in ("grads", "params"):
        e = cal[name]
        reg.register_tables(name, e.tables, dataclasses.replace(
            e.plan, pool_slots_per_1k=1024), counts=e.counts)
    return cfg, _numpy_tree(p), reg


def _case(name, arch, cfg_kw, model, runs, params=None, registry=None,
          **train_kw):
    return dict(name=name, arch=arch, cfg_kw=cfg_kw, model=model,
                params=params, runs=runs,
                registry_json=None if registry is None
                else registry.to_json(), train_kw=dict(TRAIN, **train_kw))


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """Checkpoint directories the reference and the port write and read
    each other's from: the reference's compressed 2 x 2 state
    (``ref_comp``) and baseline (2, 1) state (``ref_base``), the port's
    compressed 2 x 2 state (``port_comp``)."""
    root = tmp_path_factory.mktemp("tp_ckpt")
    return {k: str(root / k) for k in ("ref_comp", "ref_base", "port_comp")}


def _restore_case(name, model, comm, ckpt, p, reg, steps):
    """A launch that resumes from the checkpoint in ``ckpt`` (once it is
    written) at its last step, so it runs no step."""
    return _case(name, "gemma-2b-sft", F32, model, [
        ("restored", comm, True, dict(checkpoint_dir=ckpt, wait_for=(
            os.path.join(ckpt, "latest"))))], params=p, registry=reg,
        steps=steps)


@pytest.fixture(scope="module")
def two_by_two(gemma, ckpt_dirs, tmp_path_factory):
    """The reference's runs (two subprocesses in threads) beside one
    world of 4 gloo ranks: reduced gemma's compressed step at 2 x 2 (QLC,
    which checkpoints into ``port_comp``, and its raw e4m3 twin) and
    chatglm3's baseline step at 1 x 4; then the reference's two
    checkpoints restored at 2 x 2, while the reference restores the
    port's."""
    cfg, p, reg = gemma
    path = str(tmp_path_factory.mktemp("tp") / "args.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(geometry=("phi3-mini-3.8b", "gemma-2b-sft",
                                   "musicgen-medium"),
                         cfg_kw=F32, chunk=reg["grads"].config()
                         .chunk_symbols, arch="gemma-2b-sft",
                         registry_json=reg.to_json(), train=TRAIN,
                         params=p, **ckpt_dirs), f)
    name, arch, kw, seq = BASE_1X4
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ref = pool.submit(run_md, REFERENCE.format(path=path), n_devices=4,
                          timeout=300)
        ref_base = pool.submit(run_md, REFERENCE_BASE.format(path=path),
                               n_devices=2, timeout=300)
        world = run_ranks("tp_layouts", 4, cases=[
            _case("gemma", "gemma-2b-sft", F32, 2,
                  [("qlc", "qlc", True,
                    dict(checkpoint_dir=ckpt_dirs["port_comp"])),
                   ("twin", "qlc", False)], params=p, registry=reg),
            _case(name, arch, kw, 4, [("base", "baseline", True)],
                  seq_len=seq),
            _restore_case("ref_comp", 2, "qlc", ckpt_dirs["ref_comp"], p,
                          reg, TRAIN["steps"]),
            _restore_case("ref_base", 2, "baseline", ckpt_dirs["ref_base"],
                          p, None, 1)])
        ref.result()
        ref_base.result()
    with open(path + ".out", "rb") as f:
        out = pickle.load(f)
    with open(path + ".base", "rb") as f:
        out["base"] = pickle.load(f)
    return out, world


@pytest.fixture(scope="module")
def reference(two_by_two):
    return two_by_two[0]


@pytest.fixture(scope="module")
def world4(two_by_two):
    return two_by_two[1]


@pytest.fixture(scope="module")
def world2(gemma, reference, ckpt_dirs, tmp_path_factory):
    """One world of 2 gloo ranks: the 1 x 2 baseline cases, reduced
    gemma's compressed step at 1 x 2 for 3 steps checkpointing into one
    directory, resumed from step 2, and the reference's baseline (2, 1)
    checkpoint restored at 1 x 2."""
    _, p, reg = gemma
    resume = _case("resume", "gemma-2b-sft", F32, 2,
                   [("qlc", "qlc", True)], params=p, registry=reg, steps=3)
    resume["resume_root"] = str(tmp_path_factory.mktemp("tp_resume"))
    return run_ranks("tp_layouts", 2, cases=[
        _case(name, arch, kw, 2, [("base", "baseline", True)], seq_len=seq)
        for name, arch, kw, seq in BASE_1X2] + [resume, _restore_case(
            "ref_base", 2, "baseline", ckpt_dirs["ref_base"], p, None, 1)])


@pytest.mark.parametrize("arch", ("phi3-mini-3.8b", "gemma-2b-sft",
                                  "musicgen-medium"))
@pytest.mark.parametrize("layout", ((2, 2), (1, 4)))
def test_flat_geometry_matches_reference(reference, gemma, arch, layout):
    """``(n_local, n_padded, seg, weight_vec)`` of a model rank's flat
    vector equal the reference's ``flat_geometry``, exactly."""
    data, model = layout
    cfg = reduced(get_config(arch), **F32)
    chunk = gemma[2]["grads"].config()
    local = shard_params(init_params(cfg, None, "meta"), cfg, 0, model)
    g = flat_geometry(local, data, chunk, cfg, _layout(data, model))
    n_local, n_padded, seg, w = reference["geometry"][arch, layout]
    assert (g.n_local, g.n_padded, g.seg) == (n_local, n_padded, seg)
    np.testing.assert_array_equal(weight_vec(g), w)


def _rank_trees(world, case, run):
    return [r[case][run] for r in world]


def test_compressed_2x2_matches_reference(world4, reference, gemma):
    """Reduced gemma, 2 compressed steps at 2 x 2 against the reference's
    on a (2, 2) mesh of fake devices, from the same tree, batches and
    registry: every ``ok``, losses, each rank's flat vector against the
    reference's stage-2 ``p_flat`` of its model index, and each rank's
    ZeRO-1 state against the ``[d, m]`` row of the reference's."""
    cfg = gemma[0]
    runs = _rank_trees(world4, "gemma", "qlc")
    assert reference["oks"] == [True, True]
    for rank, (losses, oks, fallbacks, local, state) in enumerate(runs):
        assert all(oks) and fallbacks == 0
        np.testing.assert_allclose(losses, reference["losses"], rtol=1e-5)
        d, m = divmod(rank, 2)
        want = _flat(shard_params(reference["params"], cfg, m, 2))
        got = _flat(local)
        assert (want == got).mean() >= 0.999
        conv = flat_opt_state_from_numpy(reference["state"], rank, "cpu")
        seg = state["m"].shape[0]
        assert conv["m"].shape[0] == seg
        assert int(conv["step"]) == reference["state"]["step"] == 2
        for k in ("m", "v"):
            want_k = conv[k].numpy()
            close = np.isclose(state[k], want_k, rtol=1e-5,
                               atol=1e-6 * np.abs(want_k).max())
            assert close.mean() >= 0.999, (rank, k, (~close).sum())
    whole = gather_params([runs[0][3], runs[1][3]], cfg)
    a, b = _flat(whole), _flat(reference["params"])
    assert (a == b).mean() >= 0.999


def test_compressed_2x2_equals_raw_twin(world4):
    """The QLC wire and its raw e4m3 twin give the same local trees and
    states, bit for bit, on every rank."""
    for qlc, twin in zip(_rank_trees(world4, "gemma", "qlc"),
                         _rank_trees(world4, "gemma", "twin")):
        assert qlc[0] == twin[0]
        np.testing.assert_array_equal(tree_bits(_flat(qlc[3])),
                                      tree_bits(_flat(twin[3])))
        for k in ("m", "v"):
            np.testing.assert_array_equal(tree_bits(qlc[4][k]),
                                          tree_bits(twin[4][k]))


def _check_rows(locals_by_rank, cfg, model):
    """Leaves that the model axis does not split are bit-identical over
    each model row; split leaves differ between its ranks."""
    specs = flat_tree(sharding.param_pspecs(cfg, _layout(1, model)))
    for start in range(0, len(locals_by_rank), model):
        row = [flat_tree(t) for t in locals_by_rank[start:start + model]]
        for key, spec in specs.items():
            if sharding.model_dim(spec) is None:
                for other in row[1:]:
                    np.testing.assert_array_equal(
                        tree_bits(row[0][key]), tree_bits(other[key]),
                        err_msg=key)
            else:
                assert not np.array_equal(row[0][key], row[1][key]), key


def test_replicated_leaves_stay_identical_over_model_rows(world4, world2):
    """After 2 steps, the norms (and any leaf kept whole) hold the same
    bits on every rank of a model row: 2 x 2 compressed (QLC and twin),
    1 x 4 and 1 x 2 baseline."""
    gem = reduced(get_config("gemma-2b-sft"), **F32)
    for run in ("qlc", "twin"):
        _check_rows([r[3] for r in _rank_trees(world4, "gemma", run)], gem,
                    2)
    name, arch, kw, _ = BASE_1X4
    _check_rows([r[3] for r in _rank_trees(world4, name, "base")],
                reduced(get_config(arch), **kw), 4)
    for name, arch, kw, _ in BASE_1X2:
        _check_rows([r[3] for r in _rank_trees(world2, name, "base")],
                    reduced(get_config(arch), **kw), 2)


def _against_one_rank(world, name, arch, kw, seq, model):
    cfg = reduced(get_config(arch), **kw)
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    one = train(cfg, comm="baseline", device="cpu", params=p,
                **dict(TRAIN, seq_len=seq))
    runs = _rank_trees(world, name, "base")
    for losses, *_ in runs:
        np.testing.assert_allclose(
            losses, [h["loss"] for h in one["history"]], rtol=1e-5)
    whole = gather_params([r[3] for r in runs[:model]], cfg)
    a = _flat(whole)
    b = _flat(one["params"])
    close = np.isclose(a, b, rtol=1e-5, atol=1e-6)
    assert close.mean() >= 0.999, (name, (~close).sum())
    assert np.abs(a - b).max() <= 2 * TRAIN["lr"] * TRAIN["steps"]


@pytest.mark.parametrize("case", BASE_1X2, ids=[c[0] for c in BASE_1X2])
def test_baseline_1x2_tracks_one_rank(world2, case):
    """The tensor-parallel baseline step on 1 x 2 (swiglu, gelu with the
    audio prefix, squared ReLU, padded heads that split with their KV
    heads gathered, a sliding window over blocked attention) against the
    port's own step on one rank, 2 steps from the same tree."""
    name, arch, kw, seq = case
    _against_one_rank(world2, name, arch, kw, seq, 2)


def test_baseline_1x4_tracks_one_rank(world4):
    """chatglm3 at 1 x 4: one query head a rank, the 2 KV heads whole on
    each (their gradient summed over the row)."""
    name, arch, kw, seq = BASE_1X4
    _against_one_rank(world4, name, arch, kw, seq, 4)


def test_resume_on_the_same_layout(world2):
    """``train(checkpoint_dir=...)`` at 1 x 2: both ranks write one
    checkpoint of the whole tree and ``[1, 2, seg]`` state; with the last
    checkpoint gone, the same launch resumes at step 2 and ends bit-equal
    to the straight run, on every rank."""
    for straight, resumed in zip(_rank_trees(world2, "resume", "qlc"),
                                 _rank_trees(world2, "resume",
                                             "qlc/resumed")):
        assert resumed[5] == 2 and len(resumed[0]) == 1
        assert all(straight[1]) and all(resumed[1])
        assert resumed[0] == straight[0][2:]
        np.testing.assert_array_equal(tree_bits(_flat(resumed[3])),
                                      tree_bits(_flat(straight[3])))
        for k in ("m", "v"):
            np.testing.assert_array_equal(tree_bits(resumed[4][k]),
                                          tree_bits(straight[4][k]))


# --------------------------------------------------------------------------
# Checkpoints across the packages
# --------------------------------------------------------------------------

def test_port_checkpoint_restores_in_the_reference(world4, reference):
    """The port's checkpoint of the 2 x 2 compressed run (every rank
    writing its part), restored by the reference's ``CheckpointManager``
    into its own tree and ``[2, 2, seg]`` state: every leaf bit-equal to
    the port's ranks' state put together (checksums checked by the
    reference on the way)."""
    cfg = reduced(get_config("gemma-2b-sft"), **F32)
    runs = _rank_trees(world4, "gemma", "qlc")
    (params, state), extra = reference["port_restored"]
    assert extra["step"] == 2 and extra["layout"] == {"data": 2, "model": 2}
    whole = gather_params([runs[0][3], runs[1][3]], cfg)
    for key, leaf in flat_tree(whole).items():
        np.testing.assert_array_equal(tree_bits(flat_tree(params)[key]),
                                      tree_bits(leaf), err_msg=key)
    assert int(state["step"]) == 2
    for rank, run in enumerate(runs):
        d, m = divmod(rank, 2)
        for k in ("m", "v"):
            np.testing.assert_array_equal(tree_bits(state[k][d, m]),
                                          tree_bits(run[4][k]))


def test_reference_checkpoint_restores_in_the_port(world4, reference):
    """The reference's checkpoint after its 2 x 2 compressed steps,
    restored by 4 port ranks at 2 x 2 through ``train(checkpoint_dir=)``
    (no step left to run): each rank's blocks and ``[seg]`` row
    bit-equal to the cut of the reference's final tree and state."""
    cfg = reduced(get_config("gemma-2b-sft"), **F32)
    for rank, run in enumerate(_rank_trees(world4, "ref_comp", "restored")):
        d, m = divmod(rank, 2)
        assert run[0] == [] and run[4]["step"] == 2
        want = shard_params(reference["params"], cfg, m, 2)
        for key, leaf in flat_tree(want).items():
            np.testing.assert_array_equal(tree_bits(flat_tree(run[3])[key]),
                                          tree_bits(leaf), err_msg=key)
        for k in ("m", "v"):
            np.testing.assert_array_equal(
                tree_bits(run[4][k]), tree_bits(reference["state"][k][d, m]))


@pytest.mark.parametrize("layout", ["1x2", "2x2"])
def test_reference_baseline_checkpoint_restores_in_the_port(
        world4, world2, reference, layout):
    """The reference's baseline checkpoint of a (2, 1) mesh (one step),
    restored by port ranks at 1 x 2 and 2 x 2: each rank's parameters
    and AdamW trees bit-equal to their cut of the reference's."""
    cfg = reduced(get_config("gemma-2b-sft"), **F32)
    world = world2 if layout == "1x2" else world4
    params, opt = reference["base"]
    for rank, run in enumerate(_rank_trees(world, "ref_base", "restored")):
        m = rank % 2
        assert run[0] == [] and run[4]["step"] == int(opt["step"]) == 1
        for got, whole in ((run[3], params), (run[4]["m"], opt["m"]),
                           (run[4]["v"], opt["v"])):
            want = shard_params(whole, cfg, m, 2)
            for key, leaf in flat_tree(want).items():
                np.testing.assert_array_equal(
                    tree_bits(flat_tree(got)[key]), tree_bits(leaf),
                    err_msg=key)
