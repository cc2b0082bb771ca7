"""Port parity, FSDP slice (ZeRO-3, the reference's parameter cut over
``data``): every leaf's resolved spec under ``make_rules()``, the cut of
a tree into ``data x model`` blocks and its inverse, the baseline step
with each layer group gathered over the data column, prefill and decode
logits, the QLC weight wire cut by chunks over the column, the engine
and the serving launcher, and checkpoints of FSDP blocks, against the
JAX reference or the port's own runs without a mesh.

Reduced configs at f32 on gloo CPU ranks (``tests/torch_dist``): one
world of 4 ranks (2 x 2) and one of 2 (2 x 1, and 1 x 2: a column of
one), started in threads beside one reference subprocess on a (2, 2)
mesh of 4 fake CPU devices under the reference's ``make_rules()``.
Stated tolerances and why:

* specs, the cut, its inverse, the local init and the FSDP histogram:
  exact;
* the FSDP baseline step against the reference's: losses to rtol 1e-5,
  parameters to rtol 1e-5 / atol 1e-6 on at least 99.9 % of entries and
  every entry within 2 x lr x steps, as ``tests/test_torch_tp.py``
  states for the tensor-parallel step (the gradients of a data column
  are reduce-scattered and summed in another order than the reference's;
  AdamW's normalized step turns the last-bit difference of a near-zero
  gradient entry into a sizeable part of lr);
* the step on a column of one against the TP-only step: bit for bit
  (a gather and a reduce-scatter of one rank move nothing);
* prefill and decode logits under FSDP against no mesh: at 2 x 1 bit
  for bit (a gather is exact), at 2 x 2 rtol 1e-5 / atol 1e-5 (a model
  row sums its products in another order: ``tests/test_torch_tp_serve.py``
  holds a row's logits so), tokens equal;
* the chunk-cut wire opened over the column against ``open_group`` of
  the whole model-block wire, and the decode from it against the decode
  from the opened tree: bit for bit;
* checkpoints: the port's 2 x 2 FSDP state read by the reference's
  ``restore``, and restored at 1 x 2 TP-only and at 2 x 1 under FSDP,
  bit for bit.

About 90 s serial.
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
from repro.models import init_params as jinit_params
from repro.models import param_specs as jparam_specs
from repro.parallel import sharding as jshd
from repro_torch.configs import ASSIGNED, REGISTRY, get_config, reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import (gather_params, init_local_params,
                                 shard_params)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train
from repro_torch.models import (decode_step, init_decode_states,
                                init_params, prefill_logits)
from repro_torch.models.transformer import param_specs, pytree_leaves
from repro_torch.parallel import sharding
from tests.md_util import run_md
from tests.torch_dist import (_engine_run, flat_tree, numpy_tree,
                              one_cpu_thread, run_ranks, tree_bits)

one_cpu_thread()

F32 = dict(dtype="float32")
TRAIN = dict(steps=2, seq_len=16, global_batch=8, lr=3e-4)
#: the baseline step's cases: (name, arch, config overrides)
CASES = (("dense", "phi3-mini-3.8b", F32),
         ("moe", "deepseek-moe-16b", F32),
         ("recurrent", "xlstm-125m", F32))
#: serving: reduced phi3, one layer, wide enough that its FFN leaves go
#: on the wire (the plain decode of a wire costs ~0.2 s a leaf on the CPU,
#: and the FSDP decode opens each group's wire in every step)
SERVE_CFG = dict(F32, d_model=128, d_ff=512, num_layers=1)
SERVE = dict(prompt=4, new_tokens=3, kv_block=4, requests=2, batch=2)


def _cfg(arch, kw):
    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = MoEConfig(**kw["moe"])
    return reduced(get_config(arch), **kw)


def _serve_cfg():
    return reduced(get_config("phi3-mini-3.8b"), frontend=None,
                   frontend_prefix_len=0, **SERVE_CFG)


def _layout(data, model):
    return tmesh.Mesh(data=data, model=model, rank=0, world_group=None,
                      data_group=None, model_group=None)


def _spec_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _spec_leaves(tree[key],
                                         f"{prefix}/{key}").items()}
    return {prefix: tuple(tree)}


# --------------------------------------------------------------------------
# Specs, the cut and its inverse
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED)
def test_fsdp_specs_match_reference(arch):
    """Under ``make_rules()`` every leaf's resolved spec equals the
    reference's ``rules.spec(..., param=True)`` (its ``_resolve``, which
    reads only ``axis_names`` and ``shape``) at 16 x 16 and 2 x 2, and
    ``data_dim`` names the dim it puts on ``data``. Exact."""
    cfg, jcfg = REGISTRY[arch], JREGISTRY[arch]
    jspecs = _spec_leaves(jparam_specs(jcfg))
    jshapes = flat_tree(jax.eval_shape(lambda k: jinit_params(jcfg, k),
                                       jax.random.PRNGKey(0)))
    for data, model in ((16, 16), (2, 2)):
        stand_in = types.SimpleNamespace(
            axis_names=("data", "model"),
            shape={"data": data, "model": model})
        with sharding.use_rules(sharding.make_rules()):
            got = _spec_leaves(sharding.param_pspecs(cfg,
                                                     _layout(data, model)))
        rules = jshd.make_rules()
        for key, spec in jspecs.items():
            shape = tuple(jshapes[key[1:]].shape)
            used = set()
            want = tuple(rules._resolve(n, d, stand_in, True, used)
                         for n, d in zip(spec, shape))
            assert got[key] == want, (arch, data, model, key)
            dim = sharding.data_dim(got[key])
            assert (dim is not None) == any(
                e is not None and "data" in ((e,) if isinstance(e, str)
                                             else e) for e in want)


@pytest.mark.parametrize("arch", ("phi3-mini-3.8b", "deepseek-moe-16b",
                                  "xlstm-125m", "jamba-1.5-large-398b"))
def test_fsdp_cut_and_gather_are_inverses(arch):
    """``shard_params`` with the data cut gives rank ``(d, m)`` its ``d x
    m`` block (tensors and numpy alike), ``gather_params`` puts the whole
    tree back, and ``init_local_params`` draws the same blocks a leaf at
    a time, at 2 x 2 and 4 x 1. Exact."""
    kw = dict(F32, num_layers=2, attn_every=2) if arch.startswith(
        "jamba") else F32
    cfg = _cfg(arch, kw)
    p = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    with sharding.use_rules(sharding.make_rules()):
        for data, model in ((2, 2), (4, 1)):
            specs = pytree_leaves(sharding.param_pspecs(cfg, _layout(data,
                                                                     model)))
            parts = [shard_params(p, cfg, r % model, model,
                                  data_index=r // model, data_size=data)
                     for r in range(data * model)]
            cut = 0
            for leaf, part, spec in zip(pytree_leaves(p),
                                        pytree_leaves(parts[-1]), specs):
                want = leaf
                for dim, n, i in ((sharding.model_dim(spec), model,
                                   model - 1),
                                  (sharding.data_dim(spec), data, data - 1)):
                    if dim is not None:
                        k = want.shape[dim] // n
                        want = want.narrow(dim, i * k, k)
                cut += sharding.data_dim(spec) is not None
                assert torch.equal(part, want)
            assert cut > 0
            back = gather_params(parts, cfg, data_size=data)
            for a, b in zip(pytree_leaves(back), pytree_leaves(p)):
                assert torch.equal(a, b)
            np_parts = [shard_params(numpy_tree(p), cfg, r % model, model,
                                     data_index=r // model, data_size=data)
                        for r in range(data * model)]
            for a, b in zip(pytree_leaves(gather_params(
                    np_parts, cfg, data_size=data)), pytree_leaves(p)):
                np.testing.assert_array_equal(a, b.numpy())
            for r in (0, data * model - 1):
                local = init_local_params(
                    cfg, torch.Generator().manual_seed(1), "cpu", r % model,
                    model, r // model, data)
                for a, b in zip(pytree_leaves(local),
                                pytree_leaves(parts[r])):
                    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# The reference and the worlds
# --------------------------------------------------------------------------

REFERENCE = """
import os, pickle, time
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.checkpoint import CheckpointManager
from repro.configs import get_config, reduced
from repro.configs.base import MoEConfig
from repro.data import DataConfig, SyntheticDataset
from repro.models import param_specs
from repro.parallel import sharding as shd
from repro.training import TrainConfig, make_baseline_step
from repro.training import optimizer as jopt
args = pickle.load(open({path!r}, "rb"))
devs = np.array(jax.devices()[:4])
mesh = Mesh(devs.reshape(2, 2), ("data", "model"))
t = args["train"]
shd.set_rules(shd.make_rules())
out = {{}}
for name, arch, cfg_kw in args["cases"]:
    kw = dict(cfg_kw)
    if "moe" in kw:
        kw["moe"] = MoEConfig(**kw["moe"])
    cfg = reduced(get_config(arch), **kw)
    opt_cfg = jopt.OptConfig(lr=t["lr"], total_steps=t["steps"],
                             warmup_steps=max(10, t["steps"] // 20))
    data = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=t["seq_len"],
                                       global_batch=t["global_batch"]))
    with shd.use_mesh(mesh):
        p = jax.tree.map(jnp.asarray, args["params"][name])
        p = jax.device_put(p, shd.param_sharding(mesh, param_specs(cfg), p))
        o = jopt.init_state(p, opt_cfg)
        step = jax.jit(make_baseline_step(cfg, opt_cfg, TrainConfig()))
        losses = []
        for s in range(t["steps"]):
            batch = {{k: jnp.asarray(v)
                     for k, v in data.batch_at(s).items()}}
            p, o, m = step(p, o, batch)
            losses.append(float(m["loss"]))
    out[name] = (losses, jax.tree.map(np.asarray, p))
    if name == "dense":
        like = (p, o)
# the port's 2 x 2 FSDP checkpoint, once its world has written it
end = time.monotonic() + 280
while not os.path.exists(os.path.join(args["ckpt"], "latest")):
    assert time.monotonic() < end, "the port's checkpoint did not appear"
    time.sleep(0.2)
got, extra = CheckpointManager(args["ckpt"]).restore(like)
out["restored"] = (jax.tree.map(np.asarray, got), extra)
pickle.dump(out, open({path!r} + ".out", "wb"))
"""


def _train_case(name, arch, cfg_kw, model, runs, params, fsdp=True,
                **train_kw):
    return dict(name=name, arch=arch, cfg_kw=cfg_kw, model=model,
                params=params, runs=runs, registry_json=None, fsdp=fsdp,
                train_kw=dict(TRAIN, **train_kw))


def _serving_kw(model):
    cfg = _serve_cfg()
    rng = np.random.default_rng(3)
    return dict(arch="phi3-mini-3.8b", cfg_kw=SERVE_CFG,
                params=_whole_serve(),
                tokens=rng.integers(0, cfg.vocab_size, (2, 7)),
                prompt=SERVE["prompt"],
                prompts=rng.integers(0, cfg.vocab_size, (6, 6)),
                new_tokens=SERVE["new_tokens"], kv_block=SERVE["kv_block"],
                model=model, serve_kw=dict(
                    batch=SERVE["batch"], requests=SERVE["requests"],
                    prompt_len=SERVE["prompt"],
                    new_tokens=SERVE["new_tokens"],
                    prefill_chunk=SERVE["prompt"]))


def _whole_serve():
    return numpy_tree(init_params(_serve_cfg(), torch.Generator(
        ).manual_seed(0), "cpu"))


@pytest.fixture(scope="module")
def trees():
    """Each case's whole initial tree (numpy)."""
    return {name: numpy_tree(init_params(
        _cfg(arch, kw), torch.Generator().manual_seed(0), "cpu"))
        for name, arch, kw in CASES}


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """The reference's subprocess beside a world of 4 (the FSDP step at
    2 x 2 for every case, the dense one checkpointed; serving at 2 x 2)
    and a world of 2 (the FSDP step at 2 x 1 for every case; the dense
    case at 1 x 2, a column of one, with and without FSDP; the 2 x 2
    checkpoint restored at 1 x 2 TP-only and at 2 x 1 under FSDP;
    serving at 2 x 1)."""
    root = tmp_path_factory.mktemp("fsdp")
    ckpt = str(root / "ckpt")
    path = str(root / "args.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(cases=CASES, params=trees, train=TRAIN,
                         ckpt=ckpt), f)
    base = [("fsdp", "baseline", True)]
    four = [_train_case(name, arch, kw, 2, base if name != "dense" else
                        [("fsdp", "baseline", True,
                          dict(checkpoint_dir=ckpt))], trees[name])
            for name, arch, kw in CASES]
    two = [_train_case(name, arch, kw, 1, base, trees[name])
           for name, arch, kw in CASES]
    name, arch, kw = CASES[0]
    two += [_train_case("column_of_one", arch, kw, 2, base, trees[name]),
            _train_case("tp_only", arch, kw, 2, [("tp", "baseline", True)],
                        trees[name], fsdp=False),
            _train_case("restored", arch, kw, 2, [
                ("tp", "baseline", True, dict(checkpoint_dir=ckpt,
                                              wait_for=os.path.join(
                                                  ckpt, "latest")))],
                trees[name], fsdp=False),
            _train_case("restored_fsdp", arch, kw, 1, [
                ("fsdp", "baseline", True, dict(checkpoint_dir=ckpt,
                                                wait_for=os.path.join(
                                                    ckpt, "latest")))],
                trees[name])]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        ref = pool.submit(run_md, REFERENCE.format(path=path), n_devices=4,
                          timeout=600)
        w4 = pool.submit(run_ranks, "fsdp_world", 4, timeout=600,
                         train=four, serving=_serving_kw(2))
        w2 = pool.submit(run_ranks, "fsdp_world", 2, timeout=600,
                         train=two, serving=_serving_kw(1))
        world4, world2 = w4.result(), w2.result()
        ref.result()
    with open(path + ".out", "rb") as f:
        reference = pickle.load(f)
    return reference, world4, world2


def _whole(world, name, run, arch, kw, data, fsdp=True):
    """A train run's whole parameters and moments, gathered from every
    rank's blocks."""
    cfg = _cfg(arch, kw)
    ranks = [w["train"][name][run] for w in world]
    with sharding.use_rules(sharding.make_rules() if fsdp else None):
        params = gather_params([r[3] for r in ranks], cfg, data_size=data)
        moments = {k: gather_params([r[4][k] for r in ranks], cfg,
                                    data_size=data) for k in ("m", "v")}
    return ranks[0][0], params, moments


def _close(got, want, lr_steps):
    """The tolerance of the module docstring, leaf by leaf."""
    for key, w in flat_tree(want).items():
        g = np.asarray(flat_tree(got)[key], np.float64)
        w = np.asarray(w, np.float64)
        ok = np.isclose(g, w, rtol=1e-5, atol=1e-6)
        assert ok.mean() >= 0.999, (key, ok.mean())
        assert np.abs(g - w).max() <= 2 * lr_steps, key


@pytest.mark.parametrize("layout", ((2, 2), (2, 1)), ids=["2x2", "2x1"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fsdp_baseline_step_matches_reference(runs, case, layout):
    """The ZeRO-3 baseline step (each rank its ``d x m`` blocks, each
    layer group gathered over the column, the gradients reduce-scattered)
    against the reference's baseline step under its ``make_rules()``:
    losses to rtol 1e-5, parameters as the module docstring states; and
    every rank held its ``d x m`` block of every leaf, as its resolved
    spec gives it."""
    reference, world4, world2 = runs
    name, arch, kw = case
    world = world4 if layout == (2, 2) else world2
    losses, params, _ = _whole(world, name, "fsdp", arch, kw, layout[0])
    ref_losses, ref_params = reference[name]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    _close(params, ref_params, TRAIN["lr"] * TRAIN["steps"])
    whole = flat_tree(ref_params)
    mesh = _layout(*layout)
    with sharding.use_rules(sharding.make_rules()):
        specs = _spec_leaves(sharding.param_pspecs(_cfg(arch, kw), mesh))
    for key, block in flat_tree(world[-1]["train"][name]["fsdp"][3]).items():
        assert block.shape == sharding.local_shape(
            whole[key].shape, specs["/" + key], mesh), key
    assert any(sharding.data_dim(s) is not None for s in specs.values())


def test_fsdp_column_of_one_is_bit_equal_to_tp_only(runs):
    """At 1 x 2 (a data column of one) the FSDP step gathers over one rank
    and is bit-equal to the TP-only step, parameters and moments."""
    _, _, world2 = runs
    for rank in world2:
        a, b = rank["train"]["column_of_one"]["fsdp"], \
            rank["train"]["tp_only"]["tp"]
        assert a[0] == b[0]
        for x, y in ((a[3], b[3]), (a[4]["m"], b[4]["m"]),
                     (a[4]["v"], b[4]["v"])):
            for key, leaf in flat_tree(y).items():
                np.testing.assert_array_equal(tree_bits(flat_tree(x)[key]),
                                              tree_bits(leaf), err_msg=key)


def test_fsdp_step_on_one_rank_is_bit_equal_to_tp_only():
    """On one rank (a 1 x 1 mesh) ``train()`` under ``make_rules()``
    gathers each group over a column of one, and reduce-scatters, and is
    bit-equal to the run without a mesh, with ``remat="none"`` and
    ``"full"`` (under FSDP each group runs in a checkpoint either way)."""
    from repro_torch.parallel.sharding import make_rules, use_rules
    for remat in ("none", "full"):
        cfg = dataclasses.replace(_cfg("phi3-mini-3.8b", F32), remat=remat)
        p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        plain = train(cfg, comm="baseline", device="cpu", params=p, **TRAIN)
        with tmesh.data_parallel("cpu"):
            mesh = tmesh.make_test_mesh(model=1)
            tmesh.reset_fsdp_counts()
            with tmesh.use_mesh(mesh), use_rules(make_rules()):
                fsdp = train(cfg, comm="baseline", device="cpu", params=p,
                             **TRAIN)
            counts = dict(tmesh.FSDP_COUNTS)
        gathered = (len(pytree_leaves(p)) - len(pytree_leaves(p["groups"]))
                    + len(pytree_leaves(p["groups"]))
                    * pytree_leaves(p["groups"])[0].shape[0])
        assert counts["reduce_scatters"] == gathered * TRAIN["steps"]
        assert counts["gathers"] > counts["reduce_scatters"]
        for a, b in zip(pytree_leaves(fsdp["params"]),
                        pytree_leaves(plain["params"])):
            assert torch.equal(a, b)


def test_fsdp_checkpoint_read_by_reference(runs):
    """The port's 2 x 2 FSDP checkpoint (every rank writing its ``d x m``
    block of each leaf) holds the whole leaves: the reference's
    ``restore`` reads the gathered parameters and moments bit for bit."""
    reference, world4, _ = runs
    name, arch, kw = CASES[0]
    _, params, moments = _whole(world4, name, "fsdp", arch, kw, 2)
    (got_p, got_o), extra = reference["restored"]
    assert extra["layout"] == {"data": 2, "model": 2}
    for x, y in ((got_p, params), (got_o["m"], moments["m"]),
                 (got_o["v"], moments["v"])):
        for key, leaf in flat_tree(y).items():
            np.testing.assert_array_equal(tree_bits(flat_tree(x)[key]),
                                          tree_bits(leaf), err_msg=key)


@pytest.mark.parametrize("layout", ("1x2", "2x1"), ids=["tp_only_1x2",
                                                         "fsdp_2x1"])
def test_fsdp_checkpoint_restored(runs, layout):
    """The 2 x 2 FSDP checkpoint restored at 1 x 2 without FSDP (each rank
    its model block) and at 2 x 1 under FSDP (each rank its data block):
    every rank's parameters and moments its cut of the saved whole
    state, bit for bit."""
    _, world4, world2 = runs
    name, arch, kw = CASES[0]
    cfg = _cfg(arch, kw)
    _, params, moments = _whole(world4, name, "fsdp", arch, kw, 2)
    case, run, fsdp = (("restored", "tp", False) if layout == "1x2"
                       else ("restored_fsdp", "fsdp", True))
    for r, rank in enumerate(world2):
        got = rank["train"][case][run]
        assert got[0] == []         # resumed at its last step
        for x, y in ((got[3], params), (got[4]["m"], moments["m"]),
                     (got[4]["v"], moments["v"])):
            with sharding.use_rules(sharding.make_rules() if fsdp
                                    else None):
                want = (shard_params(y, cfg, 0, 1, data_index=r,
                                     data_size=2) if fsdp
                        else shard_params(y, cfg, r, 2))
            for key, leaf in flat_tree(want).items():
                np.testing.assert_array_equal(
                    tree_bits(flat_tree(x)[key]), tree_bits(leaf),
                    err_msg=key)


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def no_mesh():
    """The serving checks' runs without a mesh: prefill logits, the
    teacher-forced decode, the engine's tokens and the launcher's."""
    kw = _serving_kw(1)
    cfg = _serve_cfg()
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(kw["tokens"]).long()
    b, n = toks.shape
    prompt = kw["prompt"]
    with torch.no_grad():
        pre = prefill_logits(p, cfg, toks[:, :prompt]).numpy()
        st = init_decode_states(cfg, b, n, "cpu")
        pos = torch.arange(prompt, dtype=torch.int32)[None].expand(b, prompt)
        lg, st = decode_step(p, cfg, toks[:, :prompt], st, pos)
        logits = [lg[:, -1]]
        for t in range(prompt, n):
            lg, st = decode_step(p, cfg, toks[:, t:t + 1], st,
                                 torch.full((b, 1), t, dtype=torch.int32))
            logits.append(lg[:, 0])
        prompts = kw["prompts"]
        engine = _engine_run(p, cfg, prompts, kw["new_tokens"],
                             prompts.shape[1] + kw["new_tokens"] + 8, 4,
                             None)[0]
        served = serve(cfg, wire="qlc", device="cpu", **kw["serve_kw"])
    return dict(prefill=pre, decode=torch.stack(logits).numpy(),
                engine=engine, serve=[o.tokens for o in served["outs"]])


def _serving(runs, layout):
    _, world4, world2 = runs
    return [w["serving"] for w in (world4 if layout == "2x2" else world2)]


@pytest.mark.parametrize("layout", ("2x2", "2x1"))
def test_fsdp_prefill_and_decode_logits(runs, no_mesh, layout):
    """``prefill_logits`` and a teacher-forced decode under ``make_rules()``
    from the rank's blocks against no mesh: at 2 x 1 bit for bit (a
    gather is exact), at 2 x 2 to rtol 1e-5 / atol 1e-5 (a model row's
    sums, ``tests/test_torch_tp_serve.py``'s tolerance); the groups were
    gathered."""
    for rank in _serving(runs, layout):
        for key in ("prefill", "decode"):
            if layout == "2x1":
                np.testing.assert_array_equal(tree_bits(rank[key]),
                                              tree_bits(no_mesh[key]))
            else:
                np.testing.assert_allclose(rank[key], no_mesh[key],
                                           rtol=1e-5, atol=1e-5)
        assert rank["gathers"]["gathers"] > 0
        assert rank["gathers"]["reduce_scatters"] == 0


@pytest.mark.parametrize("layout", ("2x2", "2x1"))
def test_fsdp_wire_chunk_cut_opens_bit_equal(runs, layout):
    """The QLC weight wire under FSDP: each leaf's model-block wire cut by
    chunks over the data column (every leaf here divides it), opened over
    the column bit-equal to ``open_group`` of the whole model-block wire;
    the decode from the wire, a group opened at a time, bit-equal to the
    decode from the opened tree; the FSDP histogram equals the model's."""
    for rank in _serving(runs, layout):
        assert rank["hist_equal"]
        assert rank["chunks"]
        for local, whole in rank["chunks"].values():
            assert local * 2 == whole
        assert rank["wire_open_equal"]
        np.testing.assert_array_equal(tree_bits(rank["wire_decode"]),
                                      tree_bits(rank["opened_decode"]))


@pytest.mark.parametrize("layout", ("2x2", "2x1"))
def test_fsdp_engine_tokens(runs, no_mesh, layout):
    """``Engine(mesh=)`` under ``make_rules()`` (the slots split over the
    column, every rank gathering in step): f32 tokens equal to no mesh,
    dense and paged sync and async; ``serve(reference_rules=True)`` from
    the chunk-cut wire (a group's wire opened over the column in every
    decode step), paged sync, equal to the launcher without a mesh, its
    check against the dense engine passed."""
    for rank in _serving(runs, layout):
        for kind, tokens in rank["engine"].items():
            for rid, tok in tokens.items():
                np.testing.assert_array_equal(
                    tok, no_mesh["engine"][rid], err_msg=(kind, rid))
        outs, solo = rank["serve"]
        assert len(outs) == len(no_mesh["serve"]) == SERVE["requests"]
        for got, want in zip(outs, no_mesh["serve"]):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(solo, outs[0])
