"""Port parity, SSM and multimodal slice: the mamba, sLSTM and mLSTM
blocks and their decode states, the parameter carry-over, the xLSTM and
hybrid (jamba) stacks' forward and decode, a vlm's prefix forward, and
xLSTM's train steps against the JAX reference; the port's own
contracts: a prompt fed in segments gives the whole prompt's states bit
for bit, the launcher trains xlstm on the CPU; and the two repairs: the
baseline step's microbatches split the global batch as the reference's
on two gloo ranks with expert capacity binding, and a dropped trainer
frees its tensors without the cycle collector.

Reduced configs (``reduced(xlstm-125m)``: d_model 64, 4 heads x 16, one
sLSTM and one mLSTM layer; ``reduced(jamba-1.5-large-398b)``: 8 layers,
attention with a dense FFN, mamba with MoE and dense FFNs), f32 compute
unless stated. Stated tolerances and why:

* blocks, states (the mLSTM ``m`` stabiliser included), logits: rtol
  1e-4 / atol 1e-5, the tolerance of ``tests/test_torch_serving.py``
  (f32 summation order; measured: at most 2.5e-5 on logits of up to 4);
* the blocks in bf16 compute: one bf16 ulp (rtol and atol 2^-7). The
  sLSTM block is bit-equal; the mLSTM block differs by up to 0.0156 on
  outputs of up to 6.2, one ulp of a bf16 einsum rounded by another
  framework. A whole bf16 forward is not compared: the mLSTM divides by
  ``max(|n.q|, exp(-m))``, which reaches 5e-3 at this width, so one
  ulp upstream grows two hundredfold (measured: 1.48 on one position of
  12, 0.05 elsewhere);
* loss and gradients: rtol 1e-5 / atol 1e-6, as ``tests/
  test_torch_train.py``; the compressed step as there (losses rtol 1e-5,
  parameters equal on at least 99.9% of entries);
* everything the port holds against itself (segments against the whole
  prompt): exact.
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import CodecRegistry as JRegistry
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JDataset
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_decode_states as jinit_states
from repro.models import init_params as jinit_params
from repro.models import multimodal as jmm
from repro.models import next_token_loss as jloss
from repro.models import ssm as jssm
from repro.parallel import sharding as shd
from repro.serving import prefill as jprefill
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_compressed_opt_state as jinit_opt
from repro.training import make_baseline_step as jmake_base
from repro.training import make_compressed_step as jmake_step
from repro.training import optimizer as jopt
from repro.training.train_step import _loss_fn as jloss_fn
from repro.training.train_step import _microbatched_grads as jmicro
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import data_parallel
from repro_torch.models import (decode_step, forward, init_decode_states,
                                init_params, multimodal, next_token_loss,
                                ssm)
from repro_torch.models.transformer import (leaf_grads, pytree_leaves,
                                            pytree_unflatten, tree_leaves)
from repro_torch.serving import prefill
from tests.torch_dist import run_ranks
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
XL, JAMBA, VLM = "xlstm-125m", "jamba-1.5-large-398b", "phi-3-vision-4.2b"


def _cfgs(arch, **kw):
    return jreduced(jget_config(arch), **kw), reduced(get_config(arch), **kw)


@pytest.fixture(scope="module", params=[XL, JAMBA])
def stack(request):
    """(reference cfg, port cfg, reference params, port params), f32: the
    port's init carried to the reference as numpy (the reference's own
    init of the hybrid stack compiles for seconds; its leaves are held
    by ``test_params_from_numpy_and_init_match_reference_tree``)."""
    jc, tc = _cfgs(request.param, dtype="float32")
    tp = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    return jc, tc, jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp), tp


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _block_case(kind, dtype):
    arch = JAMBA if kind == "mamba" else XL
    jc, tc = _cfgs(arch, dtype=dtype)
    init = getattr(jssm, f"init_{kind}")
    jp = init(jax.random.PRNGKey(1), jc, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(2).standard_normal(
        (2, 6, jc.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jc.dtype)
    tx = torch.from_numpy(_f32(jx)).to(getattr(torch, dtype))
    return jc, tc, jp, tp, jx, tx


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_block_and_decode_states_match_reference(kind):
    """The block over a 6-token sequence, then from a fresh state as
    one segment and token by token: outputs and every state field (the
    mLSTM and sLSTM ``m`` stabilisers included) within TOL, and the
    token-by-token states equal to the segment's within TOL."""
    jc, tc, jp, tp, jx, tx = _block_case(kind, "float32")
    jblock = jax.jit(lambda p, x, s: getattr(jssm, f"{kind}_block")(
        p, x, jc, state=s))
    tblock = getattr(ssm, f"{kind}_block")
    jinit_st = getattr(jssm, f"{kind}_init_state")
    tinit_st = getattr(ssm, f"{kind}_init_state")
    jo, none = jblock(jp, jx, None)
    to, tnone = tblock(tp, tx, tc)
    assert none is None and tnone is None
    np.testing.assert_allclose(_f32(to), _f32(jo), **TOL)
    jo, js = jblock(jp, jx, jinit_st(jx, 2, jc))
    to, ts = tblock(tp, tx, tc, state=tinit_st(tx, 2, tc))
    assert type(ts).__name__ == type(js).__name__
    assert ts._fields == js._fields
    np.testing.assert_allclose(_f32(to), _f32(jo), **TOL)
    for f, a, b in zip(ts._fields, js, ts):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape, f
        np.testing.assert_allclose(_f32(b), _f32(a), err_msg=f, **TOL)
    st, outs = tinit_st(tx, 2, tc), []
    for t in range(tx.shape[1]):
        o, st = tblock(tp, tx[:, t:t + 1], tc, state=st)
        outs.append(o)
    np.testing.assert_allclose(_f32(torch.cat(outs, 1)), _f32(to), **TOL)
    for f, a, b in zip(st._fields, ts, st):
        np.testing.assert_allclose(_f32(b), _f32(a), err_msg=f, **TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_blocks_in_bf16_within_one_ulp(kind):
    jc, tc, jp, tp, jx, tx = _block_case(kind, "bfloat16")
    jo, _ = jax.jit(lambda p, x: getattr(jssm, f"{kind}_block")(
        p, x, jc))(jp, jx)
    to, _ = getattr(ssm, f"{kind}_block")(tp, tx, tc)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(to), _f32(jo), **BF16_TOL)


def test_state_snapshot_and_restore():
    """Snapshots are the state's tensors in field order; restore gives
    them back in the state's dtypes and shapes, and refuses what the
    reference refuses."""
    _, tc = _cfgs(XL)
    _, jamba = _cfgs(JAMBA)
    like = torch.zeros(1)
    for st in (ssm.mlstm_init_state(like, 2, tc),
               ssm.slstm_init_state(like, 2, tc),
               ssm.mamba_init_state(like, 2, jamba)):
        filled = type(st)(*(torch.randn(a.shape) for a in st))
        snap = ssm.state_snapshot(filled)
        assert all(a is b for a, b in zip(snap, filled))
        back = ssm.state_restore(st, [a.reshape(-1).double() for a in snap])
        assert type(back) is type(st)
        for a, b in zip(back, filled):
            assert a.dtype == torch.float32 and torch.equal(a, b)
        with pytest.raises(ValueError, match="expects"):
            ssm.state_restore(st, snap[:-1])
    for fn in (ssm.state_snapshot, lambda s: ssm.state_restore(s, ())):
        with pytest.raises(TypeError, match="not an SSM decode state"):
            fn((torch.zeros(1),))


@pytest.mark.parametrize("arch", [XL, JAMBA])
def test_params_from_numpy_and_init_match_reference_tree(arch):
    """Every leaf of the reference's init (xlstm's whole tree, a mamba
    block's, with ``A_log`` and ``D`` f32) carried bit for bit, and the
    port's own init makes the reference's tree: keys, pytree order,
    shapes and dtypes, with bf16 params (no ``norm2``/``ffn`` on a block
    whose FFN kind is ``none``)."""
    jc, tc = _cfgs(arch)
    if arch == XL:
        jp = jax.jit(lambda k: jinit_params(jc, k))(jax.random.PRNGKey(0))
    else:
        jp = jssm.init_mamba(jax.random.PRNGKey(0), jc, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jl = jax.tree.leaves(jp)
    assert len(jl) == len(pytree_leaves(tp))
    for a, b in zip(jl, pytree_leaves(tp)):
        a = np.asarray(a)
        assert str(b.dtype) == f"torch.{a.dtype}"
        np.testing.assert_array_equal(b.numpy().view(np.int32),
                                      a.view(np.int32))
    own = init_params(dataclasses.replace(tc, param_dtype="bfloat16"),
                      torch.Generator().manual_seed(0), "cpu")
    jb = jax.eval_shape(lambda k: jinit_params(dataclasses.replace(
        jc, param_dtype="bfloat16"), k), jax.random.PRNGKey(0))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jb)]
    assert [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(jb)] == \
        [(tuple(b.shape), str(b.dtype).removeprefix("torch."))
         for b in pytree_leaves(own)]
    if arch == XL:
        assert not any("ffn" in p or "norm2" in p for p in paths)
        assert sorted(own["groups"]["l0"]) == ["mixer", "norm1"]
    else:
        # within one f32 ulp: XLA's f32 log(7) rounds up, torch's down
        a_log = own["groups"]["l1"]["mixer"]["A_log"]
        assert a_log.dtype == torch.float32
        np.testing.assert_allclose(a_log[0].numpy(), np.asarray(jp["A_log"]),
                                   rtol=2 ** -23, atol=0)


def test_forward_and_decode_logits_match_reference(stack):
    """``forward`` over 8 tokens; an 8-token prompt through ``prefill``
    (logits and every decode state) and one more ``decode_step``."""
    jc, tc, jp, tp = stack
    tok = np.random.default_rng(3).integers(0, 256, (2, 8)).astype(np.int32)
    jl = jax.jit(lambda p, t: jforward(p, jc, t))(jp, jnp.asarray(tok))
    np.testing.assert_allclose(_f32(forward(tp, tc, torch.from_numpy(tok))),
                               _f32(jl), **TOL)
    jl, js = jax.jit(lambda p, t, s: jprefill(p, jc, t, s))(
        jp, jnp.asarray(tok), jinit_states(jc, 2, 16))
    tl, ts = prefill(tp, tc, torch.from_numpy(tok),
                     init_decode_states(tc, 2, 16, "cpu"))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    jleaves, tleaves = jax.tree.leaves(js), tree_leaves(ts)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(_f32(b), _f32(a), **TOL)
    nxt = np.argmax(_f32(jl), axis=-1).astype(np.int32)[:, None]
    pos = np.full((2, 1), 8, np.int32)
    jl2, _ = jax.jit(lambda p, t, s, q: jdecode_step(p, jc, t, s, q))(
        jp, jnp.asarray(nxt), js, jnp.asarray(pos))
    tl2, _ = decode_step(tp, tc, torch.from_numpy(nxt), ts,
                         torch.from_numpy(pos))
    np.testing.assert_allclose(_f32(tl2), _f32(jl2), **TOL)


def test_segmented_prefill_equals_whole_prompt():
    """A prompt fed in segments (``start_pos=``) gives the whole
    prompt's logits and every recurrent state bit for bit, in bf16
    compute as the engine runs it."""
    _, tc = _cfgs(XL)
    params = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    p = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 11)))
    lw, sw = prefill(params, tc, p, init_decode_states(tc, 2, 16, "cpu"))
    st, pos = init_decode_states(tc, 2, 16, "cpu"), 0
    for end in (4, 8, 11):
        ls, st = prefill(params, tc, p[:, pos:end], st, start_pos=pos)
        pos = end
    assert torch.equal(lw, ls)
    for a, b in zip(tree_leaves(sw), tree_leaves(st)):
        assert torch.equal(a, b)


def test_prefix_forward_matches_reference():
    """A vlm's ``forward`` with the same numpy prefix embeddings in both
    packages (reduced phi-3-vision: 8 prefix positions); the stubs'
    shapes and dtypes are the reference's."""
    jc, tc = _cfgs(VLM, dtype="float32")
    jp = jax.jit(lambda k: jinit_params(jc, k))(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    tok = rng.integers(0, 256, (2, 6)).astype(np.int32)
    pre = rng.standard_normal((2, tc.frontend_prefix_len,
                               tc.d_model)).astype(np.float32)
    jl = jax.jit(lambda p, t, e: jforward(p, jc, t, prefix_emb=e))(
        jp, jnp.asarray(tok), jnp.asarray(pre))
    tl = forward(tp, tc, torch.from_numpy(tok),
                 prefix_emb=torch.from_numpy(pre))
    assert tl.shape == (2, 6 + tc.frontend_prefix_len, tc.vocab_size)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    for cfg in (_cfgs(VLM)[1], tc):
        js = jmm.prefix_spec(jreduced(jget_config(VLM),
                                      dtype=cfg.dtype), 3)
        shape, dtype = multimodal.prefix_spec(cfg, 3)
        assert shape == js.shape and str(dtype) == f"torch.{js.dtype}"
        e = multimodal.stub_prefix_embeddings(
            torch.Generator().manual_seed(0), cfg, 3, "cpu")
        assert tuple(e.shape) == shape and e.dtype == dtype
    e = multimodal.stub_prefix_embeddings(torch.Generator().manual_seed(1),
                                          dataclasses.replace(
                                              tc, d_model=4096), 4, "cpu")
    assert abs(float(e.mean())) < 0.01 and abs(float(e.std()) - 1) < 0.01


@pytest.fixture(scope="module")
def xl():
    jc, tc = _cfgs(XL, dtype="float32")
    jp = jax.jit(lambda k: jinit_params(jc, k))(jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_loss_and_gradients_match_reference(xl):
    """Full remat (a per-group checkpoint) as the config's default; the
    sLSTM block's unused ``wk`` / ``wv`` get zero gradients, as
    ``jax.grad`` gives them."""
    jc, tc, jp, tp = xl
    tc = dataclasses.replace(tc, remat="full")
    toks = np.random.default_rng(6).integers(0, 256, (2, 17)).astype(np.int32)
    t, lab = toks[:, :-1], toks[:, 1:]
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, jc, jnp.asarray(t), jnp.asarray(lab))))(jp)
    live = [x.clone().requires_grad_(True) for x in pytree_leaves(tp)]
    tl = next_token_loss(pytree_unflatten(tp, live), tc,
                         torch.from_numpy(t), torch.from_numpy(lab))
    tg = leaf_grads(tl, live)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **GRAD_TOL)
    for a, b in zip(jax.tree.leaves(jg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **GRAD_TOL)
    unused = tp["groups"]["l0"]["mixer"]
    for k in ("wk", "wv"):
        i = next(i for i, x in enumerate(pytree_leaves(tp))
                 if x is unused[k])
        assert not tg[i].any()


def test_baseline_and_compressed_steps_track_reference(xl):
    """xLSTM's gradient tree (pytree order, no ``ffn`` leaves) through
    both steps: one baseline step's loss against the reference's; one
    compressed step (one gloo rank) against the reference's compressed
    step from the same parameters, batch and registry: the loss, and the
    updated parameters."""
    jc, tc, jp, tp = xl
    kw = dict(steps=1, seq_len=16, global_batch=4, device="cpu", params=tp)
    data = JDataset(JDataConfig(vocab_size=256, seq_len=16, global_batch=4))
    opt_cfg = jopt.OptConfig(lr=3e-4, total_steps=1, warmup_steps=10)
    base = train_mod.train(tc, comm="baseline", **kw)
    step = jax.jit(jmake_base(jc, opt_cfg, JTrainConfig()))
    _, _, m = step(jp, jopt.init_state(jp, opt_cfg),
                   {k: jnp.asarray(v) for k, v in data.batch_at(0).items()})
    np.testing.assert_allclose(base["history"][0]["loss"], float(m["loss"]),
                               rtol=1e-5)
    res = train_mod.train(tc, comm="qlc", **kw)
    assert all(h["ok"] for h in res["history"])
    jreg = JRegistry.from_json(res["registry"].to_json())
    mesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    step = jax.jit(jmake_step(jc, opt_cfg, JTrainConfig(), mesh, jreg))
    with shd.use_mesh(mesh):
        o = jinit_opt(jc, mesh, JTrainConfig(), jreg, opt_cfg)
        batch = {k: jnp.asarray(v) for k, v in data.batch_at(0).items()}
        p, o, m = step(jp, o, batch)
        assert bool(m["ok"])
    np.testing.assert_allclose(res["history"][0]["loss"], float(m["loss"]),
                               rtol=1e-5)
    a = np.concatenate([np.asarray(x).reshape(-1)
                        for x in jax.tree.leaves(p)])
    b = np.concatenate([x.reshape(-1).numpy()
                        for x in pytree_leaves(res["params"])])
    assert (a == b).mean() >= 0.999


def test_launcher_trains_xlstm_on_the_cpu(capsys):
    res = train_mod.main(["--arch", XL, "--reduced", "--device", "cpu",
                          "--comm", "qlc", "--steps", "2", "--seq-len", "16",
                          "--global-batch", "4"])
    assert len(res["history"]) == 2 and res["comm_fallbacks"] == 0
    out = capsys.readouterr().out
    assert "B/symbol (grads)" in out and "final loss" in out


def test_microbatches_split_the_global_batch_as_the_reference():
    """Baseline step, 2 gloo ranks, reduced deepseek-moe at capacity
    factor 0.5 (tokens dropped), 2 microbatches of a global batch of 8:
    each rank's microbatch i is its half of the global microbatch i, so
    the step's loss and reduced gradients equal the reference's
    single-process microbatched step (rtol 1e-5 / atol 1e-6)."""
    jc, _ = _cfgs("deepseek-moe-16b", dtype="float32")
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, capacity_factor=0.5))
    jp = jax.jit(lambda k: jinit_params(jc, k))(jax.random.PRNGKey(0))
    toks = np.random.default_rng(7).integers(0, 256, (8, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.jit(lambda p, b: jmicro(jloss_fn(jc), p, b, 2))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    out = run_ranks("microbatched_step", 2, params=jax.tree.map(
        np.asarray, jp), batch=batch, capacity_factor=0.5, n_micro=2)
    for loss, grads in out:
        np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
        for a, b in zip(jax.tree.leaves(jg), grads):
            np.testing.assert_allclose(b, np.asarray(a), **GRAD_TOL)


def test_dropped_training_run_frees_its_tensors_without_collect():
    """With the cycle collector off, dropping a 2-step compressed run's
    result frees its parameters and optimizer state at once: nothing of
    the run (gradient trees, codec registry, channels) sits in a
    reference cycle."""
    _, tc = _cfgs(XL)
    gc.collect()
    gc.disable()
    try:
        with data_parallel("cpu"):
            res = train_mod.train(tc, comm="qlc", steps=2, seq_len=16,
                                  global_batch=4, device="cpu")
            refs = [weakref.ref(t) for t in (
                res["params"]["groups"]["l1"]["mixer"]["wq"],
                res["params"]["embed"], res["opt_state"]["m"])]
            assert all(r() is not None for r in refs)
            del res
            assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()
