"""Port parity, training slice: the model's loss and gradients, the
attention, the optimizer, the data, the flat ZeRO-1 state, and the
compressed train step, against the JAX reference; and the port's own
contracts: the compressed step equals its raw e4m3 twin bit for bit and
tracks the baseline step, ring equals one-shot, an overflowing wire
falls back to the baseline step, and the launcher runs on the CPU.

Reduced phi3-mini-3.8b (d_model 128, 2 layers, vocab 256, f32). Stated
tolerances and why:

* loss and gradients, attention: rtol 1e-5 / atol 1e-6 — the two
  frameworks sum in different orders in f32;
* AdamW: rtol 2e-6, atol 1e-8 — XLA and numpy round the f32
  ``b ** step``, ``cos`` and the global norm (f32 in the reference, f64
  sums here) in their last bits, which moves an update of ``lr * delta``
  (about 1e-2 here) by a few of its f32 ulps;
* the compressed step: parameters after 3 steps equal on at least 99.9%
  of entries (in practice all) and losses to rtol 1e-5 — the gradients
  differ in their last bits, so an e4m3 code may round the other way.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import CodecRegistry as JRegistry
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JDataset
from repro.models import attention as jattn
from repro.models import init_params as jinit_params
from repro.models import next_token_loss as jloss
from repro.parallel import sharding as shd
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_compressed_opt_state as jinit_opt
from repro.training import make_compressed_step as jmake_step
from repro.training import optimizer as jopt
from repro_torch.comm.calibrate import histogram_of_tree
from repro_torch.comm.planner import CommPlan
from repro_torch.configs import get_config, reduced
from repro_torch.convert import flat_opt_state_from_numpy, params_from_numpy
from repro_torch.core import CodecRegistry
from repro_torch.data import DataConfig, SyntheticDataset
from repro_torch.launch import train as train_mod
from repro_torch.models import attention as tattn
from repro_torch.models import init_params, next_token_loss
from repro_torch.models.transformer import pytree_leaves, pytree_unflatten
from repro_torch.training import optimizer as topt
from tests.torch_dist import run_ranks
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

CFG_KW = dict(d_model=128, dtype="float32")
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _cfgs(**kw):
    return (jreduced(jget_config("phi3-mini-3.8b"), **CFG_KW, **kw),
            reduced(get_config("phi3-mini-3.8b"), **CFG_KW, **kw))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def reference_grads(model):
    jcfg, _, jp, _ = model
    t, lab = _batch()
    return jax.jit(jax.value_and_grad(
        lambda p: jloss(p, jcfg, jnp.asarray(t), jnp.asarray(lab))))(jp)


def _batch(seed=0, b=2, s=32):
    toks = np.random.default_rng(seed).integers(0, 256, (b, s + 1)
                                                ).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def test_pytree_order_matches_reference(model):
    _, _, jp, tp = model
    want = [tuple(x.shape) for x in jax.tree.leaves(jp)]
    assert [tuple(x.shape) for x in pytree_leaves(tp)] == want
    back = pytree_unflatten(tp, pytree_leaves(tp))
    assert list(back) == list(tp)
    assert all(a is b for a, b in zip(pytree_leaves(back),
                                      pytree_leaves(tp)))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_reference(model, reference_grads, remat):
    """``next_token_loss`` and its gradients (blocked attention over 2 q
    and kv blocks), with the per-layer checkpoint on and off."""
    _, _, _, tp = model
    tcfg = _cfgs(remat=remat)[1]
    t, lab = _batch()
    jl, jg = reference_grads
    live = [x.clone().requires_grad_(True) for x in pytree_leaves(tp)]
    tl = next_token_loss(pytree_unflatten(tp, live), tcfg,
                         torch.from_numpy(t), torch.from_numpy(lab))
    tg = torch.autograd.grad(tl, live)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **GRAD_TOL)
    for a, b in zip(jax.tree.leaves(jg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **GRAD_TOL)


@pytest.mark.parametrize("impl", ["dense", "blocked"])
def test_attention_matches_reference(impl):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
               for _ in range(3))
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64))
    jf = getattr(jattn, f"{impl}_attention")
    tf = getattr(tattn, f"{impl}_attention")
    kw = dict(q_block=16, kv_block=32) if impl == "blocked" else {}
    want = jf(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), **kw)
    got = tf(*(torch.from_numpy(np.ascontiguousarray(a))
               for a in (q, k, v, pos, pos)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def test_synthetic_batches_equal_reference():
    cfg = dict(vocab_size=32064, seq_len=33, global_batch=4, seed=5)
    jd, td = JDataset(JDataConfig(**cfg)), SyntheticDataset(DataConfig(**cfg))
    for step in (0, 1, 7):
        a, b = jd.batch_at(step), td.batch_at(step)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a[key], b[key])


def test_lr_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_frac=0.1)
    jc, tc = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    for step in (0, 1, 5, 10, 11, 30, 50, 70):
        want = float(jopt.lr_at(jc, jnp.int32(step)))
        got = topt.lr_at(tc, step)
        assert got.dtype == np.float32
        np.testing.assert_allclose(float(got), want, rtol=2e-6)


@pytest.mark.parametrize("clip", [0.5, 100.0])
def test_flat_update_matches_reference(clip):
    """``apply_flat_update`` at step 3 with the clip active and not."""
    rng = np.random.default_rng(1)
    p, g, m = (rng.standard_normal(4096).astype(np.float32) * 0.1
               for _ in range(3))
    v = np.abs(rng.standard_normal(4096).astype(np.float32)) * 0.01
    cfg = dict(lr=1e-2, grad_clip=clip, warmup_steps=2, total_steps=20,
               weight_decay=0.01)
    gnorm = np.float32(np.sqrt(np.sum(g.astype(np.float64) ** 2)))
    jp, js, jlr = jopt.apply_flat_update(
        jnp.asarray(p), jnp.asarray(g),
        {"m": jnp.asarray(m), "v": jnp.asarray(v), "step": jnp.int32(2)},
        jopt.OptConfig(**cfg), jnp.float32(gnorm))
    tp, ts, tlr = topt.apply_flat_update(
        torch.from_numpy(p), torch.from_numpy(g),
        {"m": torch.from_numpy(m), "v": torch.from_numpy(v),
         "step": torch.tensor(2, dtype=torch.int32)},
        topt.OptConfig(**cfg), torch.tensor(gnorm))
    assert int(ts["step"]) == int(js["step"]) == 3
    np.testing.assert_allclose(float(tlr), float(jlr), rtol=2e-6)
    for a, b in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-6,
                                   atol=1e-8)


def test_tree_update_matches_reference(model):
    """The baseline step's AdamW (global-norm clip on the tree)."""
    _, _, jp, tp = model
    rng = np.random.default_rng(2)
    jg = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), jp)
    tg = params_from_numpy(jax.tree.map(np.asarray, jg), "cpu")
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=20)
    jc, tc = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    jn, js, jinfo = jax.jit(lambda p, g: jopt.apply_update(
        p, g, jopt.init_state(p, jc), jc))(jp, jg)
    tn, ts, tinfo = topt.apply_update(tp, tg, topt.init_state(tp, tc), tc)
    np.testing.assert_allclose(float(tinfo["grad_norm"]),
                               float(jinfo["grad_norm"]), rtol=2e-6)
    for a, b in zip(jax.tree.leaves((jn, js["m"], js["v"])),
                    pytree_leaves(tn) + pytree_leaves(ts["m"])
                    + pytree_leaves(ts["v"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-6,
                                   atol=1e-8)


def test_step_count_is_read_on_the_host(model):
    """The optimizers' step count lives on the host whatever device the
    moments are on: over a ``"meta"`` parameter tree (no values) both
    states' steps read as 0 with ``int()``; three updates from a host
    step are bit-equal to three from a step on the parameters' device,
    the way the state kept it before, and leave the count on the host
    at 3."""
    _, _, _, tp = model
    cfg = topt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    meta = {"w": torch.zeros((4, 8), device="meta")}
    for st in (topt.init_state(meta, cfg),
               topt.init_flat_state(64, cfg, "meta")):
        assert st["step"].device.type == "cpu" and int(st["step"]) == 0
        assert pytree_leaves(st["m"])[0].device.type == "meta"
    rng = np.random.default_rng(7)
    tg = pytree_unflatten(tp, [torch.from_numpy(rng.standard_normal(
        a.shape).astype(np.float32)) for a in pytree_leaves(tp)])
    host = topt.init_state(tp, cfg)
    old = dict(topt.init_state(tp, cfg), step=torch.zeros(
        (), dtype=torch.int32, device=pytree_leaves(tp)[0].device))
    flat_p, flat_g = pytree_leaves(tp)[0].reshape(-1), \
        pytree_leaves(tg)[0].reshape(-1)
    flat = topt.init_flat_state(flat_p.numel(), cfg, flat_p.device)
    flat_old = dict(flat, step=torch.zeros((), dtype=torch.int32,
                                           device=flat_p.device))
    pa = pb = tp
    fa = fb = flat_p
    gnorm = torch.linalg.vector_norm(flat_g)
    for _ in range(3):
        pa, host, _ = topt.apply_update(pa, tg, host, cfg)
        pb, old, _ = topt.apply_update(pb, tg, old, cfg)
        fa, flat, _ = topt.apply_flat_update(fa, flat_g, flat, cfg, gnorm)
        fb, flat_old, _ = topt.apply_flat_update(fb, flat_g, flat_old, cfg,
                                                 gnorm)
    def leaves(p, st, f):
        return (pytree_leaves(p) + pytree_leaves(st["m"])
                + pytree_leaves(st["v"]) + [f])
    for a, b in zip(leaves(pa, host, fa), leaves(pb, old, fb)):
        assert torch.equal(a, b)
    for st in (host, flat):
        assert st["step"].device.type == "cpu" and int(st["step"]) == 3


def test_compressed_step_tracks_reference_step(model):
    """The port's compressed step (one gloo rank, K1/K2's plain versions)
    against the reference's (a 1 x 1 data x model mesh, its pure codec)
    from the same parameters, batches and codec registry (calibrated by
    the port, loaded by the reference from its JSON), 3 steps; and the
    reference's initial flat ZeRO-1 state converts to the port's."""
    jcfg, tcfg, jp, tp = model
    res = train_mod.train(tcfg, comm="qlc", steps=3, seq_len=32,
                          global_batch=4, device="cpu", params=tp)
    assert all(h["ok"] for h in res["history"])
    jreg = JRegistry.from_json(res["registry"].to_json())
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    opt_cfg = jopt.OptConfig(lr=3e-4, total_steps=3, warmup_steps=10)
    step = jax.jit(jmake_step(jcfg, opt_cfg, JTrainConfig(), mesh, jreg))
    data = JDataset(JDataConfig(vocab_size=256, seq_len=32, global_batch=4))
    with shd.use_mesh(mesh):
        o = jinit_opt(jcfg, mesh, JTrainConfig(), jreg, opt_cfg)
        conv = flat_opt_state_from_numpy(jax.tree.map(np.asarray, o), 0,
                                         "cpu")
        assert conv["m"].shape == res["opt_state"]["m"].shape
        p, losses = jp, []
        for s in range(3):
            batch = {k: jnp.asarray(v) for k, v in data.batch_at(s).items()}
            p, o, m = step(p, o, batch)
            assert bool(m["ok"])
            losses.append(float(m["loss"]))
    np.testing.assert_allclose([h["loss"] for h in res["history"]], losses,
                               rtol=1e-5)
    a = np.concatenate([np.asarray(x).reshape(-1) for x in jax.tree.leaves(p)])
    b = np.concatenate([x.reshape(-1).numpy()
                        for x in pytree_leaves(res["params"])])
    assert (a == b).mean() >= 0.999
    assert int(res["opt_state"]["step"]) == int(o["step"]) == 3


@pytest.fixture(scope="module")
def four_ranks():
    """The two four-rank checks below in one world of 4 gloo ranks."""
    runs = [("qlc", "qlc", "oneshot", True),
            ("ring", "qlc", "ring", True),
            ("raw", "qlc", "oneshot", False),
            ("baseline", "baseline", "oneshot", True)]
    return run_ranks("train_four", 4, runs=dict(
        cfg_kw=CFG_KW, steps=2, global_batch=8, seq_len=32, lr=3e-4,
        runs=runs), recipe_steps=8)


def test_four_ranks_ring_oneshot_raw_twin_and_baseline(four_ranks):
    """4 gloo ranks, 2 steps each from the same start and registry: the
    compressed step over one-shot and over the ring (2 hop pieces) and
    the raw e4m3 twin give the same parameters bit for bit (the wire is
    lossless), every ``ok`` holds with no fallback, and the baseline
    step's losses track the compressed ones within 0.15 (the reference's
    bound) at the launcher's learning rate."""
    out = [r["runs"] for r in four_ranks]
    for rank in range(4):
        r = out[rank]
        for name in ("qlc", "ring", "raw"):
            losses, oks, fallbacks, _ = r[name]
            assert all(oks) and fallbacks == 0, (rank, name)
            np.testing.assert_array_equal(r[name][3], r["qlc"][3])
            assert losses == r["qlc"][0]
        diffs = [abs(a - b) for a, b in zip(r["baseline"][0], r["qlc"][0])]
        assert max(diffs) < 0.15, diffs
        np.testing.assert_array_equal(r["qlc"][3], out[0]["qlc"][3])


def test_reference_training_check_on_four_ranks(four_ranks):
    """The reference's own check (``test_train_integration.py``, its
    model, optimizer, microbatches and data) on 4 gloo ranks: both steps
    learn (the loss falls by more than 0.1 over 8 steps) and the
    compressed losses stay within 0.15 of the baseline's."""
    out = [r["recipe"] for r in four_ranks]
    for lb, lc, oks in out:
        assert all(oks)
        assert lb[-1] < lb[0] - 0.1 and lc[-1] < lc[0] - 0.1, (lb, lc)
        diffs = [abs(a - b) for a, b in zip(lb, lc)]
        assert max(diffs) < 0.15, diffs
        assert (lb, lc) == (out[0][0], out[0][1])


@pytest.mark.parametrize("lr", [3e-4, 1e-2])
def test_baseline_step_tracks_reference_baseline(model, lr):
    """The port's baseline step against the reference's over 5 steps
    from the same parameters and batches (launcher optimizer settings):
    losses to rtol 1e-5."""
    jcfg, tcfg, jp, tp = model
    from repro.training import make_baseline_step as jmake_base
    res = train_mod.train(tcfg, comm="baseline", steps=5, seq_len=32,
                          global_batch=4, device="cpu", lr=lr, params=tp)
    opt_cfg = jopt.OptConfig(lr=lr, total_steps=5, warmup_steps=10)
    step = jax.jit(jmake_base(jcfg, opt_cfg, JTrainConfig()))
    data = JDataset(JDataConfig(vocab_size=256, seq_len=32, global_batch=4))
    p, o, losses = jp, jopt.init_state(jp, opt_cfg), []
    for s in range(5):
        p, o, m = step(p, o, {k: jnp.asarray(v)
                              for k, v in data.batch_at(s).items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose([h["loss"] for h in res["history"]], losses,
                               rtol=1e-5)


def test_overflowing_wire_falls_back_to_the_baseline_step():
    """A grads codec whose one-word slots and one-slot pool cannot hold
    the gradient: every step's ``ok`` is False, the trainer redoes it
    through the baseline step on the ZeRO-1 state, and the parameters
    equal a baseline run's bit for bit."""
    _, tcfg = _cfgs()
    good = train_mod.train(tcfg, comm="qlc", steps=1, seq_len=16,
                           global_batch=2, device="cpu")["registry"]
    g = good["grads"]
    reg = CodecRegistry()
    reg.register_tables("grads", g.tables, CommPlan(
        chunk_symbols=1024, capacity_words=1, pool_slots_per_1k=1,
        expected_bits_per_symbol=g.plan.expected_bits_per_symbol,
        escape_prob_bound=1.0))
    reg.register_tables("params", good["params"].tables, good["params"].plan)
    kw = dict(steps=2, seq_len=16, global_batch=2, device="cpu")
    fell = train_mod.train(tcfg, comm="qlc", registry=reg, **kw)
    base = train_mod.train(tcfg, comm="baseline", **kw)
    assert fell["comm_fallbacks"] == 2
    for a, b in zip(pytree_leaves(fell["params"]),
                    pytree_leaves(base["params"])):
        assert torch.equal(a, b)
    assert [h["loss"] for h in fell["history"]] == \
        [h["loss"] for h in base["history"]]


def test_launcher_runs_on_the_cpu(capsys):
    res = train_mod.main(["--arch", "phi3-mini-3.8b", "--reduced",
                          "--device", "cpu", "--comm", "qlc", "--steps", "2",
                          "--seq-len", "32", "--global-batch", "4",
                          "--transport", "ring"])
    assert len(res["history"]) == 2 and res["comm_fallbacks"] == 0
    assert all(h["ok"] for h in res["history"])
    out = capsys.readouterr().out
    assert "B/symbol (grads)" in out and "final loss" in out


@pytest.mark.parametrize("flags,item", [
    (["--pods", "2"], "item 13"), (["--transport", "hierarchical"],
                                   "item 13")])
def test_launcher_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        train_mod.main(["--arch", "phi3-mini-3.8b", "--reduced", "--device",
                        "cpu"] + flags)


def test_launcher_trains_reduced_musicgen_like_the_reference(capsys):
    """Reduced musicgen-medium (gelu FFN, no ``w_gate``) through the
    launcher, 2 compressed steps in its bf16 compute: every step ok, no
    fallback, and the first step's loss that of ``next_token_loss`` on
    the launcher's initial parameters and batch 0 (``seq_len -
    frontend_prefix_len`` tokens, no prefix). The same loss in f32
    compute equals the reference's within GRAD_TOL."""
    res = train_mod.main(["--arch", "musicgen-medium", "--reduced",
                          "--device", "cpu", "--comm", "qlc", "--steps", "2",
                          "--seq-len", "40", "--global-batch", "4"])
    assert len(res["history"]) == 2 and res["comm_fallbacks"] == 0
    assert all(h["ok"] for h in res["history"])
    assert "B/symbol (grads)" in capsys.readouterr().out
    tc = reduced(get_config("musicgen-medium"))
    assert tc.frontend_prefix_len == 8 and tc.activation == "gelu"
    tp = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert "w_gate" not in tp["groups"]["l0"]["ffn"]
    b = SyntheticDataset(DataConfig(vocab_size=tc.vocab_size, seq_len=32,
                                    global_batch=4, seed=0)).batch_at(0)
    t, lab = torch.from_numpy(b["tokens"]), torch.from_numpy(b["labels"])
    with torch.no_grad():
        np.testing.assert_allclose(res["history"][0]["loss"],
                                   float(next_token_loss(tp, tc, t, lab)),
                                   rtol=1e-6)
        tl = next_token_loss(tp, dataclasses.replace(tc, dtype="float32"),
                             t, lab)
    jc = jreduced(jget_config("musicgen-medium"), dtype="float32")
    jp = jax.tree.map(lambda x: jnp.asarray(x.numpy()), tp)
    jl = jloss(jp, jc, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
    np.testing.assert_allclose(float(tl), float(jl), **GRAD_TOL)


_SMALL = ["--arch", "phi3-mini-3.8b", "--reduced", "--device", "cpu",
          "--comm", "qlc", "--seq-len", "32", "--global-batch", "4"]


def test_launcher_checkpoint_dir_saves_and_resumes(tmp_path, capsys):
    """``--checkpoint-dir``: the first launch writes its checkpoints, a
    second launch with more steps resumes from the last one's step and
    saves its own."""
    ck = str(tmp_path / "ck")
    first = train_mod.main(_SMALL + ["--steps", "2", "--checkpoint-dir", ck,
                                     "--checkpoint-every", "1"])
    assert first["start_step"] == 0 and len(first["history"]) == 2
    assert sorted(os.listdir(ck)) == ["latest", "step_0000000001",
                                      "step_0000000002"]
    second = train_mod.main(_SMALL + ["--steps", "3", "--checkpoint-dir",
                                      ck])
    assert second["start_step"] == 2 and len(second["history"]) == 1
    assert "resumed from step 2" in capsys.readouterr().out
    assert "step_0000000003" in os.listdir(ck)


def test_launcher_autotune_prints_tuned_transports(capsys):
    res = train_mod.main(_SMALL + ["--steps", "1", "--autotune"])
    out = capsys.readouterr().out
    assert "autotuned grads: oneshot x1" in out
    assert "autotuned params: oneshot x1" in out
    reg = res["registry"]
    assert len(reg.transport_cache()) == 2
    assert {k[1] for k in reg.transport_cache()} == {"data"}


def test_launcher_adapt_runs_on_the_cpu(capsys):
    """``--comm qlc --adapt --adapt-every 1``: the step runs with wire
    telemetry and the launcher prints each check (both codecs, measured
    against planned bits/symbol) and each swap."""
    res = train_mod.main(_SMALL + ["--steps", "3", "--adapt",
                                   "--adapt-every", "1"])
    out = capsys.readouterr().out
    checks = res["adapt"]["checks"]
    assert [(c["step"], c["name"]) for c in checks] == [
        (s, n) for s in range(3) for n in ("grads", "params")]
    assert all(c["measured_bits"] > 0 for c in checks)
    assert out.count("adapt check after step") == 6
    assert "adapt check after step 1: grads scheme-id 0, measured" in out
    assert out.count("codec hot-swap") == len(res["adapt"]["events"])


def test_launcher_adapt_swaps_a_mismatched_codec_once(tmp_path):
    """A ``"grads"`` codec calibrated on the parameters' histogram (a
    real distribution of the model, not the gradients'): the drift policy
    flags it at the second judged check, it is recalibrated under a new
    scheme-id and the step rebuilt, and through the 3 checks of the
    cooldown it stays put. The checkpoint of the last step carries the
    revised registry, and a resumed launch restores the state bit for
    bit and encodes with the revision."""
    _, tcfg = _cfgs()
    params = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    reg = CodecRegistry()
    h = histogram_of_tree(params)
    reg.register("grads", h, chunk_symbols=1024)
    reg.register("params", h, chunk_symbols=1024)
    ck = str(tmp_path / "ck")
    kw = dict(comm="qlc", seq_len=32, global_batch=4, device="cpu",
              checkpoint_dir=ck, checkpoint_every=6)
    res = train_mod.train(tcfg, steps=6, registry=reg, params=params,
                          adapt=True, adapt_every=1, **kw)
    ev = res["adapt"]["events"]
    assert [(e.name, e.old_scheme_id, e.new_scheme_id) for e in ev] == \
        [("grads", 0, 1)]
    assert ev[0].measured_bits > ev[0].old_expected_bits + 0.5
    grads = [c for c in res["adapt"]["checks"] if c["name"] == "grads"]
    assert [c["scheme_id"] for c in grads] == [0, 0, 0, 1, 1, 1]
    assert [c["flagged"] for c in grads] == [False, False, True, False,
                                             False, False]
    assert res["registry"]["params"].scheme_id == 0
    again = train_mod.train(tcfg, steps=6, **kw)
    assert again["start_step"] == 6 and again["history"] == []
    assert again["registry"]["grads"].scheme_id == 1
    assert again["registry"].to_json() == res["registry"].to_json()
    for a, b in zip(pytree_leaves(res["params"]) + [res["opt_state"]["m"]],
                    pytree_leaves(again["params"])
                    + [again["opt_state"]["m"]]):
        assert torch.equal(a, b)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")


def test_train_defaults_to_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.train(_cfgs()[1], steps=1)
