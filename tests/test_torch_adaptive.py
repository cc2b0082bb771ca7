"""Port parity, online codec adaptation: the traffic monitor, the drift
policy, the recalibrator, the controller and the training adapter of
``repro_torch.adaptive`` against the reference's ``repro.adaptive`` on
the same histogram sequences; the registry's revisions; the compressed
step's wire telemetry against the reference's; and the port's own
contracts: a telemetry step is bit-identical to a plain one, payloads
written under an old scheme-id decode after a swap, an overflowing
step's telemetry reaches the adapter through the fallback.

Every comparison of the adaptive layer is exact (``==`` on floats and
arrays): both packages run the same float64 numpy operations on the
same inputs. Registries are paired through the reference's JSON, so
the tables and plans start equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import adaptive as jad
from repro.comm import container as jqc
from repro.comm.planner import plan_for_tables as jplan_for_tables
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import adapt as jadapt
from repro.core.distributions import ffn1_counts, ffn2_counts, grad_counts
from repro.core.registry import CodecRegistry as JRegistry
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JDataset
from repro.models import init_params as jinit_params
from repro.parallel import sharding as shd
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_compressed_opt_state as jinit_opt
from repro.training import make_compressed_step as jmake_step
from repro.training import optimizer as jopt
from repro_torch import adaptive as tad
from repro_torch.comm import container as tqc
from repro_torch.comm.channel import Channel, ChannelSpec
from repro_torch.comm.planner import CommPlan
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import CodecRegistry
from repro_torch.data import DataConfig, SyntheticDataset
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import data_parallel
from repro_torch.models.transformer import pytree_leaves
from repro_torch.training import (OptConfig, TrainConfig,
                                  init_compressed_opt_state,
                                  make_compressed_step)
from tests.torch_dist import run_ranks
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

CHUNK = 512
ALL_CFGS = [dict(), dict(min_symbols=1024.0, cooldown=0),
            dict(hysteresis=1, cooldown=2, min_events=1),
            dict(margin_bits=-10.0, hysteresis=1, cooldown=0, min_events=1,
                 min_symbols=1024.0)]


def _pair(name="acts", counts=None, **plan_kw):
    """A reference registry with one entry calibrated on ``counts``
    (default the ffn1 stream) and the port's registry loaded from its
    JSON -> (reference registry, port registry)."""
    counts = ffn1_counts(1 << 14, 0) if counts is None else counts
    jreg = JRegistry()
    tables = jadapt.calibrate_tables(counts, allow_search=False)
    plan = jplan_for_tables(tables, counts, chunk_symbols=CHUNK, **plan_kw)
    jreg.register_tables(name, tables, plan, counts=counts)
    return jreg, CodecRegistry.from_json(jreg.to_json())


def _hostile(jreg, name="acts", n=1 << 14):
    """A histogram on the deployed codec's longest codes."""
    enc_len = np.asarray(jreg[name].tables.enc_len, np.float64)
    counts = np.zeros(256)
    counts[np.argsort(enc_len, kind="stable")[-8:]] = n / 8.0
    return counts


def _traffic(t):
    return (t.name, t.scheme_id, t.counts.tolist(), t.symbols,
            t.escaped_chunks, t.chunks, t.overflows, t.containers, t.events,
            t.escape_rate, t.overflow_rate, t.entropy_bits_per_symbol())


def _same_registry(jreg, treg):
    """Same ids, names, tables and plans in both packages."""
    assert sorted(jreg.names()) == sorted(treg.names())
    for n in jreg.names():
        assert jreg[n].scheme_id == treg[n].scheme_id, n
    assert len(jreg) == len(treg)
    for e in jreg.entries():
        t = treg.by_id(e.scheme_id)
        assert t.name == e.name
        for f in ("enc_code", "enc_len", "dec_lut"):
            np.testing.assert_array_equal(np.asarray(getattr(t.tables, f)),
                                          np.asarray(getattr(e.tables, f)))
        assert dataclasses.asdict(t.plan) == {
            k: getattr(e.plan, k) for k in dataclasses.asdict(t.plan)}
        np.testing.assert_array_equal(t.counts, np.asarray(e.counts))


# --------------------------------------------------------------------------
# Monitor, policy, recalibrator, controller, adapter: exact parity
# --------------------------------------------------------------------------

def _stream(jreg, seed):
    """A histogram sequence with escape and overflow pressure: matched,
    then shifted, then hostile traffic."""
    rng = np.random.default_rng(seed)
    out = [(ffn1_counts(1 << 14, seed + i), {}) for i in range(3)]
    out += [(ffn2_counts(1 << 14, seed + i),
             dict(escaped_chunks=float(rng.integers(0, 9)), chunks=64.0,
                  overflow=bool(i % 2), containers=1.0)) for i in range(4)]
    out += [(_hostile(jreg), dict(escaped_chunks=30.0, chunks=64.0))] * 3
    return out


@pytest.mark.parametrize("decay", [0.97, 0.5, 1.0])
def test_traffic_monitor_matches_reference(decay):
    jreg, treg = _pair()
    jm = jad.TrafficMonitor(jreg, decay=decay)
    tm = tad.TrafficMonitor(treg, decay=decay)
    for hist, kw in _stream(jreg, 11):
        a, b = jm.observe("acts", hist, **kw), tm.observe("acts", hist, **kw)
        assert _traffic(a) == _traffic(b)
        assert jm.measured_bits("acts") == tm.measured_bits("acts")
        assert jm.excess_bits("acts") == tm.excess_bits("acts")
    tm.observe("acts", torch.full((256,), 3, dtype=torch.int32),
               scheme_id=7)
    jm.observe("acts", np.full(256, 3, np.int32), scheme_id=7)
    assert jm.snapshot() == tm.snapshot()
    assert jm.names() == tm.names() == ["acts"]
    jm.reset("acts")
    tm.reset("acts")
    assert tm.traffic("acts") is None and tm.traffic("acts", 7) is not None
    assert jm.snapshot() == tm.snapshot()
    with pytest.raises(ValueError, match="bins"):
        tm.observe("acts", np.zeros(128))
    with pytest.raises(ValueError, match="decay"):
        tad.TrafficMonitor(treg, decay=0.0)


@pytest.mark.parametrize("cfg", ALL_CFGS)
def test_drift_policy_flags_match_reference_step_by_step(cfg):
    jreg, treg = _pair()
    jm, tm = jad.TrafficMonitor(jreg), tad.TrafficMonitor(treg)
    jp = jad.DriftPolicy(jm, jad.DriftConfig(**cfg))
    tp = tad.DriftPolicy(tm, tad.DriftConfig(**cfg))
    assert dataclasses.asdict(tp.config) == dataclasses.asdict(jp.config)
    flags = []
    for i, (hist, kw) in enumerate(_stream(jreg, 5) * 2):
        jm.observe("acts", hist, **kw)
        tm.observe("acts", hist, **kw)
        f = jp.update("acts")
        assert f == tp.update("acts"), i
        flags.append(f)
        if i == 6:
            jp.notify_swapped("acts")
            tp.notify_swapped("acts")
        assert ({k: dataclasses.asdict(v) for k, v in jp._state.items()}
                == {k: dataclasses.asdict(v) for k, v in tp._state.items()})
    assert any(flags)


def test_drift_defaults_are_the_reference_defaults():
    assert dataclasses.asdict(tad.DriftConfig()) == \
        dataclasses.asdict(jad.DriftConfig())


@pytest.mark.parametrize("search", [True, False])
def test_recalibrator_tables_plans_and_ids_match_reference(search):
    jreg, treg = _pair(drift_margin_bits=0.25, pool_slots_per_1k=16)
    kw = dict(allow_search=search, sample_symbols=1 << 14, seed=3)
    jr, tr = jad.Recalibrator(jreg, **kw), tad.Recalibrator(treg, **kw)
    hostile = _hostile(jreg)
    for counts in (ffn2_counts(1 << 14, 7), grad_counts(1 << 14, 2),
                   hostile):
        np.testing.assert_array_equal(jr._synthetic_stream(counts),
                                      tr._synthetic_stream(counts))
        a, b = jr.recalibrate("acts", counts), tr.recalibrate("acts", counts)
        assert a.scheme_id == b.scheme_id
        assert b.plan.chunk_symbols == CHUNK
        _same_registry(jreg, treg)
    again = tr.recalibrate("acts", hostile)       # converged: no-op
    assert again is treg["acts"] and len(treg) == len(jreg)
    with pytest.raises(ValueError, match="empty"):
        tr.recalibrate("acts", np.zeros(256))


def _controllers(cfg, name="acts"):
    jreg, treg = _pair(name=name)
    return (jreg, treg, jad.AdaptiveController(jreg, drift=jad.DriftConfig(
        **cfg)), tad.AdaptiveController(treg, drift=tad.DriftConfig(**cfg)))


@pytest.mark.parametrize("cfg", ALL_CFGS[1:])
def test_controller_swaps_and_rebinds_like_reference(cfg):
    jreg, treg, jc, tc = _controllers(cfg)
    ach = tc.wrap(Channel(ChannelSpec(codec="acts"), registry=treg))
    first = ach.channel
    assert ach.entry is treg["acts"]
    seq = [ffn1_counts(1 << 14, 1)] * 2 + [ffn2_counts(1 << 14, 4)] * 6 \
        + [_hostile(jreg)] * 3 + [ffn2_counts(1 << 14, 4)] * 6
    for hist in seq:
        jc.observe("acts", hist)
        tc.observe("acts", hist)
        a, b = jc.check(), tc.check()
        assert [dataclasses.asdict(e) for e in a] == \
            [dataclasses.asdict(e) for e in b]
        _same_registry(jreg, treg)
        assert ach.entry is treg["acts"]
    assert tc.events and len(tc.events) == len(jc.events)
    assert first.entry.scheme_id == 0                # old view unchanged
    assert treg.by_id(0) is first.entry
    with pytest.raises(ValueError, match="name"):
        tc.wrap(Channel(ChannelSpec(codec=treg["acts"].tables,
                                    cfg=treg["acts"].config())))


def test_converged_recalibration_does_not_swap_like_reference():
    cfg = ALL_CFGS[3]
    jreg, treg, jc, tc = _controllers(cfg)
    shifted = ffn2_counts(1 << 14, 4)
    for _ in range(2):
        jc.observe("acts", shifted)
        tc.observe("acts", shifted)
        assert [dataclasses.asdict(e) for e in jc.check()] == \
            [dataclasses.asdict(e) for e in tc.check()]
    assert len(tc.events) == 1 and len(treg) == len(jreg) == 2


@pytest.mark.parametrize("every", [1, 4])
def test_training_adapter_boundaries_match_reference(every):
    cfg = dict(min_events=2, hysteresis=2, cooldown=0, min_symbols=1024)
    jreg, treg, jc, tc = _controllers(cfg, name="grads")
    jbuilds, tbuilds = [], []
    ja = jad.TrainingAdapter(jc, lambda: jbuilds.append(1) or "rebuilt",
                             grad_key="grads", check_every=every)
    ta = tad.TrainingAdapter(tc, lambda: tbuilds.append(1) or "rebuilt",
                             grad_key="grads", check_every=every)
    bad = _hostile(jreg, "grads")
    outs = []
    for step in range(8):
        m = {"adapt/grads_hist": bad.astype(np.int32)}
        a = ja(step, m)
        b = ta(step, {"adapt/grads_hist": torch.from_numpy(
            bad.astype(np.int32))})
        assert a == b, step
        outs.append(b)
        if (step + 1) % every:
            assert b is None
    assert "rebuilt" in outs and jbuilds == tbuilds
    assert [dataclasses.asdict(e) for e in jc.events] == \
        [dataclasses.asdict(e) for e in tc.events]
    assert [c["step"] for c in ta.checks] == \
        [s for s in range(8) if (s + 1) % every == 0]
    assert any(c["flagged"] for c in ta.checks)


def test_training_adapter_returns_none_without_a_swap():
    cfg = dict(min_events=2, hysteresis=2, cooldown=0, min_symbols=1024)
    jreg, treg, jc, tc = _controllers(cfg, name="grads")
    ta = tad.TrainingAdapter(tc, lambda: "rebuilt", grad_key="grads",
                             check_every=2)
    good = np.asarray(treg["grads"].counts).astype(np.int32)
    for step in range(6):
        assert ta(step, {"adapt/grads_hist": good}) is None
    assert tc.events == [] and not any(c["flagged"] for c in ta.checks)


def test_training_adapter_counts_overflows():
    """With the step's overflow counts in the metrics each observation
    is one container; overflowing steps flag the binding by the overflow
    trigger alone (the histogram matches the plan)."""
    cfg = dict(min_events=2, hysteresis=2, cooldown=0, min_symbols=1024)
    _, treg, _, tc = _controllers(cfg, name="grads")
    ta = tad.TrainingAdapter(tc, lambda: "rebuilt", grad_key="grads",
                             check_every=1)
    good = torch.from_numpy(np.asarray(treg["grads"].counts).astype(
        np.int32))
    m = {"adapt/grads_hist": good,
         "adapt/grads_overflow": torch.tensor(1, dtype=torch.int32)}
    assert [ta(s, m) for s in range(2)] == [None, None]
    t = tc.monitor.traffic("grads")
    assert t.containers > 0 and t.overflow_rate == 1.0
    assert ta(2, m) == "rebuilt" and tc.monitor.traffic("grads") is None


# --------------------------------------------------------------------------
# Registry revisions
# --------------------------------------------------------------------------

def test_register_revision_noop_collision_and_plan_only_revision():
    _, treg = _pair()
    cur = treg["acts"]
    assert treg.register_revision("acts", cur.tables, cur.plan) is cur
    assert len(treg) == 1
    wider = dataclasses.replace(cur.plan,
                                capacity_words=cur.plan.capacity_words + 1)
    rev = treg.register_revision("acts", cur.tables, wider)
    assert rev.scheme_id == 1 and treg["acts"] is rev
    assert treg.by_id(0) is cur and cur.plan != wider
    counts = ffn2_counts(1 << 14, 9)
    tables = jadapt.calibrate_tables(counts)
    plan = CommPlan(**dataclasses.asdict(
        jplan_for_tables(tables, counts, chunk_symbols=CHUNK)))
    with pytest.raises(ValueError, match="acts"):
        treg.register_tables("acts", tables, plan)
    fresh = treg.register_revision("other", tables, plan)
    assert fresh.scheme_id == 2 and treg["other"] is fresh


def test_registry_json_with_revisions_loads_both_ways():
    jreg, treg = _pair(drift_margin_bits=0.25)
    for i, counts in enumerate((ffn2_counts(1 << 14, 9), grad_counts(
            1 << 14, 4))):
        jad.Recalibrator(jreg).recalibrate("acts", counts)
        tad.Recalibrator(treg).recalibrate("acts", counts)
    treg.register("params", ffn1_counts(1 << 14, 5), chunk_symbols=CHUNK)
    jreg.register("params", ffn1_counts(1 << 14, 5), chunk_symbols=CHUNK)
    _same_registry(jreg, treg)
    _same_registry(JRegistry.from_json(treg.to_json()), treg)
    _same_registry(jreg, CodecRegistry.from_json(jreg.to_json()))
    assert treg["acts"].scheme_id == 2
    assert CodecRegistry.from_json(treg.to_json())["acts"].scheme_id == 2


# --------------------------------------------------------------------------
# Payloads under an old scheme-id decode after a swap
# --------------------------------------------------------------------------

def test_old_id_containers_decode_after_swap():
    """A codes container and a values container written under scheme A
    (the values one by the reference) decode bit for bit after the port's
    controller swapped the name to scheme B; a stream of an old-id and a
    new-id section decodes in one stacked pass."""
    jreg, treg = _pair()
    entry_a = treg["acts"]
    syms = torch.from_numpy(np.random.default_rng(2).choice(
        256, CHUNK * 8, p=ffn1_counts(1 << 14, 0) / (1 << 14)).astype(
            np.uint8))
    codes_a = tqc.encode_codes(syms, entry_a)
    values = np.random.default_rng(3).normal(size=CHUNK * 8).astype(
        np.float32)
    vals_a = jqc.encode_values(values, jreg["acts"])
    ref_vals = np.asarray(jqc.decode_values(vals_a, jreg)[0])

    tc = tad.AdaptiveController(treg, drift=tad.DriftConfig(
        min_events=2, hysteresis=2, cooldown=0, min_symbols=1024))
    for _ in range(4):
        tc.observe("acts", ffn2_counts(1 << 14, 2))
        tc.check()
    entry_b = treg["acts"]
    assert entry_b.scheme_id != entry_a.scheme_id and len(tc.events) == 1

    got, ok, _ = tqc.decode_codes(codes_a, treg, device="cpu")
    assert ok and torch.equal(got, syms)
    got, ok, _ = tqc.decode_values(vals_a, treg, device="cpu")
    assert ok
    np.testing.assert_array_equal(got.numpy(), ref_vals)
    codes_b = tqc.encode_codes(syms, entry_b, pool_slots_per_1k=1024)
    both = tqc.decode_codes_stream(tqc.pack_stream([codes_a, codes_b]),
                                   treg, device="cpu")
    assert [bool(ok) for _, ok in both] == [True, True]
    for out, _ in both:
        assert torch.equal(out, syms)


# --------------------------------------------------------------------------
# The paged KV cache's monitor
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,exact,overflow", [
    ("qlc", True, False), ("qlc", False, False), ("e4m3", True, False),
    ("qlc", False, True)])
def test_kv_monitor_matches_reference(mode, exact, overflow):
    """The same blocks through the reference's and the port's paged
    caches (calibrated on the same tensors) with a monitor each: every
    section's counts, escaped chunks, chunk count and overflow land in
    equal ledgers. ``overflow``: one-word slots and a one-slot pool, so
    every coded section overflows and goes raw."""
    from tests.test_torch_kv import _block, _caches
    jc, tc, jarr, tarr = _caches(mode, exact)
    if overflow:
        for reg in (jc.registry, tc.registry):
            for name in reg.names():
                e = reg[name]
                object.__setattr__(e, "plan", dataclasses.replace(
                    e.plan, capacity_words=1, pool_slots_per_1k=1,
                    expected_bits_per_symbol=0.1, escape_prob_bound=0.0))
        tc = tc.__class__(tc.spec, tc.cfg, tc.registry, device="cpu")
        jc = jc.__class__(jc.spec, jc.cfg, jc.registry)
    jc.monitor = jad.TrafficMonitor(jc.registry)
    tc.monitor = tad.TrafficMonitor(tc.registry)
    name = tc.spec.layer_codec(0)
    for t0 in (0, 4, 8):
        jc.encode_block_arrays(name, "l0", _block(jarr, t0, t0 + 4),
                               start=t0, tokens=4)
        tc.encode_block_arrays(name, "l0", _block(tarr, t0, t0 + 4),
                               start=t0, tokens=4)
    assert tc.overflow_sections == jc.overflow_sections
    assert (tc.overflow_sections > 0) == overflow
    keys = sorted(jc.monitor._traffic)
    assert keys == sorted(tc.monitor._traffic) and keys
    for key in keys:
        assert _traffic(jc.monitor._traffic[key]) == \
            _traffic(tc.monitor._traffic[key])
    assert jc.monitor.snapshot() == tc.monitor.snapshot()


def test_serve_with_a_kv_monitor():
    """``serve(..., kv_monitor=True)``: the engine's paged cache files
    every encoded section with the returned monitor."""
    from repro_torch.launch import serve
    cfg = reduced(get_config("phi3-mini-3.8b"), d_model=128, d_ff=512)
    res = serve.serve(cfg, batch=2, requests=2, prompt_len=8, new_tokens=8,
                      kv_cache="qlc", kv_block=4, device="cpu",
                      kv_monitor=True)
    mon = res["kv_monitor"]
    rows = mon.snapshot()
    assert rows and all(r["events"] > 0 and r["measured_bits"] > 0
                        for r in rows)
    assert {r["name"] for r in rows} <= set(mon.registry.names())


# --------------------------------------------------------------------------
# The compressed step's telemetry
# --------------------------------------------------------------------------

CFG_KW = dict(d_model=128, dtype="float32")


def _closure(fn):
    """The free variables of a closure, by name."""
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def test_telemetry_histograms_match_reference_step():
    """One compressed step of reduced phi3 with telemetry: the wire and
    update half (the reference's ``stage2``, a shard_map on a 1 x 1 data
    x model mesh; the port's ``stage2`` on one gloo rank, K1's plain
    version) from the same parameters, registry (the port's, loaded by
    the reference from its JSON) and gradients (the reference's stage 1:
    the two frameworks' gradients differ in their last bits, which moves
    a few e4m3 codes) gives equal gradient and parameter wire histograms,
    each summing to the padded flat length, and equal parameters."""
    jcfg = jreduced(jget_config("phi3-mini-3.8b"), **CFG_KW)
    tcfg = reduced(get_config("phi3-mini-3.8b"), **CFG_KW)
    jp = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    data = SyntheticDataset(DataConfig(vocab_size=256, seq_len=32,
                                       global_batch=4))
    opt_kw = dict(lr=3e-4, total_steps=3, warmup_steps=10)
    with data_parallel("cpu") as group:
        treg = train_mod.calibrate_registry(tcfg, tp, data.batch_at(0),
                                            group)
    jreg = JRegistry.from_json(treg.to_json())
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    jopt_cfg = jopt.OptConfig(**opt_kw)
    free = _closure(jmake_step(jcfg, jopt_cfg, JTrainConfig(), mesh, jreg,
                               telemetry=True))
    batch = {k: jnp.asarray(v) for k, v in data.batch_at(0).items()}
    with shd.use_mesh(mesh):
        jo = jinit_opt(jcfg, mesh, JTrainConfig(), jreg, jopt_cfg)
        _, jgrads = jax.jit(free["stage1"])(jp, batch)
        jout = jax.jit(free["stage2"])(jp, jgrads, jo)
    grads = params_from_numpy(jax.tree.map(lambda g: np.asarray(g[0]),
                                           jgrads), "cpu")
    with data_parallel("cpu") as group:
        step = make_compressed_step(tcfg, OptConfig(**opt_kw), TrainConfig(),
                                    group, treg, telemetry=True)
        o = init_compressed_opt_state(tp, group, treg, OptConfig(**opt_kw))
        new, _, tm = step.stage2(tp, grads, o)
        n = step.geometry(tp).n_padded
    assert bool(tm["ok"]) and bool(jout[2])
    for key, got in (("adapt/grads_hist", jout[5]),
                     ("adapt/params_hist", jout[6])):
        np.testing.assert_array_equal(tm[key].numpy(), np.asarray(got))
        assert int(tm[key].sum()) == n
    assert int(tm["adapt/grads_overflow"]) == 0
    assert int(tm["adapt/params_overflow"]) == 0
    a = np.concatenate([np.asarray(x).reshape(-1)
                        for x in jax.tree.leaves(jout[0])])
    b = np.concatenate([x.reshape(-1).numpy() for x in pytree_leaves(new)])
    np.testing.assert_array_equal(a, b)


def test_telemetry_step_is_bit_identical_on_two_ranks():
    """2 gloo ranks, 2 steps: parameters and ZeRO-1 moments with
    telemetry equal the plain step's bit for bit; each step's gradient
    histogram is the sum of the two ranks' own gradient symbol counts,
    the parameter histogram counts every padded value once, and both
    ranks see the same numbers."""
    out = run_ranks("telemetry_runs", 2, cfg_kw=CFG_KW, steps=2, seq_len=16,
                    global_batch=4)
    n = out[0]["n_padded"]
    for r in out:
        plain, tel = r["plain"], r["telemetry"]
        for a, b in zip(plain, tel[:3]):
            np.testing.assert_array_equal(a, b)
    for s in range(2):
        local = out[0]["telemetry"][4][s] + out[1]["telemetry"][4][s]
        for r in out:
            gh, ph, go, po = r["telemetry"][3][s]
            np.testing.assert_array_equal(gh, local)
            np.testing.assert_array_equal(ph, out[0]["telemetry"][3][s][1])
            assert gh.sum() == 2 * n and ph.sum() == n
            assert int(go) == int(po) == 0


def test_overflowing_step_keeps_its_telemetry_through_the_fallback():
    """The overflowing registry of ``test_overflowing_wire_falls_back_to
    _the_baseline_step`` (one-word slots, a one-slot pool) with
    ``adapt``: every compressed attempt falls back to the baseline step,
    and the adapter still sees each attempt's histograms and overflow:
    it flags ``"grads"`` (the overflow trigger), swaps it at step 3, and
    the rebuilt step's traffic is filed under the new scheme-id. (The
    revision's escape pool, sized on an iid draw from the histogram,
    still overflows on this model's gradients, whose escapes cluster:
    the calibration's pool held every chunk.)"""
    tcfg = reduced(get_config("phi3-mini-3.8b"), **CFG_KW)
    good = train_mod.train(tcfg, comm="qlc", steps=0, seq_len=16,
                           global_batch=2, device="cpu")["registry"]
    g = good["grads"]
    reg = CodecRegistry()
    reg.register_tables("grads", g.tables, CommPlan(
        chunk_symbols=1024, capacity_words=1, pool_slots_per_1k=1,
        expected_bits_per_symbol=g.plan.expected_bits_per_symbol,
        escape_prob_bound=1.0))
    reg.register_tables("params", good["params"].tables, good["params"].plan)
    res = train_mod.train(tcfg, comm="qlc", registry=reg, steps=4,
                          seq_len=16, global_batch=2, device="cpu",
                          adapt=True, adapt_every=1)
    ev = res["adapt"]["events"]
    assert [(e.name, e.old_scheme_id, e.new_scheme_id) for e in ev] == \
        [("grads", 0, 2)]
    assert res["comm_fallbacks"] == 4
    checks = [c for c in res["adapt"]["checks"] if c["name"] == "grads"]
    assert [c["scheme_id"] for c in checks] == [0, 0, 0, 2]
    assert [c["flagged"] for c in checks] == [False, False, True, False]
    assert all(c["measured_bits"] is not None for c in checks)
    t = res["adapt"]["controller"].monitor.traffic("grads", 2)
    assert t.events == 1 and t.overflow_rate == 1.0
    assert res["registry"]["grads"].plan.chunk_symbols == 1024
