"""Run a function of this module in several gloo ranks, each its own
process (``python -m tests.torch_dist``), and collect what each returns.

The children import torch, numpy and the port only. Arguments and
results travel as pickles in a temporary directory; every rank gets the
same arguments and finds its rank and the world size in ``ctx``.

Also the bit-exact tree comparison that the port's tests share
(:func:`assert_same_tree`).
"""
import os
import pickle
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(target: str, world: int, timeout: int = 300, **kwargs):
    """``target(ctx, **kwargs)`` on ``world`` gloo ranks -> [result of
    rank 0, rank 1, ...]."""
    from repro_torch.launch.mesh import free_port
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.join(REPO, "src"), env.get("PYTHONPATH", "")])
    env.setdefault("OMP_NUM_THREADS", "1")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(kwargs, f)
        init = f"tcp://localhost:{free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dist", target, str(r),
             str(world), init, tmp], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        bad = [(r, p.returncode) for r, p in enumerate(procs)
               if p.returncode != 0]
        if bad:
            raise AssertionError(f"ranks failed {bad}:\n" + "\n".join(logs))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def one_cpu_thread():
    """One intra-op thread for this test process. The port's CPU tests run
    many small ops, in several test processes at once (pytest-xdist) on a
    few cores, where torch's default of one thread a core made every op
    wait on threads the other processes had descheduled: an engine run of
    ``test_torch_tp_serve`` took 23.9 s with 8 threads and 2.0 s with 1,
    each einsum 7.2 ms against 0.06 ms. The ranks of :func:`run_ranks`
    set the same."""
    import torch
    torch.set_num_threads(1)


def flat_tree(tree, prefix=""):
    """A nested dict -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat_tree(v, key) if isinstance(v, dict) else {key: v})
    return out


def tree_bits(a):
    """Bit patterns of a numpy array (either package's dtypes) or a CPU
    tensor, for exact comparison: bf16 as int16, f32 and uint32 as
    int32."""
    import numpy as np
    import torch
    if isinstance(a, torch.Tensor):
        a = a.detach()
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a


def assert_same_tree(a, b):
    """Two nested dicts hold the same keys and bit-equal leaves."""
    import numpy as np
    fa, fb = flat_tree(a), flat_tree(b)
    assert sorted(fa) == sorted(fb)
    for key in fa:
        np.testing.assert_array_equal(tree_bits(fa[key]), tree_bits(fb[key]),
                                      err_msg=key)


def numpy_tree(tree):
    """A nested dict of tensors -> the same of numpy copies."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def opt_numpy(opt):
    """An optimizer state as numpy: ``m`` and ``v`` (flat segments or
    trees) and ``step`` as an int."""
    out = {k: numpy_tree(opt[k]) for k in ("m", "v")}
    out["step"] = int(opt["step"])
    return out


def wait_for(path: str, timeout: float = 240.0):
    """Block until ``path``, which another process writes, exists (at most
    ``timeout`` seconds, then ``TimeoutError``)."""
    import time
    end = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


def _main():
    target, rank, world, init, tmp = sys.argv[1:6]
    rank, world = int(rank), int(world)
    one_cpu_thread()
    from repro_torch.launch.mesh import data_parallel
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    with data_parallel("cpu", rank=rank, world_size=world,
                       init_method=init) as group:
        ctx = {"rank": rank, "world": world, "group": group}
        out = globals()[target](ctx, **kwargs)
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# Targets
# --------------------------------------------------------------------------

def collectives_of(ctx, xs, counts, cfg_kw, variants):
    """Compressed RS of ``xs[rank]`` and AG of its first ``n_ag`` values
    under each transport variant -> {variant: (segment, valid, rs_ok,
    gathered, ag_ok)} as numpy."""
    import numpy as np
    import torch
    from repro_torch.comm.channel import Channel, ChannelSpec
    from repro_torch.comm.compressed import CommConfig
    from repro_torch.comm.planner import TransportConfig
    from repro_torch.core import lut, schemes
    tables = lut.build_tables(np.asarray(counts), schemes.TABLE1)
    x = torch.from_numpy(np.asarray(xs[ctx["rank"]]))
    out = {}
    for kind, h in variants:
        ch = Channel(ChannelSpec(codec=tables, cfg=CommConfig(**cfg_kw),
                                 transport=TransportConfig(kind, h),
                                 group=ctx["group"]))
        r = ch.reduce_scatter(x)
        n_ag = x.shape[0] // ctx["world"]
        full, ok = ch.all_gather(x[:n_ag])
        out[(kind, h)] = (r.segment.numpy(), r.valid, bool(r.ok),
                          full.numpy(), bool(ok))
    return out


def psum_a2a(ctx, xs, ys, counts, cfgs, variants, tune_bytes):
    """Compressed psum of ``xs[rank]`` and all-to-all of ``ys[rank]``
    ([world, n]) under each config and transport variant -> {(name, kind,
    h): (psum, ok, a2a, ok)}; then ``Channel.autotune`` of a ``"grads"``
    (reduce-scatter) and a ``"params"`` channel (gather), each probing the
    wire, at ``tune_bytes`` with the decode probe stubbed at 2e6 B/s ->
    out["tuned"] = (registry JSON, {name: (kind, hop_chunks, the wire
    rate it was tuned on)}, {name: what a fresh "auto" channel resolves
    to, and the same rate})."""
    import numpy as np
    import torch
    from repro_torch.comm import channel as chm
    from repro_torch.comm.channel import Channel, ChannelSpec
    from repro_torch.comm.compressed import CommConfig
    from repro_torch.comm.planner import TransportConfig
    from repro_torch.core import CodecRegistry, lut, schemes
    tables = lut.build_tables(np.asarray(counts), schemes.TABLE1)
    x = torch.from_numpy(np.asarray(xs[ctx["rank"]]))
    y = torch.from_numpy(np.asarray(ys[ctx["rank"]]))
    out = {}
    for name, kw in cfgs.items():
        for kind, h in variants:
            ch = Channel(ChannelSpec(codec=tables, cfg=CommConfig(**kw),
                                     transport=TransportConfig(kind, h),
                                     group=ctx["group"]))
            s, ok = ch.psum(x)
            a, ok2 = ch.all_to_all(y)
            out[(name, kind, h)] = (s.numpy(), bool(ok), a.numpy(),
                                    bool(ok2))
    reg = CodecRegistry()
    reg.register("grads", np.asarray(counts))
    reg.register("params", np.asarray(counts)[::-1].copy())
    chm.measure_decode_Bps = lambda *a, **k: (2e6, 0.0)
    tuned, resolved = {}, {}
    world = ctx["world"]
    for name, is_reduce in (("grads", True), ("params", False)):
        ch = Channel(ChannelSpec(codec=name, transport="auto",
                                 group=ctx["group"]), registry=reg)
        got = ch.autotune(tune_bytes, is_reduce=is_reduce, device="cpu")
        t = got.transport
        tuned[name] = (t.kind, t.hop_chunks, got.model.wire_Bps)
        n_values = tune_bytes // 4 * (world if is_reduce else 1)
        r = ch.resolved_transport(n_values, is_reduce=is_reduce)
        resolved[name] = (r.kind, r.hop_chunks, got.model.wire_Bps)
    out["tuned"] = (reg.to_json(), tuned, resolved)
    return out


def wire_four(ctx, collectives, psum):
    """:func:`collectives_of` each of ``collectives["cfgs"]``, and
    :func:`psum_a2a` (``psum``, its keywords) in one world -> {
    "collectives": {name: ...}, "psum": ...}."""
    c = dict(collectives)
    cfgs = c.pop("cfgs")
    return {"collectives": {name: collectives_of(ctx, cfg_kw=kw, **c)
                            for name, kw in cfgs.items()},
            "psum": psum_a2a(ctx, **psum)}


def train_runs(ctx, cfg_kw, steps, global_batch, seq_len, lr, runs):
    """Train the reduced config for ``steps`` under each of ``runs``
    ((name, comm, transport, wire_enabled)) from the same start and codec
    registry -> {name: (losses, oks, fallbacks, flat params)}.

    The registry's pools hold every chunk: this model's flat gradient is
    a few dozen chunks per rank, so the calibrated one-slot pool could
    overflow, and the runs compare the wire, not the fallback."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import CodecRegistry
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import pytree_leaves
    cfg = reduced(get_config("phi3-mini-3.8b"), **cfg_kw)
    calibrated = train(cfg, comm="qlc", steps=0, seq_len=seq_len,
                       global_batch=global_batch, device="cpu")["registry"]
    registry = CodecRegistry()
    for name in ("grads", "params"):
        e = calibrated[name]
        registry.register_tables(name, e.tables, dataclasses.replace(
            e.plan, pool_slots_per_1k=1024), counts=e.counts)
    out = {}
    for name, comm, transport, enabled in runs:
        res = train(cfg, comm=comm, steps=steps, seq_len=seq_len,
                    global_batch=global_batch, transport=transport, lr=lr,
                    device="cpu", registry=registry, wire_enabled=enabled)
        flat = torch.cat([p.reshape(-1) for p in
                          pytree_leaves(res["params"])]).numpy()
        out[name] = ([h["loss"] for h in res["history"]],
                     [h["ok"] for h in res["history"]],
                     res["comm_fallbacks"], flat)
    return out


def train_resume(ctx, cfg_kw, steps, every, root, single_root):
    """Compressed training of the reduced config for ``steps`` with
    checkpoints every ``every`` steps into the one directory ``root``;
    then the newest step's directory is removed (its ``latest`` pointer
    left naming it), as if the run had died while committing it, and the
    same launch runs again. Last, a launch into ``single_root``, which
    holds (once the caller's one-rank run has written them) that run's
    checkpoints -> (start step of the second run,
    flat parameters after the first run, after the second, the message
    of the third's ValueError, the names in ``root``)."""
    import os
    import shutil
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import pytree_leaves
    cfg = reduced(get_config("phi3-mini-3.8b"), **cfg_kw)
    kw = dict(comm="qlc", steps=steps, seq_len=16, global_batch=4,
              device="cpu", checkpoint_every=every)

    def flat(res):
        return torch.cat([p.reshape(-1) for p in
                          pytree_leaves(res["params"])]).numpy()

    first = flat(train(cfg, checkpoint_dir=root, **kw))
    names = sorted(os.listdir(root))
    torch.distributed.barrier(group=ctx["group"])
    if ctx["rank"] == 0:
        shutil.rmtree(os.path.join(root, f"step_{steps:010d}"))
    torch.distributed.barrier(group=ctx["group"])
    res = train(cfg, checkpoint_dir=root, **kw)
    wait_for(os.path.join(single_root, "latest"))
    try:
        train(cfg, checkpoint_dir=single_root, **kw)
        refused = None
    except ValueError as e:
        refused = str(e)
    return res["start_step"], first, flat(res), refused, names


def train_four(ctx, runs, recipe_steps):
    """:func:`train_runs` (``runs``, its keywords) and
    :func:`reference_recipe` in one world -> {"runs": ..., "recipe":
    ...}."""
    return {"runs": train_runs(ctx, **runs),
            "recipe": reference_recipe(ctx, recipe_steps)}


def reference_recipe(ctx, steps):
    """The reference's own training check (``tests/test_train_integration
    .py``): reduced deepseek-coder-33b (d_model 64, 2 layers, bf16
    compute), AdamW lr 1e-2 with 2 warmup steps and clip 1.0, 2
    microbatches, global batch 8 x 16 tokens from seed 3, gradient codec
    calibrated on the first batch at 256-symbol chunks with a pool for
    every chunk; the baseline and the compressed step side by side ->
    (baseline losses, compressed losses, compressed oks)."""
    import dataclasses
    import torch
    from repro_torch.comm.calibrate import calibrate_for_gradients
    from repro_torch.comm.compressed import CommConfig
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.models import init_params
    from repro_torch.training import (OptConfig, TrainConfig,
                                      init_compressed_opt_state,
                                      make_baseline_step,
                                      make_compressed_step)
    from repro_torch.training import optimizer as optm
    cfg = reduced(get_config("deepseek-coder-33b"), d_model=64,
                  num_layers=2)
    opt_cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=50,
                        grad_clip=1.0)
    train_cfg = TrainConfig(microbatches=2)
    data = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=16, global_batch=8, seed=3))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b0 = {k: torch.as_tensor(v) for k, v in data.batch_at(0).items()}
    tables, plan = calibrate_for_gradients(cfg, params, b0,
                                           chunk_symbols=256)
    comm_cfg = dataclasses.replace(CommConfig.from_plan(plan),
                                   pool_slots_per_1k=1024)
    base = make_baseline_step(cfg, opt_cfg, train_cfg)
    comp = make_compressed_step(cfg, opt_cfg, train_cfg, None, tables,
                                comm_cfg)
    pb, ob = params, optm.init_state(params, opt_cfg)
    pc = params
    oc = init_compressed_opt_state(params, None, comm_cfg, opt_cfg)
    lb, lc, oks = [], [], []
    for s in range(steps):
        batch = data.batch_at(s)
        pb, ob, mb = base(pb, ob, batch)
        pc, oc, mc = comp(pc, oc, batch)
        lb.append(float(mb["loss"]))
        lc.append(float(mc["loss"]))
        oks.append(bool(mc["ok"]))
    return lb, lc, oks


def telemetry_runs(ctx, cfg_kw, steps, seq_len, global_batch):
    """The compressed step of the reduced config without and with wire
    telemetry, ``steps`` steps each from the same start and registry ->
    {"plain": (flat params, m, v), "telemetry": (flat params, m, v,
    [(grads hist, params hist, overflow counts), ...] per step, [this
    rank's own gradient symbol histogram per step]), "n_padded": ...}."""
    import dataclasses
    import torch
    from repro_torch.comm.calibrate import quantized_symbols
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import CodecRegistry
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.train import calibrate_registry
    from repro_torch.models import init_params
    from repro_torch.models.transformer import pytree_leaves
    from repro_torch.training import (OptConfig, TrainConfig,
                                      init_compressed_opt_state,
                                      make_compressed_step)
    from repro_torch.training.train_step import _flatten_local
    cfg = reduced(get_config("phi3-mini-3.8b"), **cfg_kw)
    group = ctx["group"]
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    data = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=seq_len,
                                       global_batch=global_batch))
    calibrated = calibrate_registry(cfg, params, data.batch_at(0), group)
    reg = CodecRegistry()              # pools for every chunk, as above
    for name in ("grads", "params"):
        e = calibrated[name]
        reg.register_tables(name, e.tables, dataclasses.replace(
            e.plan, pool_slots_per_1k=1024), counts=e.counts)
    opt_cfg = OptConfig(lr=1e-3, total_steps=steps, warmup_steps=1)
    out = {}
    for name, telemetry in (("plain", False), ("telemetry", True)):
        step = make_compressed_step(cfg, opt_cfg, TrainConfig(), group,
                                    reg, telemetry=telemetry)
        p = params
        o = init_compressed_opt_state(params, group, reg, opt_cfg)
        n = step.geometry(p).n_padded
        seen, local = [], []
        for s in range(steps):
            batch = data.batch_at(s)
            if telemetry:
                _, grads = step.stage1(p, batch)
                local.append(ops.histogram(quantized_symbols(
                    _flatten_local(grads, n))).numpy())
            p, o, m = step(p, o, batch)
            assert bool(m["ok"])
            if telemetry:
                seen.append(tuple(m[k].numpy() for k in (
                    "adapt/grads_hist", "adapt/params_hist",
                    "adapt/grads_overflow", "adapt/params_overflow")))
            else:
                assert not any(k.startswith("adapt/") for k in m)
        flat = torch.cat([t.reshape(-1) for t in pytree_leaves(p)]).numpy()
        out[name] = (flat, o["m"].numpy(), o["v"].numpy())
        if telemetry:
            out[name] += (seen, local)
        out["n_padded"] = n
    return out


def moe_layouts(ctx, models, train_kw, **kw):
    """:func:`moe_layout` on each of ``models`` in one world, with
    ``train_kw`` for those in it -> {model: result}."""
    return {model: moe_layout(ctx, model=model,
                              train_kw=train_kw.get(model), **kw)
            for model in models}


def moe_layout(ctx, model, cfg_kw, params, x, registry_json, train_kw):
    """Expert parallelism on a ``data x model`` layout of the world
    (``launch.mesh.make_test_mesh(model=model)``): this rank takes its
    data shard of ``x`` [B, S, D] (rows of the batch; a model row shares
    it, and ``shardmap_a2a`` cuts its tokens over the row) and its blocks
    of ``params`` (one MoE FFN, numpy, cut by its resolved specs), the
    batch declared over the data column (``moe.batch_over``). Runs
    ``shardmap_a2a`` raw, raw at capacity factor 0.25, and on the QLC
    wire (one-shot, ring, and the raw e4m3 twin of one-shot) with the
    channels of ``registry_json`` on the model axis, keeping this rank's
    piece of the output (its tokens); then the gradients of
    ``sum(y ** 2)`` raw (summed over the data column) and on the QLC wire
    (this rank's own); then, when ``train_kw`` is given,
    ``launch.train.train`` over the mesh -> dict of numpy results."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.comm.channel import Channel, ChannelSpec
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.convert import params_from_numpy, shard_params
    from repro_torch.core import CodecRegistry
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.models import moe
    from repro_torch.models.transformer import pytree_leaves
    mesh = make_test_mesh(model=model)
    assert mesh.shape == {"data": ctx["world"] // model, "model": model}
    cfg = ModelConfig(moe=MoEConfig(**cfg_kw["moe"], impl="shardmap_a2a"),
                      **cfg_kw["model"])
    d_idx, m_idx = mesh.coords
    p = shard_params(params_from_numpy(params, "cpu"), cfg, m_idx, model,
                     specs=moe.moe_param_specs(cfg))
    rows = x.shape[0] // mesh.data
    xl = torch.from_numpy(np.ascontiguousarray(
        x[d_idx * rows:(d_idx + 1) * rows]))
    ng = rows * x.shape[1] // model
    reg = CodecRegistry.from_json(registry_json)

    def chans(transport, enabled=True):
        return {name: Channel(ChannelSpec(
            codec=name, transport=transport, axis="model",
            enabled=None if enabled else False), registry=reg)
            for name in (moe.MOE_DISPATCH, moe.MOE_COMBINE)}

    def run(c, channels=None, routing=None, params=p):
        with use_mesh(mesh), moe.bind_moe_channels(channels), \
                moe.batch_over(mesh.data_group), \
                moe.capture_moe_routing([] if routing is None else routing):
            return moe.moe_block(params, xl, c)

    def piece(y):
        return y.reshape(-1, y.shape[-1])[m_idx * ng:(m_idx + 1) * ng].numpy()

    out = {}
    with torch.no_grad():
        routing = []
        out["raw"] = piece(run(cfg, routing=routing))
        out["idx"] = routing[0]["idx"].numpy()
        out["keep"] = routing[0]["keep"].numpy()
        c_of = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.25))
        routing = []
        out["raw_cf025"] = piece(run(c_of, routing=routing))
        out["keep_cf025"] = routing[0]["keep"].numpy()
        with use_mesh(mesh):        # channels from the mesh in scope
            qlc = {t: chans(t) for t in ("oneshot", "ring")}
            twin = chans("oneshot", enabled=False)
        out["qlc"] = piece(run(cfg, qlc["oneshot"]))
        out["ring"] = piece(run(cfg, qlc["ring"]))
        out["twin"] = piece(run(cfg, twin))

    def grads(channels=None):
        live = [t.clone().requires_grad_(True) for t in pytree_leaves(p)]
        from repro_torch.models.transformer import pytree_unflatten
        tree = pytree_unflatten(p, live)
        y = run(cfg, channels, params=tree)
        return torch.autograd.grad((y ** 2).sum(), live)

    g_raw = []
    for g in grads():
        g = g.clone()
        torch.distributed.all_reduce(g, group=mesh.data_group)
        g_raw.append(g.numpy())
    out["grads_raw"] = g_raw
    out["grads_qlc"] = [g.numpy() for g in grads(qlc["oneshot"])]
    if train_kw is not None:
        from repro_torch.configs import get_config, reduced
        from repro_torch.launch.train import train
        tcfg = reduced(get_config("deepseek-moe-16b"), **train_kw["cfg"])
        with use_mesh(mesh):
            for name, wire in (("qlc", "qlc"), ("raw_ep", "raw")):
                c = tcfg if wire == "qlc" else dataclasses.replace(
                    tcfg, moe=dataclasses.replace(tcfg.moe,
                                                  impl="shardmap_a2a"))
                res = train(c, comm="baseline", moe_wire=wire,
                            device="cpu", **train_kw["run"])
                out[f"train_{name}"] = [h["loss"] for h in res["history"]]
                if wire == "qlc":
                    out["train_moe"] = res["moe"]
    return out


def moe_groups(ctx, cfg_kw, params, x, groups, train_kw):
    """``grouped_local`` over the data column of this world (``W x 1``),
    the batch declared over it (``moe.batch_over``): this rank takes its
    rows of ``x`` [B, S, D] and runs one MoE FFN (``params``, numpy) as
    ``gspmd`` and as ``grouped_local`` at each of ``groups`` dispatch
    groups, keeping its output, its routing's kept assignments and the
    gradients of ``sum(y ** 2)`` summed over the column; then
    ``launch.train.train`` of reduced deepseek-moe-16b (``train_kw``:
    ``cfg`` overrides and ``run`` keywords) as ``gspmd`` and as
    ``grouped_local`` at one group -> {impl: (y, keep, grads)}, and
    ``"train"``: {impl: (losses, the final parameters' leaves)}."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import moe
    from repro_torch.models.transformer import (pytree_leaves,
                                                pytree_unflatten)
    mesh = make_test_mesh(model=1)
    rows = x.shape[0] // mesh.data
    d = mesh.coords[0]
    xl = torch.from_numpy(np.ascontiguousarray(x[d * rows:(d + 1) * rows]))
    p = params_from_numpy(params, "cpu")
    out = {}
    for impl, g in [("gspmd", 1)] + [("grouped_local", g) for g in groups]:
        cfg = ModelConfig(moe=MoEConfig(**cfg_kw["moe"], impl=impl,
                                        dispatch_groups=g),
                          **cfg_kw["model"])
        live = [t.clone().requires_grad_(True) for t in pytree_leaves(p)]
        routing = []
        with use_mesh(mesh), moe.batch_over(mesh.data_group), \
                moe.capture_moe_routing(routing):
            y = moe.moe_block(pytree_unflatten(p, live), xl, cfg)
        grads = []
        for gr in torch.autograd.grad((y ** 2).sum(), live):
            gr = gr.clone()
            torch.distributed.all_reduce(gr, group=mesh.data_group)
            grads.append(gr.numpy())
        out[f"{impl}/{g}"] = (y.detach().numpy(),
                              routing[0]["keep"].numpy(), grads)
    tcfg = reduced(get_config("deepseek-moe-16b"), **train_kw["cfg"])
    runs = {}
    with use_mesh(mesh):
        for impl in ("gspmd", "grouped_local"):
            c = dataclasses.replace(tcfg, moe=dataclasses.replace(
                tcfg.moe, impl=impl, dispatch_groups=1))
            res = train(c, comm="baseline", device="cpu", **train_kw["run"])
            runs[impl] = ([h["loss"] for h in res["history"]],
                          [t.detach().numpy().copy()
                           for t in pytree_leaves(res["params"])])
    out["train"] = runs
    return out


def wire_sharded(ctx, wires, variants):
    """The chunk-sharded weight-wire open: for each ``(wired, manifest)``
    of ``wires`` (the port's wired tree and its manifest), this rank
    takes its shard of the tree (``comm.weights.shard_chunks``) and opens
    it with the codec rebuilt from the manifest under each of
    ``variants`` -> [{variant: opened tree}] in the order of ``wires``. A
    variant is ``"ring"``, ``"ring x2"`` (two hop pieces), ``"oneshot"``,
    ``"channel"`` (the codec's own channel on the data axis) or
    ``"channel auto"``."""
    from repro_torch.comm.planner import TransportConfig
    from repro_torch.comm.weights import shard_chunks
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.serving import codec_from_manifest, open_params
    out = []
    with use_mesh(make_test_mesh(model=1)):
        for wired, manifest in wires:
            wc = codec_from_manifest(manifest)
            local = shard_chunks(wired, ctx["rank"], ctx["world"])
            res = {}
            out.append(res)
            for v in variants:
                if v.startswith("channel"):
                    ch = wc.channel("data", ctx["world"], transport="auto"
                                    if v.endswith("auto") else None)
                    res[v] = open_params(local, wc, channel=ch)
                else:
                    t = TransportConfig("ring", 2) if v == "ring x2" else v
                    res[v] = open_params(local, wc, axis_name="data",
                                         axis_size=ctx["world"], transport=t)
    return out


def microbatched_step(ctx, params, batch, capacity_factor, n_micro):
    """One baseline step of reduced deepseek-moe-16b (f32, gspmd dispatch
    at ``capacity_factor``) over the world with ``n_micro``
    microbatches, from ``params`` (numpy) on the global ``batch`` ->
    (the step's loss, the reduced gradient leaves it hands the
    optimizer, in pytree order, numpy)."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.transformer import pytree_leaves
    from repro_torch.training import TrainConfig, make_baseline_step
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step
    cfg = reduced(get_config("deepseek-moe-16b"), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    p = params_from_numpy(params, "cpu")
    opt_cfg = opt.OptConfig()
    step = make_baseline_step(cfg, opt_cfg, TrainConfig(microbatches=n_micro),
                              group=ctx["group"])
    seen = {}
    apply_update = train_step.opt.apply_update

    def capture(params, grads, *args, **kw):
        seen["grads"] = grads
        return apply_update(params, grads, *args, **kw)

    train_step.opt.apply_update = capture
    try:
        _, _, metrics = step(p, opt.init_state(p, opt_cfg), batch)
    finally:
        train_step.opt.apply_update = apply_update
    return (float(metrics["loss"]),
            [g.numpy() for g in pytree_leaves(seen["grads"])])


def tp_layouts(ctx, cases):
    """Training over ``data x model`` layouts of this world, one
    ``launch.mesh.make_test_mesh(model=...)`` a case: ``train()`` of the
    reduced config with the mesh in scope from the whole tree
    ``params`` (numpy; None: from the seed) -> {case name: {run name:
    (losses, oks, fallbacks, the rank's local tree as numpy, its flat
    ZeRO-1 state or None)}}. A case is a dict of ``name``, ``arch``,
    ``cfg_kw`` (its ``"moe"``, if any, a dict of ``MoEConfig`` fields),
    ``model``, ``params``, ``registry_json`` (None: calibrated),
    ``train_kw`` and ``runs``: (run name, comm, wire enabled[, more
    ``train()`` keywords, and ``wait_for``: a path that another process
    writes, waited for before the run]). The optimizer state comes back
    as :func:`opt_numpy` gives it. A case with ``routing`` also records, per
    compressed run, each MoE layer's routing (``idx``, ``keep``) and
    input on the first batch from the initial tree under
    ``"<run name>/routing"``: [(idx, keep, x)] in layer order. A case
    with ``fsdp`` runs under ``parallel.sharding.make_rules()`` (ZeRO-3:
    its local tree and state are the rank's ``data x model`` blocks). A case
    with ``resume_root`` checkpoints each run into one directory there
    every ``steps - 1`` steps; rank 0 then deletes the last checkpoint
    and the run is launched again, which resumes one step short and
    finishes: the second launch is ``"<run name>/resumed"`` and its
    start step is appended."""
    import os
    import shutil
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import MoEConfig
    from repro_torch.convert import params_from_numpy, shard_params
    from repro_torch.core import CodecRegistry
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import make_rules, use_rules

    out = {}
    for case in cases:
        cfg_kw = dict(case["cfg_kw"])
        if "moe" in cfg_kw:
            cfg_kw["moe"] = MoEConfig(**cfg_kw["moe"])
        cfg = reduced(get_config(case["arch"]), **cfg_kw)
        mesh = make_test_mesh(model=case["model"])
        reg = (None if case["registry_json"] is None
               else CodecRegistry.from_json(case["registry_json"]))
        runs = {}
        kw = dict(case["train_kw"])
        root = case.get("resume_root")
        if root is not None:
            root = os.path.join(root, case["name"])
            kw.update(checkpoint_every=kw["steps"] - 1)
        for name, comm, enabled, *more in case["runs"]:
            more = more[0] if more else {}
            launches = [name] if root is None else [name, f"{name}/resumed"]
            for launch in launches:
                params = (None if case["params"] is None
                          else params_from_numpy(case["params"], "cpu"))
                ckpt = None if root is None else os.path.join(root, name)
                if "wait_for" in more:
                    wait_for(more["wait_for"])
                run_kw = dict(kw, checkpoint_dir=ckpt)
                run_kw.update((k, v) for k, v in more.items()
                              if k != "wait_for")
                with use_mesh(mesh), use_rules(
                        make_rules() if case.get("fsdp") else None):
                    res = train(cfg, comm=comm, device="cpu", params=params,
                                registry=reg, wire_enabled=enabled, **run_kw)
                hist = res["history"]
                runs[launch] = (
                    [h["loss"] for h in hist], [h["ok"] for h in hist],
                    res["comm_fallbacks"], numpy_tree(res["params"]),
                    opt_numpy(res["opt_state"]))
                if case.get("routing") and comm == "qlc":
                    local = shard_params(params_from_numpy(
                        case["params"], "cpu"), cfg, mesh.coords[1],
                        mesh.model)
                    rec, seen = [], []
                    with use_mesh(mesh), moe.capture_moe_routing(rec), \
                            moe.capture_moe_traffic(seen):
                        res["step"].stage1(local, res["data"].batch_at(0))
                    runs[f"{name}/routing"] = [
                        (r["idx"].numpy(), r["keep"].numpy(),
                         x.detach().numpy()) for r, (_, x) in zip(rec, seen)]
                if launch != name:
                    runs[launch] += (res["start_step"],)
                elif root is not None:
                    torch.distributed.barrier()
                    if ctx["rank"] == 0:
                        shutil.rmtree(os.path.join(
                            ckpt, f"step_{kw['steps']:010d}"))
                    torch.distributed.barrier()
        out[case["name"]] = runs
        torch.distributed.barrier()
    return out


def _state(res):
    """``train()``'s final state as numpy, and where it started."""
    return (numpy_tree(res["params"]), opt_numpy(res["opt_state"]),
            res["start_step"])


def ckpt_world2(ctx, cfg_kw, train_kw, root, codes, codes_root):
    """The baseline step of reduced phi3 at 2 x 1 for ``train_kw["steps"]``
    steps, checkpointed at its end into ``root``; then the same launch
    at 1 x 2, which restores each rank's blocks from it and runs no step
    -> {"2x1": state (whole), "1x2": state (this rank's blocks)}, as
    :func:`_state`. Then byte-width leaves split over the two ranks
    (``codes`` u8 [n, k]: each rank its half of the rows as ``"codes"``
    and of the columns as ``"fp8"``, a ``float8_e4m3fn`` view; its row of
    ``codes[:2]`` as the ``[1, 2, k]`` leaf ``"rows"``), saved through
    ``CheckpointManager`` into ``codes_root`` and restored on the same
    layout -> out["codes"] = this rank's restored parts as u8."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager, Layout
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.launch.train import train
    cfg = reduced(get_config("phi3-mini-3.8b"), **cfg_kw)
    out = {}
    for tag, model in (("2x1", 1), ("1x2", 2)):
        with use_mesh(make_test_mesh(model=model)):
            out[tag] = _state(train(
                cfg, comm="baseline", device="cpu", checkpoint_dir=root,
                checkpoint_every=train_kw["steps"], **train_kw))
    rank = ctx["rank"]
    n, k = codes.shape
    whole = torch.from_numpy(np.ascontiguousarray(codes))
    mine = {"codes": whole[rank * n // 2:(rank + 1) * n // 2].clone(),
            "fp8": whole[:, rank * k // 2:(rank + 1) * k // 2].contiguous()
            .view(torch.float8_e4m3fn),
            "rows": whole[rank].clone()}
    layout = Layout(data=1, model=2, rank=rank, group=ctx["group"],
                    cut={"codes": 0, "fp8": 1}, rows=frozenset({"rows"}))
    mgr = CheckpointManager(codes_root)
    mgr.save(1, mine, extra={"step": 1}, layout=layout)
    got, _ = mgr.restore(mine, device="cpu", layout=layout)
    out["codes"] = {key: t.view(torch.uint8).numpy()
                    for key, t in got.items()}
    return out


class _FailsMidSave:
    """A leaf whose save raises, as a rank that fails while it writes."""

    def detach(self):
        raise RuntimeError("simulated failure while writing a part")


def ckpt_world4(ctx, cfg_kw, train_kw, root, base_root, base_kw):
    """On 4 gloo ranks, reduced phi3 -> {name: result}:

    * ``straight``: ``train_kw["steps"]`` compressed steps at 2 x 2 (on
      the wire's raw e4m3 twin: the checkpoint does not depend on the
      wire); ``resumed``: one step fewer, checkpointed into
      ``root/comp``, then the same launch for all of them, which resumes
      (both :func:`_state`);
    * ``interrupted``: a save of the next step in which rank 2 fails
      while writing its row -> (this rank's exception, the latest step
      after it, the names in ``root/comp``); ``again``: the launch once
      more, restoring the last good step and running none;
    * ``refused 1x4`` / ``refused 4x1``: the compressed launch at 1 x 4
      and 4 x 1 from ``root/comp`` -> the ValueError's message (None if
      none);
    * ``corrupt``: with one byte of the last step's ``0/embed`` flipped,
      the launch at 2 x 2 -> the OSError's message (None if none);
    * ``old``: a launch into a directory of the per-rank layout of
      earlier versions -> the ValueError's message;
    * ``4x1`` / ``2x2``: once ``base_root`` holds a checkpoint (written
      by :func:`ckpt_world2`), the baseline launch of ``base_kw`` at
      4 x 1 and 2 x 2, which restores each rank's part and runs no step
      (:func:`_state`)."""
    import os
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.launch.train import checkpoint_layout, train
    cfg = reduced(get_config("phi3-mini-3.8b"), **cfg_kw)
    meshes = {"2x2": make_test_mesh(model=2), "1x4": make_test_mesh(model=4),
              "4x1": make_test_mesh(model=1)}
    rank, steps = ctx["rank"], train_kw["steps"]
    comp = os.path.join(root, "comp")
    kw = dict(train_kw, comm="qlc", device="cpu", wire_enabled=False)
    out = {}
    with use_mesh(meshes["2x2"]):
        straight = train(cfg, **kw)
        reg = straight["registry"]
        out["straight"] = _state(straight)
        train(cfg, registry=reg, checkpoint_dir=comp,
              **dict(kw, steps=steps - 1))
        resumed = train(cfg, registry=reg, checkpoint_dir=comp, **kw)
        out["resumed"] = _state(resumed)
    layout = checkpoint_layout(cfg, meshes["2x2"], ctx["group"], True)
    mgr = CheckpointManager(comp)
    opt = dict(resumed["opt_state"])
    if rank == 2:
        opt["m"] = _FailsMidSave()
    try:
        mgr.save(steps + 1, (resumed["params"], opt),
                 extra={"step": steps + 1}, layout=layout)
        failed = None
    except RuntimeError as e:
        failed = str(e)
    out["interrupted"] = (failed, mgr.latest_step(layout),
                          sorted(os.listdir(comp)))
    with use_mesh(meshes["2x2"]):
        out["again"] = _state(train(cfg, registry=reg, checkpoint_dir=comp,
                                    **kw))
    for tag in ("1x4", "4x1"):
        with use_mesh(meshes[tag]):
            try:
                train(cfg, registry=reg, checkpoint_dir=comp, **kw)
                out[f"refused {tag}"] = None
            except ValueError as e:
                out[f"refused {tag}"] = str(e)
    if rank == 0:               # one flipped byte in the last step's embed
        from repro_torch.checkpoint.manager import _leaf_file
        path = os.path.join(comp, f"step_{steps:010d}", _leaf_file("0/embed"))
        with open(path, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            byte = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([byte[0] ^ 0xFF]))
    torch.distributed.barrier()
    with use_mesh(meshes["2x2"]):
        try:
            train(cfg, registry=reg, checkpoint_dir=comp, **kw)
            out["corrupt"] = None
        except OSError as e:
            out["corrupt"] = str(e)
    old = os.path.join(root, "old")
    if rank == 0:
        os.makedirs(os.path.join(old, "rank_00000", "step_0000000001"))
    torch.distributed.barrier()
    with use_mesh(meshes["2x2"]):
        try:
            train(cfg, checkpoint_dir=old, **dict(base_kw, comm="baseline",
                                                  device="cpu"))
            out["old"] = None
        except ValueError as e:
            out["old"] = str(e)
    wait_for(os.path.join(base_root, "latest"))
    for tag in ("4x1", "2x2"):
        with use_mesh(meshes[tag]):
            out[tag] = _state(train(cfg, comm="baseline", device="cpu",
                                    checkpoint_dir=base_root, **base_kw))
    return out


def local_tree(params, cfg, mesh, rules=None):
    """This rank's local tree of the whole ``params`` (numpy) on ``mesh``
    as ``rules`` (default: the rules in scope) cut it: its model block,
    cut again over the data column where they cut parameters by FSDP."""
    from repro_torch.convert import params_from_numpy, shard_params
    from repro_torch.parallel.sharding import get_rules, use_rules
    d, m = mesh.coords
    with use_rules(get_rules() if rules is None else rules):
        return shard_params(params_from_numpy(params, "cpu"), cfg, m,
                            mesh.model, data_index=d, data_size=mesh.data)


def _serve_cfg(arch, cfg_kw):
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import MoEConfig
    cfg_kw = dict(cfg_kw)
    if "moe" in cfg_kw:
        cfg_kw["moe"] = MoEConfig(**cfg_kw["moe"])
    return reduced(get_config(arch), frontend=None, frontend_prefix_len=0,
                   **cfg_kw)


def tp_decode(ctx, cases):
    """Teacher-forced decode over model rows of this world: per case
    (``name``, ``arch``, ``cfg_kw``, ``model``, ``params``: the whole
    tree as numpy, ``tokens`` [B, P + T]), the rank's local tree
    (``convert.shard_params``) decodes the first P tokens in one
    multi-token ``decode_step`` and the other T one at a time, from
    ``init_decode_states`` with the row, under ``use_mesh`` -> {name:
    (the logits of the prompt's last position and of each step, [T + 1,
    B, V], the MoE layers' routing of each step on this rank: [(idx,
    keep)], the final states gathered over the row, and with
    ``prefill`` the prompt's ``prefill_logits``)}."""
    import numpy as np
    import torch
    from repro_torch.convert import params_from_numpy, shard_params
    from repro_torch.launch.mesh import make_test_mesh, model_row, use_mesh
    from repro_torch.models import (decode_step, init_decode_states, moe,
                                    prefill_logits)
    from repro_torch.serving.kv_cache import gather_row_states
    out = {}
    meshes = {}
    for case in cases:
        cfg = _serve_cfg(case["arch"], case["cfg_kw"])
        model = case["model"]
        if model not in meshes:
            meshes[model] = make_test_mesh(model=model)
        mesh = meshes[model]
        if mesh.data > 1:
            continue
        whole = params_from_numpy(case["params"], "cpu")
        local = shard_params(whole, cfg, mesh.coords[1], mesh.model)
        toks = torch.from_numpy(np.asarray(case["tokens"])).long()
        b, n = toks.shape
        p = case["prompt"]
        logits, routing = [], []
        with torch.no_grad(), use_mesh(mesh), moe.capture_moe_routing(
                routing):
            st = init_decode_states(cfg, b, n, "cpu", row=model_row(mesh))
            pos = torch.arange(p, dtype=torch.int32)[None].expand(b, p)
            lg, st = decode_step(local, cfg, toks[:, :p], st, pos)
            logits.append(lg[:, -1])
            for t in range(p, n):
                lg, st = decode_step(
                    local, cfg, toks[:, t:t + 1], st,
                    torch.full((b, 1), t, dtype=torch.int32))
                logits.append(lg[:, 0])
            states = gather_row_states(cfg, st, n, model_row(mesh))
            head = (prefill_logits(local, cfg, toks[:, :p]).numpy()
                    if case.get("prefill") else None)
        out[case["name"]] = (
            torch.stack(logits).numpy(),
            [(r["idx"].numpy(), r["keep"].numpy()) for r in routing],
            states, head)
    return out


def _margins(out: list):
    """Wrap the decode step the engine and its prefill call so that each
    call files the smallest top-1 margin (top-1 minus top-2 logit) of
    its last position in ``out``."""
    import torch
    from repro_torch.serving import engine, scheduler
    inner = scheduler.decode_step

    def step(*args, **kw):
        lg, st = inner(*args, **kw)
        top = torch.topk(lg[:, -1].float(), 2, dim=-1).values
        out.append(float((top[:, 0] - top[:, 1]).min()))
        return lg, st
    scheduler.decode_step = engine.decode_step = step


def tp_engine(ctx, cases):
    """``Engine(mesh=)`` over a model row of this world, per case
    (``name``, ``arch``, ``cfg_kw``, ``model``, ``params``: the whole
    tree as numpy, ``prompts``, ``new_tokens``, ``kv_block``, optional
    ``pool_bytes``): ``launch.serve.serve`` of the rank's local tree from
    the QLC weight wire (its dense engine), then the paged engines, sync
    and async, on the opened tree, and with ``pool_bytes`` a bounded
    pool without host spill -> {name: {"dense" / "sync" / "async" /
    "bounded": (tokens of each request, events, the KV registry's JSON
    or None, pool stats or None), "weights": the weight registry's JSON,
    "calibration": the first prefill's states gathered over the row,
    "margin": the smallest top-1 margin of any decode step}}."""
    import numpy as np
    import torch
    from repro_torch.comm.blockpool import BlockPool
    from repro_torch.convert import params_from_numpy, shard_params
    from repro_torch.launch.mesh import make_test_mesh, model_row, use_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_decode_states
    from repro_torch.serving import (Engine, GenerationRequest, KVCacheSpec,
                                     prefill)
    from repro_torch.serving.kv_cache import gather_row_states
    out = {}
    for case in cases:
        cfg = _serve_cfg(case["arch"], case["cfg_kw"])
        mesh = make_test_mesh(model=case["model"])
        whole = params_from_numpy(case["params"], "cpu")
        local = shard_params(whole, cfg, mesh.coords[1], mesh.model)
        prompts = np.asarray(case["prompts"])
        n_new, bt = case["new_tokens"], case["kv_block"]
        max_len = prompts.shape[1] + n_new + 8
        margins: list = []
        _margins(margins)
        runs = {}

        def engine_run(params, **kw):
            eng = Engine(params, cfg, max_seq_len=max_len, max_batch=4,
                         mesh=mesh, **kw)
            hs = [eng.submit(GenerationRequest(prompt=p,
                                               max_new_tokens=n_new))
                  for p in prompts]
            eng.run()
            st = eng.stats()
            return ([eng.poll(h).tokens for h in hs], eng.events,
                    eng.registry.to_json() if eng.registry else None,
                    st.get("pool"))
        with torch.no_grad(), use_mesh(mesh):
            res = serve(cfg, batch=4, requests=len(prompts),
                        prompt_len=prompts.shape[1], new_tokens=n_new,
                        wire="qlc", device="cpu", params=local)
            opened = res["params"]
            runs["weights"] = res["wire_codec"].registry.to_json()
            runs["dense"] = ([o.tokens for o in res["outs"]], res["events"],
                             None, None)
            for paging in ("sync", "async"):
                runs[paging] = engine_run(opened, kv_spec=KVCacheSpec(
                    block_tokens=bt, exact_capacity=paging == "sync",
                    axis="model"), pool=BlockPool(1 << 30),
                    kv_paging=paging)
            if case.get("pool_bytes"):
                runs["bounded"] = engine_run(
                    opened, kv_spec=KVCacheSpec(block_tokens=bt,
                                                axis="model"),
                    pool=BlockPool(case["pool_bytes"], spill_host=False))
            row = model_row(mesh)
            p0 = torch.from_numpy(prompts[:1].astype(np.int64))
            _, st = prefill(opened, cfg, p0, init_decode_states(
                cfg, 1, max_len, "cpu", row=row))
            runs["calibration"] = gather_row_states(cfg, st,
                                                    prompts.shape[1], row)
        runs["margin"] = min(margins)
        out[case["name"]] = runs
    return out


def kv_migration(ctx, layouts, cfg_kw, prompts):
    """Cold-block migration over a mesh axis of this world, per layout
    (``(axis, model)``: ``"model"`` at 1 x 4, ``"data"`` at 2 x 2): every
    rank prefills the same ``prompts`` on reduced phi3 (whole, no mesh),
    calibrates the same registry, perturbs the first 4-token block of
    layer slot 0 by ``1 + r / 64`` (r: its rank on the axis), encodes it
    through ``PagedKVCache(mesh=)`` with
    ``KVCacheSpec(axis=..., exact_capacity=False)`` and all-gathers the
    words (``block_wire``, ``all_gather_block_wire``); each gathered row
    decoded on this rank -> {layout: (the rank's container, the gathered
    rows as uint32, each row decoded and the rank's perturbed arrays, as
    bit patterns (``tree_bits``), its index on the axis)}; plus ``"registry"``: the
    registry's JSON, and ``"refused"``: the error of a channel with no
    axis."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import CodecRegistry
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_decode_states, init_params
    from repro_torch.serving import (KVCacheSpec, PagedKVCache,
                                     all_gather_block_wire, calibrate_cache,
                                     prefill)
    from repro_torch.serving.kv_cache import calibration_arrays
    cfg = _serve_cfg("phi3-mini-3.8b", cfg_kw)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = torch.from_numpy(np.asarray(prompts)).long()
    _, states = prefill(params, cfg, p, init_decode_states(cfg, p.shape[0],
                                                           32, "cpu"))
    out = {}
    for axis, model in layouts:
        mesh = make_test_mesh(model=model)
        reg = CodecRegistry()
        spec = KVCacheSpec(block_tokens=4, axis=axis, exact_capacity=False)
        calibrate_cache(reg, cfg, states, p.shape[1], spec)
        cache = PagedKVCache(spec, cfg, reg, device="cpu", mesh=mesh)
        me = mesh.coords[0 if axis == "data" else 1]
        arrays = [a * (1.0 + me / 64.0)
                  for a in calibration_arrays(cfg, states, 4)["l0"]]
        block = cache.encode_block_arrays("kv/layer0", "l0", arrays,
                                          start=0, tokens=4)
        ch = cache.channels[sorted(cache.channels)[0]]
        got = all_gather_block_wire(cache.block_wire(block), ch)
        rows = got.numpy().view(np.uint32)
        decoded = [[tree_bits(a) for a in cache.decode_block_arrays(
            dataclasses.replace(block, container=rows[r]))]
            for r in range(rows.shape[0])]
        out[(axis, model)] = (block.container, rows, decoded,
                              [tree_bits(a) for a in arrays], me)
        out["registry"] = reg.to_json()
        local = PagedKVCache(spec, cfg, reg, device="cpu")
        try:
            all_gather_block_wire(local.block_wire(block),
                                  local.channels[sorted(local.channels)[0]])
        except ValueError as e:
            out["refused"] = str(e)
    return out


def row_histogram(ctx, arch, cfg_kw, params):
    """``comm.calibrate.histogram_of_local_tree`` of the rank's cut of the
    whole tree ``params`` (numpy) over a model row of the whole world."""
    from repro_torch.comm.calibrate import histogram_of_local_tree
    from repro_torch.convert import params_from_numpy, shard_params
    from repro_torch.launch.mesh import make_test_mesh
    cfg = _serve_cfg(arch, cfg_kw)
    mesh = make_test_mesh(model=ctx["world"])
    local = shard_params(params_from_numpy(params, "cpu"), cfg,
                         mesh.coords[1], mesh.model)
    return histogram_of_local_tree(local, cfg, mesh)


def tp_serve(ctx, decode=(), engine=(), migration=None, histogram=None):
    """:func:`tp_decode`, :func:`tp_engine`, :func:`kv_migration` and
    :func:`row_histogram` (with ``migration`` / ``histogram``, their
    keywords) in one world -> {"decode": ..., "engine": ...,
    "migration": ..., "histogram": ...}."""
    return {"decode": tp_decode(ctx, list(decode)),
            "engine": tp_engine(ctx, list(engine)),
            "migration": None if migration is None
            else kv_migration(ctx, **migration),
            "histogram": None if histogram is None
            else row_histogram(ctx, **histogram)}


# --------------------------------------------------------------------------
# Serving over the data column
# --------------------------------------------------------------------------

class _Logits:
    """Wrap the decode step the engine and its prefill call so that each
    call files its last position's logits (a numpy copy) in ``out``."""

    def __init__(self):
        self.out = []

    def __enter__(self):
        from repro_torch.serving import engine, scheduler
        self._inner = inner = scheduler.decode_step
        out = self.out

        def step(*args, **kw):
            lg, st = inner(*args, **kw)
            out.append(lg[:, -1].float().numpy().copy())
            return lg, st
        scheduler.decode_step = engine.decode_step = step
        return out

    def __exit__(self, *exc):
        from repro_torch.serving import engine, scheduler
        scheduler.decode_step = engine.decode_step = self._inner


def _engine_run(params, cfg, prompts, new_tokens, max_seq_len, batch, mesh,
                rids=None, stats=None, **kw):
    """An engine's run over ``prompts`` -> (tokens by request id,
    events, the KV registry's JSON or None, stats' counts, the logits of
    every decode step and prefill step). ``stats``: a dict that gets the
    engine's ``stats()`` and, under ``"engine"``, the engine."""
    from repro_torch.serving import Engine, GenerationRequest
    with _Logits() as logits:
        eng = Engine(params, cfg, max_seq_len=max_seq_len, max_batch=batch,
                     mesh=mesh, **kw)
        ids = rids or [f"r{i}" for i in range(len(prompts))]
        for rid, p in zip(ids, prompts):
            eng.submit(GenerationRequest(prompt=p, max_new_tokens=new_tokens,
                                         request_id=rid))
        eng.run()
    st = eng.stats()
    if stats is not None:
        stats.update(st, engine=eng)
    counts = {k: st[k] for k in ("steps", "requests", "prefill_tokens",
                                 "decode_tokens")}
    return ({rid: eng.poll(rid).tokens for rid in ids}, eng.events,
            eng.registry.to_json() if eng.registry is not None else None,
            counts, logits)


def dp_split(ctx, cases, new_tokens, kv_block):
    """Slots split over the data column of a 2 x 2 mesh: per case
    (``name``, ``arch``, ``cfg_kw``, ``params``: the whole tree as
    numpy, ``prompts``, optional ``pool_bytes``, ``serve``): the engine
    dense and paged sync and async on the rank's local tree, and the
    ``1 x 2`` engine of this rank's row (``launch.mesh.row_mesh``,
    ``max_batch`` 2) fed the requests the 2 x 2 schedule put on its
    replica (``serving.scheduler.replica_requests``); with
    ``pool_bytes`` a bounded pool without host spill; with ``serve``,
    ``launch.serve.serve`` on the mesh from the QLC weight wire, dense
    then paged (the launcher checks paged against dense) -> {name: {paging: (the 2 x 2 run, the
    row's run, this replica's request ids)}, ...}."""
    import numpy as np
    import torch
    from repro_torch.comm.blockpool import BlockPool
    from repro_torch.convert import params_from_numpy, shard_params
    from repro_torch.launch.mesh import make_test_mesh, row_mesh, use_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.serving import KVCacheSpec
    from repro_torch.serving.scheduler import replica_requests
    mesh = make_test_mesh(model=2)
    sub = row_mesh(mesh)
    out = {}
    for case in cases:
        cfg = _serve_cfg(case["arch"], case["cfg_kw"])
        local = shard_params(params_from_numpy(case["params"], "cpu"), cfg,
                             mesh.coords[1], mesh.model)
        prompts = np.asarray(case["prompts"])
        max_len = prompts.shape[1] + new_tokens + 8
        runs = {}
        with torch.no_grad():
            if case.get("serve"):
                for paging in ("sync", "async"):
                    with use_mesh(mesh):
                        res = serve(cfg, batch=4, requests=len(prompts),
                                    prompt_len=prompts.shape[1],
                                    new_tokens=new_tokens, wire="qlc",
                                    kv_cache="qlc", kv_block=kv_block,
                                    kv_paging=paging, device="cpu",
                                    params=local)
                    runs[paging] = ([o.tokens for o in res["outs"]],
                                    res["events"], res["dense_tokens"],
                                    res["kv_registry"].to_json())
                out[case["name"]] = runs
                continue
            kinds = {"dense": lambda: {}}
            for paging in ("sync", "async"):
                kinds[paging] = lambda paging=paging: dict(
                    kv_paging=paging, pool=BlockPool(1 << 30),
                    kv_spec=KVCacheSpec(block_tokens=kv_block,
                                        exact_capacity=paging == "sync",
                                        axis="model"))
            if case.get("pool_bytes"):
                kinds["bounded"] = lambda: dict(
                    kv_spec=KVCacheSpec(block_tokens=kv_block, axis="model"),
                    pool=BlockPool(case["pool_bytes"], spill_host=False))
            by_id = {f"r{i}": p for i, p in enumerate(prompts)}
            for kind, kw in kinds.items():
                whole = _engine_run(local, cfg, prompts, new_tokens, max_len,
                                    4, mesh, **kw())
                mine = replica_requests(whole[1], 4, 2)[mesh.coords[0]]
                row = _engine_run(local, cfg, [by_id[r] for r in mine],
                                  new_tokens, max_len, 2, sub, rids=mine,
                                  **kw())
                runs[kind] = (whole, row, mine)
        out[case["name"]] = runs
    return out


def seq_decode(ctx, cases, models):
    """The sequence-split decode over the data column, per mesh layout
    (``models``: the model axis of each, the data axis the rest of the
    world) and case (``name``, ``arch``, ``cfg_kw``, ``params``: the
    whole tree as numpy, ``tokens`` [B, P + T], ``prompt`` P, and one
    attention layer's inputs ``layer``: q [B, 1, n, H], the whole k / v
    caches [B, S, KV, H] and positions [B, 1]): the prompt in one
    multi-token ``decode_step`` on whole states, the rank's range of
    them (``convert.shard_decode_states`` under
    ``make_rules(decode_seq_shard=True)``), then T one-token steps under
    those rules; and the layer's decode over the rank's range and heads
    -> {(model, name): (logits [T + 1, B, V], the layer's output)}."""
    import numpy as np
    import torch
    from repro_torch.convert import (params_from_numpy, shard_decode_states,
                                     shard_params)
    from repro_torch.launch.mesh import (kv_seq_shard, make_test_mesh,
                                         model_row, use_mesh)
    from repro_torch.models import attention as attn
    from repro_torch.models import decode_step, init_decode_states
    from repro_torch.parallel.sharding import make_rules, use_rules
    out = {}
    for model in models:
        mesh = make_test_mesh(model=model)
        d, m = mesh.coords
        row = model_row(mesh)
        for case in cases:
            cfg = _serve_cfg(case["arch"], case["cfg_kw"])
            local = shard_params(params_from_numpy(case["params"], "cpu"),
                                 cfg, m, mesh.model)
            split_rules = make_rules(decode_seq_shard=True)
            blocks = local_tree(case["params"], cfg, mesh, split_rules)
            toks = torch.from_numpy(np.asarray(case["tokens"])).long()
            b, n = toks.shape
            p = case["prompt"]
            logits = []
            with torch.no_grad(), use_mesh(mesh):
                st = init_decode_states(cfg, b, n, "cpu", row=row)
                pos = torch.arange(p, dtype=torch.int32)[None].expand(b, p)
                lg, st = decode_step(local, cfg, toks[:, :p], st, pos)
                logits.append(lg[:, -1])
                with use_rules(split_rules):
                    st = shard_decode_states(st, cfg, 0, 1, d, mesh.data)
                    for t in range(p, n):
                        lg, st = decode_step(
                            blocks, cfg, toks[:, t:t + 1], st,
                            torch.full((b, 1), t, dtype=torch.int32))
                        logits.append(lg[:, 0])
                    shard = kv_seq_shard(mesh)
                q, k, v, qpos = (torch.from_numpy(np.asarray(a))
                                 for a in case["layer"])
                heads, kvh = q.shape[2] // mesh.model, \
                    k.shape[2] // mesh.model
                s_loc = k.shape[1] // mesh.data
                cache = attn.KVCache(
                    k=k[:, d * s_loc:(d + 1) * s_loc,
                        m * kvh:(m + 1) * kvh].contiguous(),
                    v=v[:, d * s_loc:(d + 1) * s_loc,
                        m * kvh:(m + 1) * kvh].contiguous(),
                    length=qpos[:, 0])
                g = heads // kvh
                layer = attn._seq_sharded_decode(
                    q[:, :, m * heads:(m + 1) * heads].contiguous(), cache,
                    qpos, cfg, [j // g for j in range(heads)], shard)
            out[(model, case["name"])] = (torch.stack(logits).numpy(),
                                          layer.numpy())
        torch.distributed.barrier()
    return out


def seq_engine(ctx, arch, cfg_kw, params, prompts, new_tokens, kv_block):
    """An engine under ``make_rules(decode_seq_shard=True)`` over a data
    column of the whole world (model 1): dense and paged sync -> {kind:
    (tokens by request id, events, KV registry JSON, counts)}, and the
    caches' positions a rank holds."""
    import numpy as np
    import torch
    from repro_torch.comm.blockpool import BlockPool
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import make_rules, use_rules
    from repro_torch.serving import Engine, KVCacheSpec
    cfg = _serve_cfg(arch, cfg_kw)
    mesh = make_test_mesh(model=1)
    whole = local_tree(params, cfg, mesh, make_rules(decode_seq_shard=True))
    prompts = np.asarray(prompts)
    max_len = prompts.shape[1] + new_tokens + 3
    out = {}
    with torch.no_grad(), use_rules(make_rules(decode_seq_shard=True)):
        for kind, kw in (("dense", {}), ("sync", dict(
                kv_spec=KVCacheSpec(block_tokens=kv_block, axis="model"),
                pool=BlockPool(1 << 30)))):
            run = _engine_run(whole, cfg, prompts, new_tokens, max_len, 4,
                              mesh, **kw)
            out[kind] = run[:4]
        eng = Engine(whole, cfg, max_seq_len=max_len, max_batch=4, mesh=mesh,
                     kv_spec=KVCacheSpec(block_tokens=kv_block))
        out["positions"] = (eng.max_seq_len, eng._states_len())
    return out


def dp_serve(ctx, split=(), seq=(), models=(), engine=None, new_tokens=8,
             kv_block=4):
    """:func:`dp_split` (a world of 4), :func:`seq_decode` and
    :func:`seq_engine` (with ``engine``, its keywords) in one world."""
    return {"split": dp_split(ctx, list(split), new_tokens, kv_block)
            if split else None,
            "seq": seq_decode(ctx, list(seq), list(models)),
            "engine": None if engine is None else seq_engine(ctx, **engine)}


#: rule id -> the sharding rules' extras of the reference's decode
#: layouts (``parallel.sharding.make_rules(extra=...)``), and the data
#: column's split (``decode_seq_shard=True``)
SEQ_RULES = {"model": {"kv_seq": "model"},
             "both": {"kv_seq": ("data", "model"), "batch": None},
             "data": {"kv_seq": ("data",), "batch": None}}


def seq_rules(rule: str):
    from repro_torch.parallel.sharding import make_rules
    return make_rules(extra=SEQ_RULES[rule])


def seq_split_decode(ctx, cases):
    """Teacher-forced decode under a sequence split of the KV caches, per
    case (``name``, ``arch``, ``cfg_kw``, ``params``: the whole tree as
    numpy, ``tokens`` [B, P + T], ``prompt`` P, ``model``: the model
    axis, the data axis the rest of this world, ``rule``: a key of
    :data:`SEQ_RULES`): the prompt in one multi-token ``decode_step`` on
    the row's heads under the default rules, the whole states gathered
    over the row and cut as the case's rules cut them
    (``convert.shard_decode_states``), then T one-token steps under
    those rules. Under ``"model"`` the batch splits over the data
    column: this rank decodes its data index's rows -> {name: (logits
    [T + 1, b, V], the first of the batch's rows this rank decoded, the
    positions of its caches)}."""
    import numpy as np
    import torch
    from repro_torch.convert import (params_from_numpy, shard_decode_states,
                                     shard_params)
    from repro_torch.launch.mesh import make_test_mesh, model_row, use_mesh
    from repro_torch.models import decode_step, init_decode_states
    from repro_torch.models import attention as attn
    from repro_torch.parallel.sharding import use_rules
    from repro_torch.serving.kv_cache import gather_row_states
    out, meshes = {}, {}
    for case in cases:
        model = case["model"]
        if model not in meshes:
            meshes[model] = make_test_mesh(model=model)
        mesh = meshes[model]
        d, m = mesh.coords
        row = model_row(mesh)
        cfg = _serve_cfg(case["arch"], case["cfg_kw"])
        local = shard_params(params_from_numpy(case["params"], "cpu"), cfg,
                             m, mesh.model)
        toks = torch.from_numpy(np.asarray(case["tokens"])).long()
        first = 0
        if case["rule"] == "model":
            rows = toks.shape[0] // mesh.data
            first = d * rows
            toks = toks[first:first + rows]
        b, n = toks.shape
        p = case["prompt"]
        logits = []
        with torch.no_grad(), use_mesh(mesh):
            st = init_decode_states(cfg, b, n, "cpu", row=row)
            pos = torch.arange(p, dtype=torch.int32)[None].expand(b, p)
            lg, st = decode_step(local, cfg, toks[:, :p], st, pos)
            logits.append(lg[:, -1])
            whole = gather_row_states(cfg, st, n, row)
            blocks = local_tree(case["params"], cfg, mesh,
                                seq_rules(case["rule"]))
            with use_rules(seq_rules(case["rule"])):
                st = shard_decode_states(
                    whole, cfg, m, mesh.model,
                    *((0, 1) if case["rule"] == "model" else (d, mesh.data)))
                for t in range(p, n):
                    lg, st = decode_step(
                        blocks, cfg, toks[:, t:t + 1], st,
                        torch.full((b, 1), t, dtype=torch.int32))
                    logits.append(lg[:, 0])
        cache = next(s for s in st.values() if isinstance(s, attn.KVCache))
        out[case["name"]] = (torch.stack(logits).numpy(), first,
                             tuple(cache.k.shape[2:4]))
    return out


def seq_split_engine(ctx, cases, new_tokens, kv_block):
    """``Engine(mesh=)`` under a sequence split of the KV caches, per case
    (``name``, ``arch``, ``cfg_kw``, ``params``: the whole tree as
    numpy, ``prompts``, ``model``, ``rule``: a key of
    :data:`SEQ_RULES`, ``batch``): the rank's local tree, dense and
    paged sync and async -> {name: {kind: (tokens by request id, events,
    KV registry JSON, counts)}, plus ``"<kind>_pages"``: this rank's
    pooled blocks and prefetch decodes scheduled, ``"windows"``: its
    async windows, and ``"positions"``:
    the rounded ``max_seq_len``, this rank's first position, its cache
    positions and KV heads}."""
    import numpy as np
    import torch
    from repro_torch.comm.blockpool import BlockPool
    from repro_torch.convert import params_from_numpy, shard_params
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import use_rules
    from repro_torch.serving import KVCacheSpec
    out, meshes = {}, {}
    for case in cases:
        model = case["model"]
        if model not in meshes:
            meshes[model] = make_test_mesh(model=model)
        mesh = meshes[model]
        cfg = _serve_cfg(case["arch"], case["cfg_kw"])
        local = local_tree(case["params"], cfg, mesh,
                           seq_rules(case["rule"]))
        prompts = np.asarray(case["prompts"])
        max_len = prompts.shape[1] + new_tokens + 3
        runs = {}
        with torch.no_grad(), use_rules(seq_rules(case["rule"])):
            for kind in ("dense", "sync", "async"):
                kw = {} if kind == "dense" else dict(
                    kv_paging=kind, pool=BlockPool(1 << 30),
                    kv_spec=KVCacheSpec(block_tokens=kv_block,
                                        exact_capacity=kind == "sync",
                                        axis="model"))
                stats = {}
                res = _engine_run(local, cfg, prompts, new_tokens, max_len,
                                  case["batch"], mesh, stats=stats, **kw)
                runs[kind] = res[:4]
                if kind != "dense":
                    runs[kind + "_pages"] = (
                        stats["pool"]["unique_blocks"],
                        stats.get("prefetch", {}).get("scheduled", 0))
                if kind == "async":
                    runs["windows"] = stats["async"]["windows"]
                    k = stats["engine"]._states["l0"].k
                    runs["positions"] = (stats["engine"].max_seq_len,
                                         stats["engine"]._offset(),
                                         k.shape[2], k.shape[3])
        out[case["name"]] = runs
    return out


def seq_serve(ctx, decode=(), engine=(), new_tokens=8, kv_block=4):
    """:func:`seq_split_decode` and :func:`seq_split_engine` in one
    world."""
    return {"decode": seq_split_decode(ctx, list(decode)),
            "engine": seq_split_engine(ctx, list(engine), new_tokens,
                                       kv_block)}


def fsdp_serving(ctx, arch, cfg_kw, params, tokens, prompt, prompts,
                 new_tokens, kv_block, model, serve_kw):
    """Serving under ``make_rules()`` (FSDP) on a ``data x model`` mesh of
    this world (``model``: its model axis) from the rank's blocks
    (:func:`local_tree`): ``prefill_logits`` of ``tokens[:, :prompt]``;
    a teacher-forced decode (the prompt in one multi-token step, then
    one token a step) on the dense blocks and on the QLC weight wire cut
    by chunks over the data column, the wire's open over the column
    against ``open_group`` of the whole model-block wire; the FSDP
    histogram against the model's; ``Engine(mesh=)`` dense and paged sync
    and async; ``launch.serve.serve(reference_rules=True, **serve_kw)``
    from the wire, paged sync (checked against the dense engine inside)
    -> a dict of those (numpy) and the FSDP collectives counted."""
    import numpy as np
    import torch
    from repro_torch.comm.blockpool import BlockPool
    from repro_torch.comm.calibrate import (histogram_of_local_tree,
                                            histogram_of_tree)
    from repro_torch.convert import (leaf_data_dims, params_from_numpy,
                                     shard_params, whole_leaf_shapes)
    from repro_torch.core import CodecRegistry
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.serve import serve
    from repro_torch.models import (decode_step, init_decode_states,
                                    prefill_logits)
    from repro_torch.parallel.sharding import make_rules, use_rules
    from repro_torch.serving import (KVCacheSpec, compress_params_for_serving,
                                     open_params)
    cfg = _serve_cfg(arch, cfg_kw)
    mesh = tmesh.make_test_mesh(model=model)
    d, m = mesh.coords
    row = tmesh.model_row(mesh)
    rules = make_rules()
    blocks = local_tree(params, cfg, mesh, rules)
    tp_local = shard_params(params_from_numpy(params, "cpu"), cfg, m,
                            mesh.model)
    toks = torch.from_numpy(np.asarray(tokens)).long()
    b, n = toks.shape
    out = {}

    def decode(tree, codec, scope_rules):
        logits = []
        with use_mesh_rules(mesh, scope_rules):
            st = init_decode_states(cfg, b, n, "cpu", row=row)
            pos = torch.arange(prompt, dtype=torch.int32)[None].expand(
                b, prompt)
            lg, st = decode_step(tree, cfg, toks[:, :prompt], st, pos,
                                 weight_codec=codec)
            logits.append(lg[:, -1])
            for t in range(prompt, n):
                lg, st = decode_step(tree, cfg, toks[:, t:t + 1], st,
                                     torch.full((b, 1), t, dtype=torch.int32),
                                     weight_codec=codec)
                logits.append(lg[:, 0])
        return torch.stack(logits).numpy()

    with torch.no_grad():
        tmesh.reset_fsdp_counts()
        with use_mesh_rules(mesh, rules):
            out["prefill"] = prefill_logits(blocks, cfg,
                                            toks[:, :prompt]).numpy()
        out["decode"] = decode(blocks, None, rules)
        out["gathers"] = dict(tmesh.FSDP_COUNTS)
        with use_mesh_rules(mesh, rules):
            col = tmesh.fsdp_column(mesh)
            hist = histogram_of_local_tree(blocks, cfg, mesh)
            out["hist_equal"] = np.array_equal(hist, histogram_of_tree(
                params_from_numpy(params, "cpu")))
            reg = CodecRegistry()
            reg.register("default", hist)
            whole = whole_leaf_shapes(cfg, "groups")
            wired, wc = compress_params_for_serving(
                blocks["groups"], reg, whole_shapes=whole, column=col,
                data_dims=leaf_data_dims(cfg, mesh.data, mesh.model,
                                         "groups"))
            full, fc = compress_params_for_serving(
                tp_local["groups"], reg, whole_shapes=whole)
            fw = flat_tree(wired)
            out["chunks"] = {k: (int(fw[k + "/words"].shape[-2]),
                                 fc.meta[k].n_chunks) for k in fc.meta}
            opened = open_params(wired, wc, column=col)
        want = fc.open_group(full)
        fo, fwant = flat_tree(opened), flat_tree(want)
        out["wire_open_equal"] = sorted(wc.meta) == sorted(fc.meta) and all(
            torch.equal(fo[k], fwant[k]) for k in fc.meta)
        out["wire_decode"] = decode(dict(blocks, groups=wired), wc, rules)
        out["opened_decode"] = decode(dict(tp_local, groups=want), None,
                                      None)
        prompts = np.asarray(prompts)
        max_len = prompts.shape[1] + new_tokens + 8
        engines = {}
        with use_rules(rules):
            for kind in ("dense", "sync", "async"):
                kw = {} if kind == "dense" else dict(
                    kv_paging=kind, pool=BlockPool(1 << 30),
                    kv_spec=KVCacheSpec(block_tokens=kv_block,
                                        exact_capacity=kind == "sync",
                                        axis="model"))
                engines[kind] = _engine_run(blocks, cfg, prompts, new_tokens,
                                            max_len, 4, mesh, **kw)[0]
        out["engine"] = engines
        with tmesh.use_mesh(mesh):
            res = serve(cfg, wire="qlc", kv_cache="qlc", kv_block=kv_block,
                        device="cpu", reference_rules=True, **serve_kw)
        out["serve"] = ([o.tokens for o in res["outs"]], res["solo_tokens"])
    return out


def use_mesh_rules(mesh, rules):
    """``use_mesh(mesh)`` and ``use_rules(rules)`` in one context."""
    import contextlib
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.parallel.sharding import use_rules
    stack = contextlib.ExitStack()
    stack.enter_context(use_mesh(mesh))
    stack.enter_context(use_rules(rules))
    return stack


def fsdp_world(ctx, train=(), serving=None):
    """:func:`tp_layouts` of ``train`` and, with ``serving`` (its
    keywords), :func:`fsdp_serving`, in one world."""
    return {"train": tp_layouts(ctx, list(train)) if train else None,
            "serving": None if serving is None
            else fsdp_serving(ctx, **serving)}


if __name__ == "__main__":
    _main()
