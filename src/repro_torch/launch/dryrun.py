"""Dry run: count one rank's step of a production cell, with no card.

The port's counterpart of the reference's ``launch/dryrun.py``. The
reference lowers and compiles a cell's step for 256 placeholder devices
and walks the compiled HLO; here a ``"fake"`` process group makes a
world of 256 ranks in one process (this process is rank 0, laid out by
``make_production_mesh()``: 16 data x 16 model), rank 0's parameters,
optimizer state and batch are fake tensors (``FakeTensorMode``: shapes
and dtypes, no storage) at the cell's full published widths and depth,
and one real step of the port runs on them under
``roofline.op_count.count()``. The kernels' entries return empty fake
outputs there and the collectives move nothing, so every number is
computed from shapes, not measured, and each output says so.

Each cell runs as the port trains or serves it, a decode under the
reference's decode rules (``parallel.sharding.decode_rules``: the KV
cache's sequence over ``model`` where the KV heads do not divide it,
over ``("data", "model")`` at a batch of 1). Where the port differs from
the reference's ``cell_rules``, ``rules_differ`` says how:

- ``--multi-pod`` raises ``NO_PODS`` (item 13).

The baseline train step, the prefill and a decode cut parameters by FSDP
as the reference's do (a rank holds its ``data x model`` block of each
FSDP leaf and gathers a layer group's blocks over the data column as it
runs; a decode's weight wire lies by chunks over the column); the
compressed train step is TP only, as the reference's.

On a torch built without CUDA the fake tensors are on the CPU (autograd
needs the CUDA device guard, which such a build lacks); the counts are
the same, since the kernels' entries are counted, not run.

Writes the reference's JSON keys (``arch``, ``shape``, ``mesh``,
``comm``, ``chips``, ``memory``, ``roofline``, ``ok``) plus ``fits``,
``rules_differ`` and ``counted``, and the op record beside it as
``<cell>.ops.json.gz`` (``launch.reanalyze`` recomputes the roofline
from it alone).

  python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b \\
      --shape train_4k --comm qlc --out results/phi3.json
  python -m repro_torch.launch.dryrun --sweep --comm baseline
  python -m repro_torch.launch.report results/dryrun
"""
from __future__ import annotations

import argparse
import ast
import concurrent.futures
import dataclasses
import gzip
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import ASSIGNED, get_config, shapes_for
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.roofline import analysis, hw
from repro_torch.roofline.op_count import OpRecord, count

#: seconds a sweep gives one cell (~3,000 fake-tensor ops a second on an
#: idle core here, half that with a core each for 7 cells at once):
#: a model whose blocks recur over the sequence in Python (xLSTM, mamba)
#: runs an op set a position and does not finish a 4k or 32k cell
CELL_TIMEOUT_S = 1800

def cell_rules(cfg: ModelConfig, shape: ShapeConfig, mesh, comm: str
               ) -> Tuple[object, List[str]]:
    """``(the port's sharding rules for the cell, how the reference's
    cell_rules differ)``: the reference's rules, so the list is empty.
    Parameters are cut by FSDP (``make_rules()``) in the baseline train
    step, the prefill and a decode (unless ``cfg.serve_params_tp_only``),
    not in the compressed train step (TP only, as the reference's); a
    decode takes the reference's decode rules
    (``parallel.sharding.decode_rules``: the KV cache's sequence over
    ``model`` where the KV heads do not divide it, over ``("data",
    "model")`` at a batch of 1)."""
    from repro_torch.parallel import sharding as shd
    if shape.kind == "decode":
        return shd.decode_rules(cfg, shape.global_batch, mesh), []
    if shape.kind == "train" and comm != "baseline":
        return shd.make_rules(fsdp_params=False), []
    return shd.make_rules(), []


def _microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    dp = mesh.shape["data"]
    local_b = max(1, shape.global_batch // dp)
    # target <= 2 sequences per microbatch per rank for the 4k trains
    n = max(1, min(local_b, local_b // 2))
    while local_b % n:
        n -= 1
    return n


def fake_device() -> str:
    """``cuda`` where torch is built with CUDA, else ``cpu`` (see the
    module docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _zeros(structs: Dict, dev) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
            for k, v in structs.items()}


def _fake_like(tree, dev):
    """Zeros of each leaf's shape and dtype on ``dev`` (under the fake
    mode: fake tensors)."""
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype,
                                          device=dev), tree)


def cell_tables(kind: str):
    """The reference's codec for a cell: TABLE1 on the synthetic gradient
    stream (train) or FFN1 stream (decode, the weight wire), planned at
    1024-symbol chunks: ``(CodecTables, CommPlan)``. Real tensors: made
    before the fake mode."""
    from repro_torch.comm import plan_for_tables
    from repro_torch.core import TABLE1, build_tables, distributions
    counts = (distributions.grad_counts if kind == "train"
              else distributions.ffn1_counts)(1 << 20)
    tables = build_tables(counts, TABLE1)
    return tables, plan_for_tables(tables, counts, chunk_symbols=1024)


def _batch(cfg: ModelConfig, seq_len: int, batch: int, dev,
           seed: Optional[int]) -> Dict[str, torch.Tensor]:
    """A training or prefill batch: zeros of its shapes (``seed`` None:
    the fake mode's stand-ins), else the synthetic stream's batch 0 from
    ``seed`` (and a seeded prefix embedding where the model has one)."""
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.data.synthetic import input_shape_structs
    structs = input_shape_structs(
        cfg.vocab_size, seq_len, batch, prefix_len=cfg.frontend_prefix_len,
        d_model=cfg.d_model, dtype=getattr(torch, cfg.dtype))
    if seed is None:
        return _zeros(structs, dev)
    data = SyntheticDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len - cfg.frontend_prefix_len,
        global_batch=batch, seed=seed))
    out = {k: torch.as_tensor(v).to(dev)
           for k, v in data.batch_at(0).items()}
    if "prefix_emb" in structs:
        st = structs["prefix_emb"]
        out["prefix_emb"] = torch.randn(
            st.shape, generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev).to(st.dtype)
    return out


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, comm: str,
               dev: str, tables=None, seed: Optional[int] = None,
               wire_caps: Optional[Dict[str, int]] = None):
    """One rank's step of the cell: ``(step, live)``, where ``step()``
    runs it and ``live`` holds its arguments (parameters, optimizer
    state, batch). ``tables``: ``(CodecTables, CommPlan)`` made before a
    fake mode (the gradient codec for a train cell, the weight codec for
    a decode one) when ``comm`` is ``qlc`` or ``e4m3``.

    ``seed`` None: on tensors made under the fake mode the caller holds,
    the batch and the decode's token zeros and its weight wire of the
    plan's slot (``wire_caps``, leaf path -> slot words, where given: a
    real wire's). ``seed`` given, on real tensors (the card's profiled
    step): parameters drawn from it, the synthetic stream's batch, and
    the decode's weights put on the QLC or e4m3 wire from their values
    (each leaf at its own exact slot, as the serving launcher wires
    them); the decode's cache stays as a new one, zeros."""
    from repro_torch import convert
    from repro_torch.launch.mesh import fsdp_column
    from repro_torch.models import decode_step, prefill_logits
    d_i, m_i = mesh.coords
    col = fsdp_column(mesh)
    gen = torch.Generator(device=dev)
    if seed is not None:
        gen.manual_seed(seed)
    params = convert.init_local_params(
        cfg, gen, dev, m_i, mesh.model, *((col.index, col.size)
                                          if col is not None else (0, 1)))
    if col is not None:
        # resolved (from the whole tree's shapes) before the counted step
        from repro_torch.parallel.sharding import fsdp_dims
        fsdp_dims(cfg, mesh)
    if shape.kind == "train":
        from repro_torch.comm import CommConfig
        from repro_torch.training import (OptConfig, TrainConfig,
                                          init_compressed_opt_state,
                                          make_baseline_step,
                                          make_compressed_step)
        from repro_torch.training import optimizer as optm
        opt_cfg = OptConfig(moment_dtype="bfloat16")
        train_cfg = TrainConfig(microbatches=_microbatches(cfg, shape,
                                                           mesh))
        batch = _batch(cfg, shape.seq_len, shape.global_batch, dev, seed)
        if comm in ("qlc", "e4m3"):
            t, plan = tables
            comm_cfg = CommConfig.from_plan(plan)
            if comm == "e4m3":
                comm_cfg = dataclasses.replace(comm_cfg, enabled=False)
            step = make_compressed_step(cfg, opt_cfg, train_cfg, None, t,
                                        comm_cfg, mesh=mesh)
            opt_state = init_compressed_opt_state(
                params, mesh.data_group, comm_cfg, opt_cfg)
        else:
            step = make_baseline_step(cfg, opt_cfg, train_cfg, mesh=mesh)
            opt_state = optm.init_state(params, opt_cfg)
        # The optimizers read the step count on the host; made under the
        # fake mode it is a fake tensor, which has no value to read.
        opt_state["step"] = 0
        return (lambda: step(params, opt_state, batch),
                (params, opt_state, batch))
    # the rank's rows: the batch over the data axis (a batch of 1 whole)
    b = max(1, shape.global_batch // mesh.data)
    if shape.kind == "prefill":
        batch = _batch(cfg, shape.seq_len, b, dev, seed)

        def prefill():
            with torch.no_grad():
                return prefill_logits(params, cfg, batch["tokens"],
                                      batch.get("prefix_emb"))
        return prefill, (params, batch)
    # decode: one new token against a seq_len-deep cache or state
    weight_codec = None
    if comm in ("qlc", "e4m3"):
        from repro_torch.comm.weights import compress_groups, \
            wire_shape_structs
        from repro_torch.serving.engine import place_wire
        t, plan = tables
        whole = convert.whole_leaf_shapes(cfg, "groups")
        if seed is None:
            # the model blocks' shapes: the wire is cut from them
            blocks = convert.init_local_params(cfg, None, "meta", m_i,
                                               mesh.model)["groups"]
            wired, weight_codec = wire_shape_structs(
                blocks, t, wire_caps or plan.capacity_words, mode=comm,
                whole_shapes=whole)
            wired = place_wire(_fake_like(wired, dev), col)
        else:
            wired, weight_codec = compress_groups(
                params["groups"], t, mode=comm, whole_shapes=whole,
                column=col, data_dims=convert.leaf_data_dims(
                    cfg, mesh.data, mesh.model, "groups"))
        params = dict(params, groups=wired)
    from repro_torch.models import init_decode_states
    whole = init_decode_states(cfg, shape.global_batch, shape.seq_len,
                               "meta")
    local = convert.shard_decode_states(whole, cfg, m_i, mesh.model, d_i,
                                        mesh.data)
    states = _fake_like(local, dev)
    if seed is None:
        tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    else:
        tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                            dtype=torch.int32, device=dev)
    pos = torch.full((b, 1), shape.seq_len - 1, dtype=torch.int32,
                     device=dev)

    def serve_step():
        with torch.no_grad():
            return decode_step(params, cfg, tok, states, pos,
                               weight_codec=weight_codec)
    return serve_step, (params, states, tok, pos)


def _fake_world(world: int):
    """A ``"fake"`` process group of ``world`` ranks in this process (rank
    0): collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs its own default process group; "
                           "this process already has one")
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())


def _mesh_for(world: int):
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    if world == 256:
        return make_production_mesh(), "single_pod_16x16"
    mesh = make_test_mesh(model=int(round(world ** 0.5)) or 1)
    return mesh, f"{mesh.data}x{mesh.model}"


def configure(arch: str, overrides: Optional[dict] = None) -> ModelConfig:
    """``get_config(arch)`` with ``--override`` values (``moe.<field>``
    for the MoE config)."""
    cfg = get_config(arch)
    if overrides:
        moe_ov = {k[4:]: v for k, v in overrides.items()
                  if k.startswith("moe.")}
        top = {k: v for k, v in overrides.items()
               if not k.startswith("moe.")}
        if moe_ov:
            top["moe"] = dataclasses.replace(cfg.moe, **moe_ov)
        cfg = dataclasses.replace(cfg, **top)
    return cfg


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, comm: str,
               dev: Optional[str] = None, early_stop: bool = True,
               wire_caps: Optional[Dict[str, int]] = None
               ) -> Tuple[OpRecord, List[str]]:
    """One rank's counted step of the cell over ``mesh`` (a world of fake
    ranks): ``(its OpRecord, rules_differ)``. ``early_stop=False`` counts
    each checkpointed block's recompute whole, as a step under
    ``torch.profiler`` runs it (there PyTorch's non-reentrant checkpoint
    does not stop its recompute early: on the card phi3's block
    recomputed its last product under the profiler and not without it).
    ``wire_caps``: a decode's weight wire slots by leaf (``build_cell``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.parallel import sharding as shd
    dev = fake_device() if dev is None else dev
    rules, differ = cell_rules(cfg, shape, mesh, comm)
    tables = None
    if comm in ("qlc", "e4m3") and shape.kind in ("train", "decode"):
        tables = cell_tables(shape.kind)
    with shd.use_rules(rules), use_mesh(mesh), FakeTensorMode(), \
            torch.utils.checkpoint.set_checkpoint_early_stop(early_stop):
        step, live = build_cell(cfg, shape, mesh, comm, dev, tables,
                                wire_caps=wire_caps)
        with count(live=live) as record:
            step()
    return record, differ


def cell_shape(cfg: ModelConfig, shape_name: str,
               shape_overrides: Optional[dict] = None) -> ShapeConfig:
    """The named shape of ``shapes_for(cfg)``, its ``seq_len`` or
    ``global_batch`` replaced where given (the card's smaller cells)."""
    shape = {s.name: s for s in shapes_for(cfg)}[shape_name]
    return dataclasses.replace(shape, **(shape_overrides or {}))


def kv_cache_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   comm: str) -> int:
    """The bytes of one rank's attention KV caches in a decode cell, as
    :func:`build_cell` cuts the decode states under the cell's rules (0
    for a train or prefill cell); computed from shapes."""
    if shape.kind != "decode":
        return 0
    from repro_torch import convert
    from repro_torch.models import init_decode_states
    from repro_torch.models.attention import KVCache
    from repro_torch.parallel import sharding as shd
    rules, _ = cell_rules(cfg, shape, mesh, comm)
    d_i, m_i = mesh.coords
    with shd.use_rules(rules):
        local = convert.shard_decode_states(
            init_decode_states(cfg, shape.global_batch, shape.seq_len,
                               "meta"), cfg, m_i, mesh.model, d_i, mesh.data)
    return sum(t.numel() * t.element_size() for st in local.values()
               if isinstance(st, KVCache) for t in (st.k, st.v))


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             comm: str = "baseline", overrides: Optional[dict] = None,
             world: int = 256, ops_out: Optional[str] = None,
             shape_overrides: Optional[dict] = None,
             early_stop: bool = True,
             wire_caps: Optional[Dict[str, int]] = None) -> dict:
    """Count one cell on a fake world of ``world`` ranks (256: the
    production 16 x 16 layout) and return the reference's JSON keys plus
    ``fits``, ``rules_differ``, ``counted`` and, under ``memory``, a
    decode's ``kv_cache_bytes`` a rank (:func:`kv_cache_bytes`)."""
    from repro_torch.launch.mesh import NO_PODS
    if multi_pod:
        raise NotImplementedError(NO_PODS)
    cfg = configure(arch, overrides)
    shape = cell_shape(cfg, shape_name, shape_overrides)
    t0 = time.time()
    _fake_world(world)
    try:
        mesh, mesh_name = _mesh_for(world)
        record, differ = count_cell(cfg, shape, mesh, comm,
                                    early_stop=early_stop,
                                    wire_caps=wire_caps)
        kv_bytes = kv_cache_bytes(cfg, shape, mesh, comm)
    finally:
        dist.destroy_process_group()
    terms = analysis.from_counts(arch, shape, mesh_name, world, record, cfg)
    if ops_out:
        with gzip.open(ops_out, "wt") as f:
            json.dump(record.to_json(), f)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "comm": comm,
        "chips": world, "count_s": round(time.time() - t0, 1),
        "counted": (f"computed from shapes: one rank's step on fake "
                    f"{fake_device()} tensors in a fake world of {world} "
                    "(torch.distributed 'fake' backend), no card"),
        "memory": {"argument_size_in_bytes": int(record.arg_bytes),
                   "peak_bytes": int(record.peak_bytes),
                   "kv_cache_bytes": kv_bytes},
        "roofline": terms.to_dict(),
        "kernels": record.kernel_calls(),
        "fits": record.peak_bytes <= hw.HBM_BYTES,
        "rules_differ": differ,
        "ok": True,
    }


def _cells():
    return [(arch, s.name) for arch in ASSIGNED
            for s in shapes_for(get_config(arch))]


def _sweep_one(arch: str, shape: str, comm: str, out: str) -> str:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--comm", comm, "--out", out]
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=CELL_TIMEOUT_S)
        rc, err = r.returncode, r.stderr
    except subprocess.TimeoutExpired:
        rc, err = -1, f"not counted within {CELL_TIMEOUT_S} s"
    if rc == 0:
        return f"ok   {arch} {shape}"
    with open(out, "w") as f:
        json.dump({"arch": arch, "shape": shape, "ok": False,
                   "mesh": "single_pod_16x16", "comm": comm,
                   "error": err[-4000:]}, f, indent=1)
    return f"FAIL {arch} {shape}: {err.strip().splitlines()[-1:]}"


def _same_prefill(base: str, out: str, comm: str) -> bool:
    """A prefill cell under ``comm``: the same step as the baseline's (the
    port's prefill moves no wire), so its counted baseline JSON and op
    record (or its failure) are written under ``comm`` with ``same_as``
    naming them. False when the baseline cell has not been run."""
    if not os.path.exists(base):
        return False
    with open(base) as f:
        d = json.load(f)
    d.update(comm=comm, same_as=os.path.basename(base))
    with open(out, "w") as f:
        json.dump(d, f, indent=1, default=str)
    ops = base.replace(".json", ".ops.json.gz")
    if os.path.exists(ops):
        with open(ops, "rb") as src, open(
                out.replace(".json", ".ops.json.gz"), "wb") as dst:
            dst.write(src.read())
    return True


def sweep(comm: str, out_dir: str, jobs: int):
    """Every ``ASSIGNED`` arch x ``shapes_for`` cell, one subprocess each
    (each needs its own default process group), ``jobs`` at a time; a
    cell that fails is written with ``ok: false`` and its error. As the
    reference's, a cell whose JSON is already there is skipped, so an
    interrupted sweep resumes (delete the folder to count again); a
    prefill cell under ``qlc`` or ``e4m3`` is its baseline cell
    (:func:`_same_prefill`), counted once."""
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if comm == "baseline" else f"__{comm}"
    todo = []
    for arch, shape in _cells():
        out = os.path.join(out_dir, f"{arch}__{shape}__single{suffix}.json")
        base = os.path.join(out_dir, f"{arch}__{shape}__single.json")
        if os.path.exists(out):
            print(f"skip {arch} {shape}", flush=True)
        elif suffix and shape.startswith("prefill") and _same_prefill(
                base, out, comm):
            print(f"same {arch} {shape}: a prefill moves no wire", flush=True)
        else:
            todo.append((arch, shape, out))
    with concurrent.futures.ThreadPoolExecutor(jobs) as pool:
        futs = [pool.submit(_sweep_one, arch, shape, comm, out)
                for arch, shape, out in todo]
        for f in concurrent.futures.as_completed(futs):
            print(f.result(), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--comm", default="baseline",
                    choices=["baseline", "qlc", "e4m3"])
    ap.add_argument("--world", type=int, default=256,
                    help="fake ranks: 256 is the production 16 x 16 layout; "
                    "a square number N*N lays out N x N, 1 one rank")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="replace the shape's sequence length")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="replace the shape's global batch")
    ap.add_argument("--no-checkpoint-early-stop", action="store_true",
                    help="count each checkpointed block's recompute whole, "
                    "as a step under torch.profiler runs it")
    ap.add_argument("--wire-caps", default=None,
                    help="a decode's weight wire slots: a JSON file of leaf "
                    "path -> words (a real wire's), else the plan's slot")
    ap.add_argument("--out", default=None)
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (python literal)")
    ap.add_argument("--sweep", action="store_true",
                    help="run every (arch x shape) cell in subprocesses")
    ap.add_argument("--out-dir", default="results/dryrun")
    ap.add_argument("--jobs", type=int, default=4,
                    help="sweep cells counted at once")
    args = ap.parse_args(argv)
    if args.sweep:
        sweep(args.comm, args.out_dir, args.jobs)
        return
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v
    ops_out = args.out.replace(".json", ".ops.json.gz") if args.out \
        else None
    caps = None
    if args.wire_caps:
        with open(args.wire_caps) as f:
            caps = json.load(f)
    shape_ov = {k: v for k, v in (("seq_len", args.seq_len),
                                  ("global_batch", args.global_batch))
                if v is not None}
    result = run_cell(args.arch, args.shape, args.multi_pod, args.comm,
                      overrides, world=args.world, ops_out=ops_out,
                      shape_overrides=shape_ov,
                      early_stop=not args.no_checkpoint_early_stop,
                      wire_caps=caps)
    result["overrides"] = overrides
    result["shape_overrides"] = shape_ov
    print(json.dumps({k: v for k, v in result.items() if k != "memory"},
                     indent=1, default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1, default=str)


if __name__ == "__main__":
    main()
