"""Training launcher: data-parallel training over a ``torch.distributed``
process group, with the gradient and parameter wires QLC-compressed
(``--comm qlc``) or dense (``--comm baseline``), and for an MoE model
the expert all-to-all over the model axis.

``--comm qlc``: one backward pass over the first batch calibrates the
gradient codec (``calibrate_for_gradients``: its symbols counted by the
histogram kernel K6) and the parameters' histogram (K1) the parameter
codec; each step then runs the compressed ZeRO-1 step (K1 encode and K2
decode-accumulate on the reduce-scatter, K1 and K2 on the all-gather)
through ``Trainer``, which redoes a step whose escape pool overflowed
through the baseline step. Weights are random, from ``--seed``; data is
the reference's synthetic token stream.

``--autotune`` (with ``--comm qlc``) measures the decode rate on the
device and, over two or more ranks, the group's wire rate, and caches
the tuned transport of each wire in the registry, where the step's
``"auto"`` channels find it. ``--checkpoint-dir`` saves ``(params,
opt_state)`` through ``CheckpointManager`` every ``--checkpoint-every``
steps and after the last, and a launch that finds a checkpoint there
resumes from its step. Over any layout of ranks a checkpoint is one
directory of whole leaves in the reference's format
(:func:`checkpoint_layout`): a baseline one resumes on any ``data x
model`` layout, a compressed one on its own. Each checkpoint carries
the wire registry, so a resumed run encodes with the codecs the
interrupted one had reached (the registry is calibrated from the
initial parameters and batch 0 where there is none); ``--autotune``
tunes after the restore.

``--adapt`` (with ``--comm qlc``) adapts the codecs online: the step
counts both wires' symbols beside their encode (K1's histogram output),
every ``--adapt-every`` steps the drift policy compares the measured
bits/symbol of each wire's traffic with its codec's plan, and a drifted
codec is recalibrated, registered under a new scheme-id and the step
rebuilt. It prints each check and each swap.

``--moe-wire`` (an MoE model): ``qlc`` switches ``moe.impl`` to
expert-parallel ``shardmap_a2a`` and moves the routed tokens as QLC
containers, one calibrated codec per direction (``moe/dispatch``,
``moe/combine``; ``calibrate_moe_entries``, counted by K6) on the model
axis, over ``--moe-transport``; ``auto`` means ``qlc`` under ``--comm
qlc`` without switching the impl (so it opens no channel unless the
config already says ``shardmap_a2a``), else ``raw``. It prints each
direction's scheme-id, planned bits/symbol and the wire bytes per symbol
of the last step's payload.

Example (one H100; ``--reduced`` and ``--device cpu`` run on the CPU
with the kernels' plain versions):
  python -m repro_torch.launch.train --arch phi3-mini-3.8b --comm qlc \\
      --steps 4 --seq-len 512 --global-batch 4 --transport oneshot
  python -m repro_torch.launch.train --arch phi3-mini-3.8b --reduced \\
      --device cpu --comm qlc --steps 3
  python -m repro_torch.launch.train --arch phi3-mini-3.8b --reduced \\
      --device cpu --comm qlc --steps 6 --autotune \\
      --checkpoint-dir /tmp/ckpt --checkpoint-every 3
  python -m repro_torch.launch.train --arch phi3-mini-3.8b --reduced \\
      --device cpu --comm qlc --steps 4 --adapt --adapt-every 1
  python -m repro_torch.launch.train --arch deepseek-moe-16b --reduced \\
      --device cpu --comm qlc --moe-wire qlc --steps 2

The launcher runs one rank; ``train()`` runs on whatever process group
its caller set up (``launch.mesh``), over the mesh in scope
(``launch.mesh.use_mesh``) when there is one: over a mesh with a model
axis above 1 any model (dense, MoE, recurrent) trains tensor-parallel,
each rank on its cut of the same initial tree, the wire over its data
column. Flags of the reference that reach code not ported yet raise
``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Layout
from repro_torch.comm.calibrate import (calibrate_for_gradients,
                                        calibrate_moe_entries,
                                        histogram_of_tree)
from repro_torch.comm.channel import Channel, ChannelSpec
from repro_torch.comm.compressed import CommConfig
from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.convert import (init_local_params, leaf_data_dims,
                                 leaf_model_dims, shard_params)
from repro_torch.configs.base import ModelConfig
from repro_torch.core import CodecRegistry
from repro_torch.data import DataConfig, SyntheticDataset
from repro_torch.launch.mesh import current_mesh, data_parallel, \
    fsdp_column, make_test_mesh
from repro_torch.models import init_params, moe
from repro_torch.models.transformer import resolve_device
from repro_torch.training import (OptConfig, Trainer, TrainerConfig,
                                  TrainConfig, init_compressed_opt_state,
                                  make_baseline_step, make_compressed_step,
                                  make_zero1_fallback)
from repro_torch.training import optimizer as optm
from repro_torch.parallel.sharding import get_rules, tp_only, use_rules
from repro_torch.training.train_step import flat_geometry


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _local_dispatch(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with an MoE's dispatch on one rank (``gspmd``): routing
    does not depend on the impl, and calibration runs on rank 0 alone."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            impl="gspmd"))


def _on_rank0(group, make) -> CodecRegistry:
    """``make()`` on rank 0 of ``group`` (a registry), its JSON broadcast
    so every rank holds the same tables."""
    payload = [None]
    if dist.get_rank(group) == 0:
        payload = [make().to_json()]
    if dist.get_world_size(group) > 1:
        dist.broadcast_object_list(payload, src=dist.get_global_rank(
            group, 0), group=group)
    return CodecRegistry.from_json(payload[0])


def calibrate_registry(cfg: ModelConfig, params, batch, group
                       ) -> CodecRegistry:
    """The step's per-tensor-type registry: ``"grads"`` from one
    backward pass over the global ``batch`` (``calibrate_for_gradients``),
    ``"params"`` from the parameters' histogram. Rank 0 calibrates and
    the registry's JSON is broadcast, so every rank holds the same
    tables."""
    dev = next(iter(params.values())).device

    def make():
        b0 = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        tables, plan = calibrate_for_gradients(_local_dispatch(cfg), params,
                                               b0)
        reg = CodecRegistry()
        reg.register_tables("grads", tables, plan)
        reg.register("params", histogram_of_tree(params),
                     chunk_symbols=plan.chunk_symbols)
        return reg
    return _on_rank0(group, make)


def calibrate_moe_registry(cfg: ModelConfig, params, batch, group,
                           registry: Optional[CodecRegistry] = None
                           ) -> CodecRegistry:
    """``registry`` (or a new one) with the expert wire's two codecs
    (``moe.MOE_DISPATCH``, ``moe.MOE_COMBINE``) calibrated by rank 0 on
    the global ``batch`` and the global ``params``
    (``calibrate_moe_entries``; names already there are kept)."""
    dev = next(iter(params.values())).device

    def make():
        reg = CodecRegistry() if registry is None \
            else CodecRegistry.from_json(registry.to_json())
        b0 = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        calibrate_moe_entries(reg, cfg, params, b0)
        return reg
    return _on_rank0(group, make)


def resolve_moe_wire(cfg: ModelConfig, moe_wire: str, comm: str):
    """The reference's ``--moe-wire`` rule -> ``(cfg, wire)``: an
    explicit ``"qlc"`` switches an MoE to ``shardmap_a2a``; ``"auto"``
    is ``"qlc"`` under ``comm="qlc"`` (without switching) and ``"raw"``
    otherwise. The wire is ``"qlc"`` only where channels open: an MoE
    on ``shardmap_a2a``."""
    if moe_wire not in ("auto", "raw", "qlc"):
        raise ValueError(f"moe_wire must be 'auto', 'raw' or 'qlc', got "
                         f"{moe_wire!r}")
    if moe_wire == "qlc" and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="shardmap_a2a"))
    if moe_wire == "auto":
        moe_wire = "qlc" if comm == "qlc" else "raw"
    if cfg.moe is None or cfg.moe.impl != "shardmap_a2a":
        moe_wire = "raw"
    return cfg, moe_wire


def _autotune_transports(registry: CodecRegistry, n_padded: int, group,
                         device, **probe) -> Dict[str, Channel]:
    """Autotune the step's two wires into ``registry``: one ``"auto"``
    channel per tensor type over ``group`` (the binding the compressed
    step opens), tuned at the payload each moves per rank of a flat
    gradient of ``n_padded`` values: ``"grads"`` on the reduce-scatter,
    ``"params"`` on the all-gather. ``probe`` goes to
    ``Channel.autotune`` (``probe_symbols``, ``repeats``). Returns the
    tuned channels (their ``model`` holds the measured rates)."""
    d = dist.get_world_size(group)
    tuned = {}
    for name, is_reduce in (("grads", True), ("params", False)):
        ch = Channel(ChannelSpec(codec=name, transport="auto", group=group),
                     registry=registry)
        tuned[name] = ch.autotune(4 * (n_padded // d), is_reduce=is_reduce,
                                  device=device, **probe)
        logging.info("autotuned %s over %d ranks: %s", name, d,
                     tuned[name].transport)
    return tuned


def checkpoint_layout(cfg: ModelConfig, mesh, group, compressed: bool
                      ) -> Layout:
    """How the ranks of :func:`train`'s run hold ``(params, opt_state)``
    over ``mesh`` (None: ``group``'s ranks as a data axis): the
    parameters, and the baseline step's AdamW moments, cut over the
    model axis as ``convert.shard_params`` cuts them, and, under rules in
    scope that cut parameters by FSDP, over the data column too; the
    compressed step's ``m`` and ``v`` a ``[seg]`` row a rank of the
    reference's ``[data, model, seg]``."""
    data, model = ((mesh.data, mesh.model) if mesh is not None
                   else (dist.get_world_size(group), 1))
    dims = {} if model == 1 else {
        k: d for k, d in leaf_model_dims(cfg, model).items()
        if d is not None}
    ddims = {}
    if not compressed and fsdp_column(mesh) is not None and data > 1:
        ddims = {k: d for k, d in leaf_data_dims(cfg, data, model).items()
                 if d is not None}
    trees = ("0",) if compressed else ("0", "1/m", "1/v")
    return Layout(data=data, model=model, rank=dist.get_rank(group),
                  group=group,
                  cut={f"{t}/{k}": d for t in trees for k, d in dims.items()},
                  data_cut={f"{t}/{k}": d for t in trees
                            for k, d in ddims.items()},
                  rows=frozenset({"1/m", "1/v"} if compressed else ()))


def train(cfg: ModelConfig, *, comm: str = "qlc", steps: int = 4,
          seq_len: int = 128, global_batch: int = 8,
          transport: str = "oneshot", microbatches: int = 1,
          lr: float = 3e-4, device="cuda", seed: int = 0,
          registry: Optional[CodecRegistry] = None,
          wire_enabled: bool = True, params=None, autotune: bool = False,
          checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 100, adapt: bool = False,
          adapt_every: int = 10, moe_wire: str = "auto",
          moe_transport: str = "auto") -> Dict[str, Any]:
    """Run the launcher's path on the default process group (one rank of
    ``device``'s backend is set up, and torn down after, when none
    exists) and return what it produced: ``history`` (per step: loss,
    seconds, ok), ``comm_fallbacks``, the final ``params`` and
    ``opt_state``, ``start_step`` (past 0 when resumed from
    ``checkpoint_dir``), ``checkpoint`` (the stage seconds of the restore
    and of the last save, ``Trainer.ckpt_seconds``); with ``comm="qlc"``
    also the ``registry``, ``calibrate_s`` (nothing is calibrated when a
    registry is given), the step and its channels, the modeled wire
    bytes per symbol of both wires, and with ``autotune`` the tuned
    channels (``tuned``).
    ``wire_enabled=False`` runs the raw e4m3 twin (the same step with
    the codes uncompressed on the wire). Every rank checkpoints into
    the one ``checkpoint_dir``, which holds the whole state as the
    reference saves it (:func:`checkpoint_layout`), and all resume from
    its latest step, restored into the state the run built (a caller's
    ``params`` tensors among it are overwritten). A checkpoint of a
    ``"qlc"`` run carries the wire registry, and a resumed run encodes
    with it.

    ``adapt`` (with ``comm="qlc"``): the step runs with wire telemetry,
    and a ``TrainingAdapter`` checks the ``"grads"`` and ``"params"``
    codecs every ``adapt_every`` steps; a drifted codec is recalibrated
    from its traffic, registered under a new scheme-id, and the step
    (and its fallback) rebuilt. ``adapt`` then holds the swaps
    (``events``, ``SwapEvent``; ``swaps``: per swapping check its step
    and the seconds of the check and of the rebuild), the checks
    (``checks``: per name the scheme-id, measured and planned
    bits/symbol, flagged) and the ``controller``.

    An MoE model: ``moe_wire`` as :func:`resolve_moe_wire`; over a wire
    of ``"qlc"`` the experts are split over the model axis of the mesh
    in scope (a ``world`` x 1 one when none is: a model axis of 1). Its
    two codecs join ``registry`` (or a new one), ``wire_enabled=False``
    turns them to the raw e4m3 twin too, and ``moe`` then holds per
    direction the scheme-id, the planned bits/symbol and the wire bytes
    per symbol of the last step's payload, measured
    (``Channel.all_to_all``) and modeled.

    Over a mesh in scope with a model axis above 1 any model trains
    tensor-parallel. Rank 0 calibrates what is to be calibrated (the
    ``"grads"`` and ``"params"`` codecs, the expert wire's) on the whole
    tree (``params``, or initialized from ``seed``), then cuts it to its
    blocks (``convert.shard_params``) and drops it; the other ranks, and
    rank 0 when nothing is to be calibrated, draw their blocks a leaf at
    a time (``convert.init_local_params``: the same numbers, without the
    whole tree). The batch is split over the data axis, the wire (and its
    autotuning) runs over the rank's data column, and ``params`` and
    ``opt_state`` come back local. A baseline checkpoint resumes on any
    ``data x model`` layout whose specs resolve; a compressed one only on
    the layout it was saved on (its flat state is ``[data, model, seg]``,
    which the reference does not cut again either), else every rank
    raises ``ValueError`` naming both layouts before the first step.

    Under rules in scope that cut parameters by FSDP (``parallel.
    sharding.make_rules()``, as the reference's launcher honours its
    rules) a ``"baseline"`` run over a mesh is ZeRO-3: each rank holds
    its ``data x model`` block of the parameters and the moments (drawn
    a leaf at a time, or cut from ``params``), and its checkpoints cut
    the same way. A ``"qlc"`` run keeps TP-only parameters
    (``parallel.sharding.tp_only``), as the reference's compressed step
    does."""
    if comm not in ("baseline", "qlc"):
        raise ValueError(f"comm must be 'baseline' or 'qlc', got {comm!r}")
    cfg, moe_wire = resolve_moe_wire(cfg, moe_wire, comm)
    dev = resolve_device(device)
    rules = get_rules() if comm == "baseline" else tp_only(get_rules())
    with data_parallel(dev) as group, use_rules(rules):
        mesh = current_mesh()
        if mesh is None and cfg.moe is not None \
                and cfg.moe.impl == "shardmap_a2a":
            mesh = make_test_mesh(model=1)
        col = fsdp_column(mesh)
        d_i, d_n = (col.index, col.size) if col is not None else (0, 1)
        tp = mesh is not None and mesh.model > 1
        cut = tp or col is not None
        wire_group = mesh.data_group if tp else group
        calibrates = (comm == "qlc" and registry is None) or (
            moe_wire == "qlc" and (registry is None or any(
                n not in registry for n in (moe.MOE_DISPATCH,
                                            moe.MOE_COMBINE))))
        local = False
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            if cut and not (calibrates and dist.get_rank(group) == 0):
                params = init_local_params(cfg, gen, dev, mesh.coords[1],
                                           mesh.model, d_i, d_n)
                local = True
            else:
                params = init_params(cfg, gen, dev)
        opt_cfg = OptConfig(lr=lr, total_steps=steps,
                            warmup_steps=max(10, steps // 20))
        train_cfg = TrainConfig(microbatches=microbatches)
        data = SyntheticDataset(DataConfig(
            vocab_size=cfg.vocab_size,
            seq_len=seq_len - cfg.frontend_prefix_len,
            global_batch=global_batch, seed=seed))
        out: Dict[str, Any] = {}
        save_extra = None
        if comm == "qlc":
            t0 = time.perf_counter()
            if registry is None:
                registry = calibrate_registry(cfg, params, data.batch_at(0),
                                              group)
            _sync(dev)
            out["calibrate_s"] = time.perf_counter() - t0
        moe_channels = None
        if moe_wire == "qlc":
            registry = calibrate_moe_registry(cfg, params, data.batch_at(0),
                                              group, registry)
            moe_channels = {name: Channel(ChannelSpec(
                codec=name, transport=moe_transport, axis="model",
                group=mesh.model_group,
                enabled=None if wire_enabled else False), registry=registry)
                for name in (moe.MOE_DISPATCH, moe.MOE_COMBINE)}
            out["registry"] = registry
        if cut and not local:
            params = shard_params(params, cfg, mesh.coords[1], mesh.model,
                                  data_index=d_i, data_size=d_n)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        baseline = make_baseline_step(cfg, opt_cfg, train_cfg, group=group,
                                      mesh=mesh, moe_channels=moe_channels)
        if comm == "qlc":
            opt_state = init_compressed_opt_state(params, wire_group,
                                                  registry, opt_cfg)

            def save_extra():
                return {"wire_registry": registry.to_json_dict()}
        else:
            opt_state = optm.init_state(params, opt_cfg)
        trainer = Trainer(TrainerConfig(total_steps=steps,
                                        checkpoint_dir=checkpoint_dir,
                                        checkpoint_every=checkpoint_every),
                          baseline, save_extra=save_extra,
                          layout=checkpoint_layout(cfg, mesh, group,
                                                   comm == "qlc"))
        params, opt_state, start = trainer.restore_or(params, opt_state)
        if comm == "qlc":
            saved = trainer.restored_extra.get("wire_registry")
            if saved is not None:
                registry = CodecRegistry.from_json_dict(saved)
            if autotune:
                n = flat_geometry(params, dist.get_world_size(wire_group),
                                  registry["grads"].config()).n_padded
                out["tuned"] = _autotune_transports(registry, n, wire_group,
                                                    dev)

            def build_step():
                step = make_compressed_step(
                    cfg, opt_cfg, train_cfg, group, registry,
                    CommConfig(enabled=wire_enabled), transport=transport,
                    moe_channels=moe_channels, mesh=mesh, telemetry=adapt)
                trainer.step_fn = step
                trainer.fallback_step_fn = make_zero1_fallback(baseline,
                                                               step)
                return step

            step = build_step()
            rs, ag = step.channels
            n = step.geometry(params).n_padded
            out.update(registry=registry, step=step, channels=step.channels,
                       grads_wire_bytes_per_symbol=(
                           rs.modeled_wire_bytes(n) / n),
                       params_wire_bytes_per_symbol=(
                           ag.modeled_wire_bytes(n) / n))
            if adapt:
                out["adapt"] = _adapter(trainer, registry, build_step,
                                        adapt_every)
        wire_log: Dict[str, Any] = {}
        with moe.record_moe_wire(wire_log):
            params, opt_state = trainer.run(params, opt_state, data,
                                            start_step=start)
        _sync(dev)
        if moe_channels is not None:
            out["moe"] = _moe_report(cfg, mesh, moe_channels, wire_log,
                                     global_batch * data.cfg.seq_len, comm)
    out.update(history=trainer.history, comm_fallbacks=trainer.comm_fallbacks,
               params=params, opt_state=opt_state, data=data,
               start_step=start, checkpoint=trainer.ckpt_seconds)
    return out


def _moe_report(cfg: ModelConfig, mesh, channels, wire_log, n_tokens: int,
                comm: str) -> Dict[str, Dict[str, Any]]:
    """Per expert-wire direction: its codec's scheme-id and planned
    bits/symbol, and the wire bytes per symbol of the last step's
    payload, measured (``None`` before any step) and modeled (the
    baseline step's layers see the whole batch of ``n_tokens``, the
    compressed step's a data shard)."""
    pieces = mesh.size if comm == "baseline" else mesh.model
    row = moe.row_geometry(cfg, n_tokens // mesh.data, pieces,
                           mesh.model)["row_values"]
    out = {}
    for name, ch in channels.items():
        nbytes, n = wire_log.get(name, (None, None))
        out[name] = {
            "scheme_id": ch.entry.scheme_id,
            "planned_bits": ch.entry.plan.expected_bits_per_symbol,
            "wire_bytes_per_symbol": None if n is None else nbytes / n,
            "modeled_wire_bytes_per_symbol": (
                ch.modeled_wire_bytes(row) / row)}
    return out


def _adapter(trainer: Trainer, registry: CodecRegistry, build_step,
             every: int) -> Dict[str, Any]:
    """Install a ``TrainingAdapter`` over ``registry``'s ``"grads"`` and
    ``"params"`` codecs as ``trainer``'s ``on_step``; returns what
    :func:`train` reports under ``adapt``."""
    from repro_torch.adaptive import AdaptiveController, TrainingAdapter
    controller = AdaptiveController(registry)
    adapter = TrainingAdapter(
        controller, build_step, grad_key="grads", param_key="params",
        check_every=every,
        on_swap=lambda ev: logging.info(
            "codec hot-swap %s: scheme-id %d -> %d (%.4f measured vs %.4f "
            "planned bits/symbol; new plan %.4f)", ev.name,
            ev.old_scheme_id, ev.new_scheme_id, ev.measured_bits,
            ev.old_expected_bits, ev.new_expected_bits))
    trainer.on_step = adapter
    return {"events": controller.events, "checks": adapter.checks,
            "swaps": adapter.swaps, "controller": controller}


def _not_ported(args):
    if args.multi_pod or args.pods != 1 or args.transport == "hierarchical":
        raise NotImplementedError("pods and the hierarchical transport are "
                                  "not ported: ROADMAP queue 1, item 13")
    if args.distributed:
        raise NotImplementedError("a multi-host launch is not ported: "
                                  "ROADMAP queue 1, item 13")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="small same-family config (CPU verification)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--comm", default="baseline",
                    choices=["baseline", "qlc"])
    ap.add_argument("--transport", default="auto",
                    choices=["auto", "oneshot", "ring", "hierarchical"],
                    help="compressed-collective transport: 'auto' lets the "
                         "planner's alpha-beta model pick one-shot vs ring "
                         "(+ hop chunking) per collective")
    ap.add_argument("--moe-wire", default="auto",
                    choices=["auto", "qlc", "raw"])
    ap.add_argument("--moe-transport", default="auto",
                    choices=["auto", "oneshot", "ring"])
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--adapt", action="store_true")
    ap.add_argument("--adapt-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    _not_ported(args)

    logging.basicConfig(level=logging.INFO)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    res = train(cfg, comm=args.comm, steps=args.steps,
                seq_len=args.seq_len or (128 if args.reduced else 4096),
                global_batch=args.global_batch or (8 if args.reduced
                                                   else 256),
                transport=args.transport, microbatches=args.microbatches,
                lr=args.lr, device=args.device, seed=args.seed,
                autotune=args.autotune and args.comm == "qlc",
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every,
                adapt=args.adapt and args.comm == "qlc",
                adapt_every=args.adapt_every, moe_wire=args.moe_wire,
                moe_transport=args.moe_transport)
    hist = res["history"]
    if args.comm == "qlc":
        print(f"calibrate {res['calibrate_s'] * 1e3:.1f} ms; wire "
              f"{res['grads_wire_bytes_per_symbol']:.4f} B/symbol (grads), "
              f"{res['params_wire_bytes_per_symbol']:.4f} (params); "
              f"{res['comm_fallbacks']} fallbacks")
    for name, r in res.get("moe", {}).items():
        m = r["wire_bytes_per_symbol"]
        print(f"moe codec {name}: scheme-id {r['scheme_id']}, planned "
              f"{r['planned_bits']:.4f} bits/symbol; wire "
              f"{'none' if m is None else f'{m:.4f}'} B/symbol measured "
              f"(last step), {r['modeled_wire_bytes_per_symbol']:.4f} "
              "modeled")
    for name, ch in res.get("tuned", {}).items():
        t = ch.transport
        print(f"autotuned {name}: {t.kind} x{t.hop_chunks} (decode "
              f"{ch.model.decode_Bps:.4g} B/s)")
    if "adapt" in res:
        for c in res["adapt"]["checks"]:
            m = c["measured_bits"]
            print(f"adapt check after step {c['step'] + 1}: {c['name']} "
                  f"scheme-id {c['scheme_id']}, measured "
                  f"{'none' if m is None else f'{m:.4f}'} vs planned "
                  f"{c['planned_bits']:.4f} bits/symbol, flagged "
                  f"{c['flagged']}")
        for ev in res["adapt"]["events"]:
            print(f"codec hot-swap {ev.name}: scheme-id {ev.old_scheme_id} "
                  f"-> {ev.new_scheme_id} ({ev.measured_bits:.4f} measured "
                  f"vs {ev.old_expected_bits:.4f} planned bits/symbol; new "
                  f"plan {ev.new_expected_bits:.4f})")
    if res["start_step"]:
        print(f"resumed from step {res['start_step']} "
              f"({args.checkpoint_dir})")
    if hist:
        print(f"{len(hist)} steps, "
              f"{sum(h['dt'] for h in hist) / len(hist) * 1e3:.1f} ms/step; "
              f"final loss {hist[-1]['loss']:.4f} (from "
              f"{hist[0]['loss']:.4f})")
    else:
        print(f"no step left to run (steps {args.steps})")
    return res


if __name__ == "__main__":
    main()
