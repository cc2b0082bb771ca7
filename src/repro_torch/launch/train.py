"""Training launcher: data-parallel training over a ``torch.distributed``
process group, with the gradient and parameter wires QLC-compressed
(``--comm qlc``) or dense (``--comm baseline``).

``--comm qlc``: one backward pass over the first batch calibrates the
gradient codec (``calibrate_for_gradients``: its symbols counted by the
histogram kernel K6) and the parameters' histogram (K1) the parameter
codec; each step then runs the compressed ZeRO-1 step (K1 encode and K2
decode-accumulate on the reduce-scatter, K1 and K2 on the all-gather)
through ``Trainer``, which redoes a step whose escape pool overflowed
through the baseline step. Weights are random, from ``--seed``; data is
the reference's synthetic token stream.

Example (one H100; ``--reduced`` and ``--device cpu`` run on the CPU
with the kernels' plain versions):
  python -m repro_torch.launch.train --arch phi3-mini-3.8b --comm qlc \\
      --steps 4 --seq-len 512 --global-batch 4 --transport oneshot
  python -m repro_torch.launch.train --arch phi3-mini-3.8b --reduced \\
      --device cpu --comm qlc --steps 3

The launcher runs one rank; ``train()`` runs on whatever process group
its caller set up (``launch.mesh``). Flags of the reference that reach
code not ported yet raise ``NotImplementedError`` naming the ROADMAP
item.
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.comm.calibrate import (calibrate_for_gradients,
                                        histogram_of_tree)
from repro_torch.comm.compressed import CommConfig
from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core import CodecRegistry
from repro_torch.data import DataConfig, SyntheticDataset
from repro_torch.launch.mesh import data_parallel
from repro_torch.models import init_params
from repro_torch.models.transformer import resolve_device
from repro_torch.training import (OptConfig, Trainer, TrainerConfig,
                                  TrainConfig, init_compressed_opt_state,
                                  make_baseline_step, make_compressed_step,
                                  make_zero1_fallback)
from repro_torch.training import optimizer as optm


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def calibrate_registry(cfg: ModelConfig, params, batch, group
                       ) -> CodecRegistry:
    """The step's per-tensor-type registry: ``"grads"`` from one
    backward pass over the global ``batch`` (``calibrate_for_gradients``),
    ``"params"`` from the parameters' histogram. Rank 0 calibrates and
    the registry's JSON is broadcast, so every rank holds the same
    tables."""
    dev = next(iter(params.values())).device
    payload = [None]
    if dist.get_rank(group) == 0:
        b0 = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        tables, plan = calibrate_for_gradients(cfg, params, b0)
        reg = CodecRegistry()
        reg.register_tables("grads", tables, plan)
        reg.register("params", histogram_of_tree(params),
                     chunk_symbols=plan.chunk_symbols)
        payload = [reg.to_json()]
    if dist.get_world_size(group) > 1:
        dist.broadcast_object_list(payload, src=dist.get_global_rank(
            group, 0), group=group)
    return CodecRegistry.from_json(payload[0])


def train(cfg: ModelConfig, *, comm: str = "qlc", steps: int = 4,
          seq_len: int = 128, global_batch: int = 8,
          transport: str = "oneshot", microbatches: int = 1,
          lr: float = 3e-4, device="cuda", seed: int = 0,
          registry: Optional[CodecRegistry] = None,
          wire_enabled: bool = True, params=None) -> Dict[str, Any]:
    """Run the launcher's path on the default process group (one rank of
    ``device``'s backend is set up, and torn down after, when none
    exists) and return what it produced: ``history`` (per step: loss,
    seconds, ok), ``comm_fallbacks``, the final ``params`` and
    ``opt_state``; with ``comm="qlc"`` also the ``registry``,
    ``calibrate_s`` (nothing is calibrated when a registry is given), the
    step and its
    channels, and the modeled wire bytes per symbol of both wires.
    ``wire_enabled=False`` runs the raw e4m3 twin (the same step with
    the codes uncompressed on the wire)."""
    if comm not in ("baseline", "qlc"):
        raise ValueError(f"comm must be 'baseline' or 'qlc', got {comm!r}")
    dev = resolve_device(device)
    with data_parallel(dev) as group:
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = init_params(cfg, gen, dev)
        opt_cfg = OptConfig(lr=lr, total_steps=steps,
                            warmup_steps=max(10, steps // 20))
        train_cfg = TrainConfig(microbatches=microbatches)
        data = SyntheticDataset(DataConfig(
            vocab_size=cfg.vocab_size,
            seq_len=seq_len - cfg.frontend_prefix_len,
            global_batch=global_batch, seed=seed))
        baseline = make_baseline_step(cfg, opt_cfg, train_cfg, group=group)
        out: Dict[str, Any] = {}
        fallback = None
        if comm == "qlc":
            t0 = time.perf_counter()
            if registry is None:
                registry = calibrate_registry(cfg, params, data.batch_at(0),
                                              group)
            _sync(dev)
            out["calibrate_s"] = time.perf_counter() - t0
            step = make_compressed_step(
                cfg, opt_cfg, train_cfg, group, registry,
                CommConfig(enabled=wire_enabled), transport=transport)
            opt_state = init_compressed_opt_state(params, group, registry,
                                                  opt_cfg)
            fallback = make_zero1_fallback(baseline, step, group)
            rs, ag = step.channels
            n = step.geometry(params).n_padded
            out.update(registry=registry, step=step, channels=step.channels,
                       grads_wire_bytes_per_symbol=(
                           rs.modeled_wire_bytes(n) / n),
                       params_wire_bytes_per_symbol=(
                           ag.modeled_wire_bytes(n) / n))
        else:
            step = baseline
            opt_state = optm.init_state(params, opt_cfg)
        trainer = Trainer(TrainerConfig(total_steps=steps), step,
                          fallback_step_fn=fallback)
        params, opt_state = trainer.run(params, opt_state, data)
        _sync(dev)
    out.update(history=trainer.history, comm_fallbacks=trainer.comm_fallbacks,
               params=params, opt_state=opt_state, data=data)
    return out


def _not_ported(args):
    if args.multi_pod or args.pods != 1 or args.transport == "hierarchical":
        raise NotImplementedError("pods and the hierarchical transport are "
                                  "not ported: ROADMAP queue 1, item 13")
    if args.distributed:
        raise NotImplementedError("a multi-host launch is not ported: "
                                  "ROADMAP queue 1, item 13")
    if args.moe_wire != "auto" or args.moe_transport != "auto":
        raise NotImplementedError("the MoE expert wire is not ported: "
                                  "ROADMAP queue 1, item 11")
    if args.adapt:
        raise NotImplementedError("online codec adaptation is not ported: "
                                  "ROADMAP queue 1, item 12")
    if args.autotune:
        raise NotImplementedError("transport autotuning is not ported: "
                                  "ROADMAP queue 1, item 6")
    if args.checkpoint_dir:
        raise NotImplementedError("checkpoints are not ported: ROADMAP "
                                  "queue 1, item 8")


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
                lr=args.lr, device=args.device, seed=args.seed)
    hist = res["history"]
    if args.comm == "qlc":
        print(f"calibrate {res['calibrate_s'] * 1e3:.1f} ms; wire "
              f"{res['grads_wire_bytes_per_symbol']:.4f} B/symbol (grads), "
              f"{res['params_wire_bytes_per_symbol']:.4f} (params); "
              f"{res['comm_fallbacks']} fallbacks")
    print(f"{len(hist)} steps, {sum(h['dt'] for h in hist) / len(hist) * 1e3:.1f}"
          f" ms/step; final loss {hist[-1]['loss']:.4f} (from "
          f"{hist[0]['loss']:.4f})")
    return res


if __name__ == "__main__":
    main()
