"""Expert parallelism across cards: deepseek-moe-16b at full width (1 of
28 layers, batch 4 x 512) on N NCCL ranks, one card each, laid out
``data x model`` (``launch.mesh.make_test_mesh``), for each ``--model``
size in turn.

Per layout, on every rank:

1. one MoE layer's forward on its real input (layer 0's, captured from
   the batch; each model row holds its data shard and cuts its tokens
   over the row, the batch declared over the data column, and each rank
   holds its blocks of the layer cut by their specs): raw expert
   parallelism, the QLC expert wire and its raw e4m3 twin — routing
   equal, the QLC wire bit-equal to its twin — and each timed (median of
   CUDA-event timings over ``--reps`` calls, the ranks lined up by a
   barrier before each);
2. ``launch.train.train(comm="baseline")`` for ``--steps`` steps with
   the QLC expert wire, its raw e4m3 twin (losses and this rank's
   parameters bit-equal) and raw expert parallelism; ms/step of each.

Rank 0 prints one line per check and a JSON line per layout, then the
card's name and power limit. Every rank runs the same code; a failed
check raises on the rank that saw it and the run exits non-zero.

Run from the root of a checkout on a machine with N cards:
  python3 tools/moe_ep_cards.py --cards 4 --model 4 2
``--device cpu`` runs the same on N gloo ranks with a reduced config
(a rehearsal of the control flow; its times are not a card's).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _median_ms(fn, reps, dev, barrier):
    import numpy as np
    import torch
    times = []
    for _ in range(reps):
        barrier()
        if dev.type == "cuda":
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _rank_main(rank, args, init):
    import dataclasses
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.comm.channel import Channel, ChannelSpec
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import shard_params
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.launch.mesh import (data_parallel, make_test_mesh,
                                         use_mesh)
    from repro_torch.launch.train import train
    from repro_torch.models import init_params, moe, next_token_loss
    from repro_torch.models.transformer import pytree_leaves

    cuda = args.device == "cuda"
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), num_layers=1)
    if not cuda:
        cfg = reduced(cfg, num_layers=1, remat="full")
    torch.use_deterministic_algorithms(True, warn_only=True)
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    with data_parallel(args.device, rank=rank, world_size=args.cards,
                       init_method=init):
        dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
               else torch.device("cpu"))

        def barrier():
            dist.barrier()

        def say(msg):
            if rank == 0:
                print(msg, flush=True)

        full = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
        batch = SyntheticDataset(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq_len,
            global_batch=args.global_batch)).batch_at(0)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        captured = []
        with torch.no_grad(), moe.capture_moe_traffic(captured):
            next_token_loss(full, dataclasses.replace(cfg, remat="none"),
                            batch["tokens"], batch["labels"])
        layer, x = captured[0]
        del captured
        ep = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="shardmap_a2a"))
        for model in args.model:
            mesh = make_test_mesh(model=model)
            tag = f"{mesh.data} x {mesh.model}"
            rows = x.shape[0] // mesh.data
            d_idx = mesh.coords[0]
            xl = x[d_idx * rows:(d_idx + 1) * rows].contiguous()
            lp = shard_params(layer, ep, mesh.coords[1], mesh.model,
                              specs=moe.moe_param_specs(ep))
            kw = dict(steps=args.steps, seq_len=args.seq_len,
                      global_batch=args.global_batch, device=args.device,
                      transport="oneshot", moe_transport="oneshot",
                      params=full)
            with use_mesh(mesh):
                q = train(cfg, comm="baseline", moe_wire="qlc", **kw)
                reg = q["registry"]
                chans = {
                    wire: {name: Channel(ChannelSpec(
                        codec=name, axis="model", transport="oneshot",
                        enabled=None if wire == "qlc" else False),
                        registry=reg)
                        for name in (moe.MOE_DISPATCH, moe.MOE_COMBINE)}
                    for wire in ("qlc", "twin")}
                outs, routes, layer_ms = {}, {}, {}
                with torch.no_grad():
                    for wire in ("raw", "qlc", "twin"):
                        rec = []
                        with moe.bind_moe_channels(chans.get(wire)), \
                                moe.batch_over(mesh.data_group):
                            with moe.capture_moe_routing(rec):
                                outs[wire] = moe.moe_block(lp, xl, ep)
                            layer_ms[wire] = _median_ms(
                                lambda: moe.moe_block(lp, xl, ep),
                                args.reps, dev, barrier)
                        routes[wire] = rec[0]
                for wire in ("qlc", "twin"):
                    if not (torch.equal(routes[wire]["idx"],
                                        routes["raw"]["idx"])
                            and torch.equal(routes[wire]["keep"],
                                            routes["raw"]["keep"])):
                        raise AssertionError(f"{tag}: {wire} routing "
                                             "differs from raw")
                if not torch.equal(outs["qlc"], outs["twin"]):
                    raise AssertionError(f"{tag}: the QLC expert wire's "
                                         "layer output differs from its "
                                         "raw e4m3 twin's")
                t = train(cfg, comm="baseline", moe_wire="qlc", registry=reg,
                          wire_enabled=False, **kw)
                r = train(ep, comm="baseline", moe_wire="raw", **kw)
            losses = {name: [h["loss"] for h in res["history"]]
                      for name, res in (("qlc", q), ("twin", t), ("raw", r))}
            if losses["qlc"] != losses["twin"]:
                raise AssertionError(f"{tag}: losses of the QLC expert wire "
                                     "differ from its twin's")
            if not all(torch.equal(a, b) for a, b in zip(
                    pytree_leaves(q["params"]), pytree_leaves(t["params"]))):
                raise AssertionError(f"{tag}: parameters of the QLC expert "
                                     "wire differ from its twin's")
            if not all(math.isfinite(v) for v in losses["raw"]):
                raise AssertionError(f"{tag}: raw losses {losses['raw']}")
            step_ms = {name: [round(h["dt"] * 1e3, 3)
                              for h in res["history"]]
                       for name, res in (("qlc", q), ("twin", t), ("raw", r))}
            n_local = sum(p.numel() for p in pytree_leaves(q["params"]))
            row = {"layout": tag, "cards": args.cards,
                   "layer_ms": layer_ms, "step_ms": step_ms,
                   "losses": losses, "wire": q["moe"],
                   "drops": int((~routes["raw"]["keep"]).sum()),
                   "local_params": n_local}
            gathered = [None] * args.cards
            dist.all_gather_object(gathered, row)
            say(f"[{tag}] one layer's forward on data row 0's "
                f"{list(xl.shape)} tokens: raw {layer_ms['raw']:.3f} ms, QLC wire "
                f"{layer_ms['qlc']:.3f}, raw e4m3 twin {layer_ms['twin']:.3f}"
                f"; the QLC wire == its twin on every rank (outputs, then "
                f"{args.steps} training steps: losses and parameters)")
            say(json.dumps({"layout": tag, "ranks": gathered}))
            del q, t, r, lp, xl
            if cuda:
                torch.cuda.empty_cache()
    if cuda and rank == 0:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--model", type=int, nargs="+", default=[4, 2])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if args.device == "cuda":
        if torch.cuda.device_count() < args.cards:
            raise SystemExit(f"needs {args.cards} cards, found "
                             f"{torch.cuda.device_count()}")
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        from repro_torch.kernels import qlc_fused
        qlc_fused.build_kernels()       # once, before the ranks load it
    from repro_torch.launch.mesh import free_port
    init = f"tcp://localhost:{free_port()}"
    mp.start_processes(_rank_main, args=(args, init), nprocs=args.cards,
                       start_method="spawn")


if __name__ == "__main__":
    main()
