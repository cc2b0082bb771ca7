"""Tensor parallelism across cards: a config at full width (``--arch``,
default phi3-mini-3.8b at all 32 layers: f32 parameters, bf16 compute;
one card cannot hold its f32 parameters, gradients, moments and the
step's flat copies), trained by ``launch.train.train(comm="qlc")`` on N
NCCL ranks, one card each, laid out ``data x model``
(``launch.mesh.make_test_mesh``), for each ``--model`` size in turn: 2
gives 2 x 2 on 4 cards, 4 gives 1 x 4. Every block kind splits over the
model axis: dense, MoE (``--moe-impl`` picks the dispatch; with
``shardmap_a2a`` the routed tokens cross the row on the QLC expert wire,
``moe/dispatch`` and ``moe/combine`` calibrated on rank 0) and recurrent.
``--arch jamba-1.5-large-398b`` trains one mamba layer with its dense
swiglu FFN (``attn_every=None``) at its widths.

Per layout, on every rank:

1. ``--steps`` compressed steps (batch 4 x 512, transport oneshot,
   calibrated on rank 0 from the whole tree, then each rank's cut; the
   other ranks draw only their blocks): every ``ok`` true, no fallback,
   finite losses; ms/step; the gradient and parameter wires' modeled
   B/symbol (and the expert wire's, measured and modeled); peak device
   memory;
2. the leaves that the model axis does not split (the norms) hold the
   same bits on every rank of each model row;
3. the same steps with the raw e4m3 twin from the same start and
   registry: losses and this rank's parameters bit-equal to the QLC
   run's;
4. K1 (with codes) and K2 (accumulate form) at this layout's per-rank
   flat-gradient shape, on this rank's own flat gradient of the first
   batch, held bit for bit against their plain versions on the first
   and last 4096 chunks and timed alone (``chip_smoke.train_path_fused``).

Rank 0 prints one line per check and a JSON line per layout, then the
card's name and power limit. Every rank runs the same code; a failed
check raises on the rank that saw it and the run exits non-zero.

``--serve`` serves the arch instead, on the ``N / M x M`` layout of
each ``--model`` size M: ``launch.serve.serve`` under the mesh (each
rank draws its blocks, the weight codec calibrated on the row's summed
histogram, the QLC wire of its blocks, the dense engine), then
``Engine(mesh=)`` paged sync and async (``--kv-block`` tokens a block,
``KVCacheSpec(axis="model")``). Over a data column (M < N) the slots
split over it; with ``--decode-seq-shard``
(``make_rules(decode_seq_shard=True)`` in scope) the KV caches'
sequence does instead; with ``--reference-rules`` the reference's decode
rules for the arch, ``--batch`` and the mesh
(``parallel.sharding.decode_rules``: the KV caches' sequence over the
model row where the KV heads do not divide it, the slots over the data
column; at ``--batch 1`` the sequence over every rank). ``--prefill-chunk``
feeds long prompts that many tokens a step, ``--dtype`` sets the compute
dtype. Checks on every rank, once the mesh has gathered every rank's
outcome: tokens, events and every registry's digest the same on every
rank, every step's logits (hashed) the same over each row (under a
sequence split without a slot split, on every rank); the paged runs'
tokens equal to the dense engine's; no overflow fallback (async
prefetch misses, blocks redone on the sync path, are reported). Over a data column of a dense
model each row then serves its replica's requests alone (a ``1 x M``
engine at ``batch / (N / M)``, fed in order the requests the split
schedule put there; ``serving.scheduler.replica_requests``): tokens and
every step's logits equal, for each run. Under the sequence split rank
0 serves the requests alone with no mesh: tokens equal, every step's
logits within rtol 1e-5 / atol 1e-5 (with the slots split too, the
dense and paged runs are held against each other only); with
``--against-one-rank`` a model row without a sequence split is held so
too (the whole tree gathered on card 0). For phi3 at
``1 x N`` rank 0 then
serves the whole model alone, from the same seed, and reports (not
gates) how many requests agree with the row and the first divergent
step's top-1 margin. Rank 0 prints ms/token prefill and decode of each
run, a decode step's kernel launches, all-reduces and all-gathers, the
wire's B/symbol, pooled / dense KV and every rank's peak.

``--fsdp`` trains with the baseline step as ZeRO-3 instead
(``train(comm="baseline")`` under ``parallel.sharding.make_rules()``):
each rank holds its ``data x model`` block of the parameters and of the
f32 moments, gathers a layer group's blocks over the data column as it
runs and reduce-scatters their gradients. Per layout rank 0 prints
ms/step, the losses (every rank's the same, finite; against the first
layout's), the gathers and reduce-scatters a step, a rank's parameter
and moment GiB and every rank's peak.

Under ``--reference-rules`` the serving runs cut by FSDP too, as the
reference's decode rules do (unless the config serves TP only): each
rank draws its blocks, keeps its chunks of the model-block wire, and
the engines open a group's wire over the data column in every decode
step (the replica-alone check is not run there: a row alone would hold
every model block). Each layout's tokens are compared with the first
layout's.

``--ckpt`` checks one checkpoint for any layout (f32 parameters; use
``--layers`` to keep the whole tree to what the disk holds: phi3 at 8
layers is ~4.4 GB of parameters, ~13 GB with both moments, written
whole). The baseline step runs ``--steps`` steps on the ``N / M x M``
layout of the first ``--model`` M and checkpoints (every rank writes its
part of the one directory); each rank's state must be its cut of the
saved whole tree (read back through memory maps). Then the same launch
resumes on ``N x 1``, ``1 x N`` and ``N / M x M``: every rank's restored
state bit-equal to its cut of the saved tree, and one more step a finite
loss. The compressed step: ``--steps`` steps, a checkpoint (its ``m``
and ``v`` as ``[data, model, seg]``), a resumed launch of ``--steps``
more, bit-equal on every rank to ``2 x --steps`` straight steps; a
resume at ``1 x N`` must raise ``ValueError`` on every rank. Rank 0
prints each save's and restore's seconds by stage, the bytes written
and every rank's device and host peak (a JSON line per run).

Run from the root of a checkout on a machine with N cards:
  python3 tools/tp_cards.py --cards 4 --model 2 4
  python3 tools/tp_cards.py --arch deepseek-moe-16b --layers 8 --model 2 4
  python3 tools/tp_cards.py --arch deepseek-moe-16b --layers 8 --model 2 \
      --moe-impl shardmap_a2a
  python3 tools/tp_cards.py --arch xlstm-125m --seq-len 256 --model 2
  python3 tools/tp_cards.py --arch jamba-1.5-large-398b --model 4
  python3 tools/tp_cards.py --serve --arch deepseek-coder-33b --model 4
  python3 tools/tp_cards.py --serve --cards 2 --model 2
  python3 tools/tp_cards.py --serve --model 2
  python3 tools/tp_cards.py --serve --decode-seq-shard --model 1 \
      --arch chatglm3-6b --dtype float32 --batch 1 --requests 2 \
      --prompt-len 32640 --new-tokens 64 --kv-block 128 --prefill-chunk 256
  python3 tools/tp_cards.py --serve --reference-rules --model 4 \
      --arch chatglm3-6b --dtype float32 --batch 4 --prompt-len 32640 \
      --new-tokens 64 --kv-block 128 --prefill-chunk 256
  python3 tools/tp_cards.py --ckpt --layers 8 --model 2 --steps 2
  python3 tools/tp_cards.py --fsdp --model 1 2
  python3 tools/tp_cards.py --serve --reference-rules --model 4 2 \
      --arch deepseek-coder-33b
``--layers L`` cuts the depth. ``--device cpu`` runs the same on N gloo
ranks with a reduced config of the arch whose pools hold every chunk (a
rehearsal of the control flow, without the kernel timings; its times
are not a card's).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rank_main(rank, args, init):
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from repro_torch.configs import reduced
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.launch.mesh import (data_parallel, make_test_mesh,
                                         use_mesh)
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import pytree_leaves
    from repro_torch.parallel import sharding
    from repro_torch.training.train_step import _flatten_local

    cuda = args.device == "cuda"
    cfg = arch_config(args.arch, args.layers, args.moe_impl)
    if not cuda:
        cfg = arch_config(args.arch, moe_impl=args.moe_impl, cfg=reduced(
            cfg, dtype="float32", **({} if cfg.moe else {"d_model": 128})))
    # two runs of a step see the same gradients (the embedding's backward
    # scatter is atomic otherwise)
    torch.use_deterministic_algorithms(True, warn_only=True)
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    with data_parallel(args.device, rank=rank, world_size=args.cards,
                       init_method=init):
        dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
               else torch.device("cpu"))

        def say(msg):
            if rank == 0:
                print(msg, flush=True)

        kw = dict(steps=args.steps, seq_len=args.seq_len,
                  global_batch=args.global_batch, device=args.device,
                  transport="oneshot", seed=0)
        say(f"{cfg.name}: {cfg.num_layers} layers "
            f"({'/'.join(cfg.layer_kinds())}), d_model {cfg.d_model}, "
            f"{cfg.num_heads} / {cfg.num_kv_heads} heads x "
            f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}"
            + (f", {cfg.moe.num_experts} experts of {cfg.moe.d_expert} top-"
               f"{cfg.moe.top_k} ({cfg.moe.impl})" if cfg.moe else "")
            + f"; params {cfg.param_dtype}, compute {cfg.dtype}, remat "
            f"{cfg.remat}; batch {args.global_batch} x {args.seq_len}; "
            f"{args.cards} ranks ({args.device})")
        for model in args.model:
            mesh = make_test_mesh(model=model)
            tag = f"{mesh.data} x {mesh.model}"
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            registry = None
            if not cuda:
                # the reduced model's flat gradient is a few dozen chunks:
                # a pool slot for each, so the rehearsal runs the wire
                with use_mesh(mesh):
                    registry = _wide_pools(train(cfg, comm="qlc", **dict(
                        kw, steps=0))["registry"])
            with use_mesh(mesh):
                q = train(cfg, comm="qlc", registry=registry, **kw)
            peak = (torch.cuda.max_memory_allocated() / 2**30 if cuda
                    else float("nan"))
            hist = q["history"]
            losses = [h["loss"] for h in hist]
            if not all(h["ok"] for h in hist) or q["comm_fallbacks"]:
                raise AssertionError(f"{tag}: ok {[h['ok'] for h in hist]}, "
                                     f"fallbacks {q['comm_fallbacks']}")
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{tag}: losses {losses}")
            reg, step = q["registry"], q["step"]
            geom = step.geometry(q["params"])
            # the replicated leaves over the model row
            specs = pytree_leaves(sharding.param_pspecs(cfg, mesh))
            whole = [p.reshape(-1) for p, s in
                     zip(pytree_leaves(q["params"]), specs)
                     if sharding.model_dim(s) is None]
            rep = torch.cat(whole).contiguous()
            row = [torch.empty_like(rep) for _ in range(mesh.model)]
            dist.all_gather(row, rep, group=mesh.model_group)
            if not all(torch.equal(r.view(torch.int32),
                                   rep.view(torch.int32)) for r in row):
                raise AssertionError(f"{tag}: replicated leaves differ over "
                                     "the model row")
            say(f"[{tag}] {len(whole)} replicated leaves ({rep.numel()} "
                f"values) bit-identical over each model row after "
                f"{args.steps} steps")
            # this rank's flat gradient of the first batch, for K1 / K2
            batch = SyntheticDataset(DataConfig(
                vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                global_batch=args.global_batch)).batch_at(0)
            with use_mesh(mesh):
                _, grads = step.stage1(q["params"], batch)
            grad = _flatten_local(grads, geom.n_padded)
            del grads
            qlc_params = [p.detach().cpu() for p in
                          pytree_leaves(q["params"])]
            row_out = {
                "layout": tag, "rank": rank,
                "step_ms": [round(h["dt"] * 1e3, 3) for h in hist],
                "losses": losses,
                "calibrate_ms": q.get("calibrate_s", 0.0) * 1e3,
                "wire_bytes_per_symbol": {
                    "grads": q["grads_wire_bytes_per_symbol"],
                    "params": q["params_wire_bytes_per_symbol"]},
                "n_local": geom.n_local, "n_padded": geom.n_padded,
                "seg": geom.seg, "peak_gib": peak,
                "moe_wire": q.get("moe")}
            del q, step
            if cuda:
                torch.cuda.empty_cache()
                import chip_smoke
                from repro_torch.kernels import ops, ref
                flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
                fused = chip_smoke.train_path_fused(
                    ops, ref, reg["grads"], grad, flush, phase=tag)
                row_out["fused"] = {
                    k: {f: v[f] for f in ("shape", "max_abs_err", "ms",
                                          "kernel_ms", "bound_ms")}
                    for k, v in fused.items()}
                del flush
            del grad
            if cuda:
                torch.cuda.empty_cache()
            with use_mesh(mesh):
                t = train(cfg, comm="qlc", registry=reg, wire_enabled=False,
                          **kw)
            if [h["loss"] for h in t["history"]] != losses:
                raise AssertionError(f"{tag}: twin losses differ")
            if not all(torch.equal(a.cpu(), b) for a, b in zip(
                    pytree_leaves(t["params"]), qlc_params)):
                raise AssertionError(f"{tag}: parameters of the QLC run "
                                     "differ from its raw e4m3 twin's")
            row_out["twin_step_ms"] = [round(h["dt"] * 1e3, 3)
                                       for h in t["history"]]
            del t, qlc_params
            if cuda:
                torch.cuda.empty_cache()
            gathered = [None] * args.cards
            dist.all_gather_object(gathered, row_out)
            r0 = gathered[0]
            say(f"[{tag}] {args.steps} compressed steps "
                f"{r0['step_ms']} ms, losses {losses}, all ok, no fallback; "
                f"wire {r0['wire_bytes_per_symbol']['grads']:.4f} B/symbol "
                f"(grads), {r0['wire_bytes_per_symbol']['params']:.4f} "
                f"(params); flat vector {r0['n_local']} of {r0['n_padded']} "
                f"a model rank, segment {r0['seg']}; peak "
                + ", ".join(f"{g['peak_gib']:.2f}" for g in gathered)
                + " GiB by rank; the raw e4m3 twin bit-equal on every rank"
                + "".join(f"; {name} {w['wire_bytes_per_symbol']:.4f} "
                          f"B/symbol measured, "
                          f"{w['modeled_wire_bytes_per_symbol']:.4f} modeled"
                          for name, w in (r0["moe_wire"] or {}).items()))
            say(json.dumps({"layout": tag, "ranks": gathered}))
    if cuda and rank == 0:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)


def _fsdp_rank(rank, args, init):
    """``--fsdp``: the baseline step as ZeRO-3 (``launch.train.train(comm=
    "baseline")`` under ``parallel.sharding.make_rules()``) on the
    ``cards / M x M`` layout of each ``--model`` size M; see the module
    docstring."""
    import time
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from repro_torch.configs import reduced
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import pytree_leaves
    from repro_torch.parallel.sharding import make_rules, use_rules

    cuda = args.device == "cuda"
    cfg = arch_config(args.arch, args.layers, args.moe_impl)
    if not cuda:
        cfg = arch_config(args.arch, moe_impl=args.moe_impl, cfg=reduced(
            cfg, dtype="float32", **({} if cfg.moe else {"d_model": 128})))
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    with tmesh.data_parallel(args.device, rank=rank, world_size=args.cards,
                             init_method=init):
        def say(msg):
            if rank == 0:
                print(msg, flush=True)

        say(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; params "
            f"{cfg.param_dtype}, compute {cfg.dtype}, remat {cfg.remat}; "
            f"batch {args.global_batch} x {args.seq_len}; the baseline step "
            f"under make_rules() (FSDP); {args.cards} ranks ({args.device})")
        first = None
        for model in args.model:
            mesh = tmesh.make_test_mesh(model=model)
            tag = f"{mesh.data} x {mesh.model}"
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            tmesh.reset_fsdp_counts()
            t0 = time.perf_counter()
            with tmesh.use_mesh(mesh), use_rules(make_rules()):
                res = train(cfg, comm="baseline", steps=args.steps,
                            seq_len=args.seq_len,
                            global_batch=args.global_batch,
                            device=args.device, seed=0)
            wall = time.perf_counter() - t0
            counts = dict(tmesh.FSDP_COUNTS)
            hist = res["history"]
            losses = [h["loss"] for h in hist]
            local = sum(p.numel() * p.element_size()
                        for p in pytree_leaves(res["params"]))
            state = sum(t.numel() * t.element_size() for k in ("m", "v")
                        for t in pytree_leaves(res["opt_state"][k]))
            del res
            row_out = {
                "layout": tag, "rank": rank,
                "step_ms": [round(h["dt"] * 1e3, 3) for h in hist],
                "losses": losses, "wall_s": wall,
                "gathers_a_step": counts["gathers"] / args.steps,
                "reduce_scatters_a_step":
                    counts["reduce_scatters"] / args.steps,
                "local_param_gib": local / 2**30,
                "local_moments_gib": state / 2**30,
                "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                             if cuda else float("nan"))}
            gathered = [None] * args.cards
            dist.all_gather_object(gathered, row_out)
            failed = []
            if not all(math.isfinite(v) for g in gathered
                       for v in g["losses"]):
                failed.append("a loss is not finite")
            if any(g["losses"] != gathered[0]["losses"] for g in gathered):
                failed.append("the ranks' losses differ")
            if not all(g["reduce_scatters_a_step"] > 0 for g in gathered):
                failed.append("no reduce-scatter: the step did not run "
                              "FSDP")
            if first is None:
                first = losses
            agree = max(abs(a - b) / max(abs(b), 1e-12)
                        for a, b in zip(losses, first))
            r0 = gathered[0]
            say(f"[{tag}] {args.steps} FSDP baseline steps {r0['step_ms']} "
                f"ms, losses {losses} (largest relative difference from "
                f"the first layout's {agree:.3e}); {r0['gathers_a_step']:.0f}"
                f" gathers and {r0['reduce_scatters_a_step']:.0f} "
                f"reduce-scatters a step; a rank's parameters "
                f"{r0['local_param_gib']:.2f} GiB, moments "
                f"{r0['local_moments_gib']:.2f} GiB; peak "
                + ", ".join(f"{g['peak_gib']:.2f}" for g in gathered)
                + " GiB by rank"
                + "".join(f"; FAILED: {f}" for f in failed))
            say(json.dumps({"layout": tag, "ranks": gathered,
                            "rel_loss_diff_first_layout": agree}))
            if failed:
                raise AssertionError(f"{tag}: " + "; ".join(failed))
    if cuda and rank == 0:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)


def _tree_of(flat):
    """``{"a/b": leaf}`` -> ``{"a": {"b": leaf}}``."""
    out = {}
    for key, leaf in flat.items():
        node = out
        *parts, last = key.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def _same_as_files(params, opt, cdir, cfg, mesh, compressed):
    """Whether this rank's ``(params, opt)`` is, bit for bit, its cut of
    the whole tree in checkpoint directory ``cdir``: its
    ``convert.shard_params`` blocks (and the baseline moments'), or its
    ``[d, m]`` row of the stored ``m`` and ``v``. The whole leaves are
    read through memory maps, so a rank reads only its blocks."""
    import numpy as np
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.convert import shard_params
    with open(os.path.join(cdir, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    whole = {key: np.load(os.path.join(cdir, meta["file"]), mmap_mode="r")
             for key, meta in leaves.items()}
    d, m = mesh.coords
    trees = {"0": params} if compressed else {"0": params, "1/m": opt["m"],
                                              "1/v": opt["v"]}
    for prefix, tree in trees.items():
        saved = _tree_of({k[len(prefix) + 1:]: v for k, v in whole.items()
                          if k.startswith(prefix + "/")})
        want = flatten_with_paths(shard_params(saved, cfg, m, mesh.model))
        for key, t in flatten_with_paths(tree).items():
            if t.detach().cpu().numpy().tobytes() != \
                    np.ascontiguousarray(want[key]).tobytes():
                return False
    rows = {"1/m": opt["m"], "1/v": opt["v"]} if compressed else {}
    for key, t in rows.items():
        if t.detach().cpu().numpy().tobytes() != \
                np.ascontiguousarray(whole[key][d, m]).tobytes():
            return False
    return int(opt["step"]) == int(whole["1/step"])


class _HostPeak:
    """The peak of this process's resident memory not shared with files
    (resident minus shared pages of ``/proc/self/statm``; where the
    kernel reports no shared pages, all of it) and of its shared
    (file-mapped) pages, GiB, sampled every 5 ms while the block runs,
    and the first level at its start."""

    def __enter__(self):
        import threading
        self.start = self._read()[0]
        self.anon, self.file = self.start, 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def _sample(self):
        while not self._stop.wait(0.005):
            anon, file = self._read()
            self.anon, self.file = max(self.anon, anon), max(self.file, file)

    @staticmethod
    def _read():
        with open("/proc/self/statm") as f:
            resident, shared = map(int, f.read().split()[1:3])
        page = os.sysconf("SC_PAGE_SIZE") / 2**30
        return (resident - shared) * page, shared * page


def _ckpt_rank(rank, args, init):
    """``--ckpt``: one checkpoint for any layout; see the module
    docstring."""
    import math
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from repro_torch.configs import reduced
    from repro_torch.launch.mesh import (data_parallel, make_test_mesh,
                                         mesh_all, use_mesh)
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import pytree_leaves
    from repro_torch.parallel.sharding import param_shapes
    from repro_torch.training import OptConfig, TrainConfig
    from repro_torch.training import make_baseline_step

    cuda = args.device == "cuda"
    cfg = arch_config(args.arch, args.layers)
    if not cuda:
        cfg = reduced(cfg, dtype="float32", d_model=128)
    torch.use_deterministic_algorithms(True, warn_only=True)
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    with data_parallel(args.device, rank=rank, world_size=args.cards,
                       init_method=init):
        def say(msg):
            if rank == 0:
                print(msg, flush=True)

        save_model = args.model[0]
        meshes = {}
        for model in dict.fromkeys((save_model, 1, args.cards)):
            mesh = make_test_mesh(model=model)
            meshes[f"{mesh.data}x{mesh.model}"] = mesh
        saved_at = f"{args.cards // save_model}x{save_model}"
        resumes = [t for t in meshes if t != saved_at] + [saved_at]
        refuse_at = f"1x{args.cards}"
        whole_bytes = sum(4 * math.prod(s) for s in
                          pytree_leaves(param_shapes(cfg)))
        box = [tempfile.mkdtemp(prefix="qlc_ckpt_cards_")
               if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        root = box[0]
        free = shutil.disk_usage(root).free
        need = int(2.2 * 3 * whole_bytes)
        say(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}; "
            f"{whole_bytes} bytes of f32 parameters (x3 with the AdamW "
            f"moments); {args.cards} ranks ({args.device}); checkpoints in "
            f"{root}, {free} bytes free (need ~{need})")
        if free < need:
            raise SystemExit(f"{root}: {free} bytes free, need {need}")
        kw = dict(seq_len=args.seq_len, global_batch=args.global_batch,
                  device=args.device, transport="oneshot", seed=0)
        steps = args.steps

        def device_peak():
            return (torch.cuda.max_memory_allocated() / 2**30 if cuda
                    else float("nan"))

        def stats(tag, res, host, peak, cdir=None):
            """Rank 0 prints the run's stage seconds, bytes written and
            every rank's device peak (``peak``, GiB) and host peaks
            (``host``: the run's ``_HostPeak``), and a JSON line of every
            rank's."""
            row = {"run": tag, "rank": rank, "seconds": res["checkpoint"],
                   "peak_gib": peak,
                   "host_anon_start_gib": host.start,
                   "host_anon_peak_gib": host.anon,
                   "host_file_peak_gib": host.file}
            if cdir is not None and rank == 0:
                row["bytes"] = sum(os.path.getsize(os.path.join(cdir, n))
                                   for n in os.listdir(cdir))
            every = [None] * args.cards
            dist.all_gather_object(every, row)
            r0 = every[0]
            for what, t in r0["seconds"].items():
                say(f"[{tag}] {what}: " + ", ".join(
                    f"{k} {v:.3f} s" for k, v in t.items()))
            say(f"[{tag}] " + (f"{r0['bytes']} bytes written; "
                               if "bytes" in r0 else "")
                + "device peak " + ", ".join(
                    f"{g['peak_gib']:.2f}" for g in every)
                + " GiB; host resident peak (from) " + ", ".join(
                    f"{g['host_anon_peak_gib']:.2f} "
                    f"({g['host_anon_start_gib']:.2f})" for g in every)
                + " GiB, of it shared with files " + ", ".join(
                    f"{g['host_file_peak_gib']:.2f}" for g in every)
                + " GiB by rank")
            say(json.dumps({"ckpt": tag, "ranks": every}))

        def reset():
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()

        def require(ok, what):
            if not mesh_all(bool(ok), meshes[saved_at]):
                raise AssertionError(f"{what}: failed on some rank")
            say(f"  ok: {what}")

        # the baseline step: saved at the first --model, restored on every
        # layout, one more step from each
        base = os.path.join(root, "baseline")
        cdir = os.path.join(base, f"step_{steps:010d}")
        reset()
        with use_mesh(meshes[saved_at]), _HostPeak() as host:
            res = train(cfg, comm="baseline", steps=steps,
                        checkpoint_dir=base, checkpoint_every=steps, **kw)
        stats(f"baseline {saved_at}: {steps} steps, save", res, host,
              device_peak(), cdir)
        require(_same_as_files(res["params"], res["opt_state"], cdir, cfg,
                               meshes[saved_at], False),
                f"baseline {saved_at}: every rank's state is its cut of the "
                "saved whole tree")
        del res
        opt_cfg = OptConfig(lr=3e-4, total_steps=steps,
                            warmup_steps=max(10, steps // 20))
        for tag in resumes:
            mesh = meshes[tag]
            reset()
            with use_mesh(mesh):
                with _HostPeak() as host:
                    res = train(cfg, comm="baseline", steps=steps,
                                checkpoint_dir=base, **kw)
                peak = device_peak()
                require(res["start_step"] == steps and not res["history"],
                        f"baseline {tag}: resumed at step {steps}")
                require(_same_as_files(res["params"], res["opt_state"],
                                       cdir, cfg, mesh, False),
                        f"baseline {tag}: every rank's restored state is its "
                        "cut of the saved whole tree, bit for bit")
                step_fn = make_baseline_step(cfg, opt_cfg, TrainConfig(),
                                             mesh=mesh)
                _, _, met = step_fn(res["params"], res["opt_state"],
                                    res["data"].batch_at(steps))
                loss = float(met["loss"])
            require(math.isfinite(loss),
                    f"baseline {tag}: one more step, loss {loss:.4f}")
            stats(f"baseline {tag}: restore", res, host, peak)
            del res, step_fn, met
        dist.barrier()
        if rank == 0:
            shutil.rmtree(base)
        dist.barrier()

        # the compressed step: saved and resumed on its own layout, equal
        # to the straight run; refused on another
        comp = os.path.join(root, "compressed")
        reset()
        with use_mesh(meshes[saved_at]):
            # on the CPU a pool slot for every chunk, as the train mode
            reg = None if cuda else _wide_pools(train(
                cfg, comm="qlc", **dict(kw, steps=0))["registry"])
            straight = train(cfg, comm="qlc", steps=2 * steps, registry=reg,
                             **kw)
        reg = straight["registry"]
        want = ([p.cpu() for p in pytree_leaves(straight["params"])],
                [straight["opt_state"][k].cpu() for k in ("m", "v")])
        del straight
        reset()
        with use_mesh(meshes[saved_at]), _HostPeak() as host:
            res = train(cfg, comm="qlc", steps=steps, registry=reg,
                        checkpoint_dir=comp, checkpoint_every=steps, **kw)
        stats(f"compressed {saved_at}: {steps} steps, save", res, host,
              device_peak(), os.path.join(comp, f"step_{steps:010d}"))
        require(_same_as_files(res["params"], res["opt_state"], os.path.join(
            comp, f"step_{steps:010d}"), cfg, meshes[saved_at], True),
            f"compressed {saved_at}: every rank's blocks and [seg] row are "
            "its cut of the saved tree and [data, model, seg] state")
        del res
        reset()
        with use_mesh(meshes[saved_at]), _HostPeak() as host:
            res = train(cfg, comm="qlc", steps=2 * steps, registry=reg,
                        checkpoint_dir=comp, checkpoint_every=2 * steps, **kw)
        stats(f"compressed {saved_at}: restore, {steps} more steps, save",
              res, host, device_peak(),
              os.path.join(comp, f"step_{2 * steps:010d}"))
        got = ([p.cpu() for p in pytree_leaves(res["params"])],
               [res["opt_state"][k].cpu() for k in ("m", "v")])
        require(res["start_step"] == steps and all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(got[0] + got[1], want[0] + want[1])),
            f"compressed {saved_at}: {steps} steps + save + resume + {steps} "
            f"steps == {2 * steps} straight, bit for bit (parameters, m, v)")
        del res, got, want
        reset()
        with use_mesh(meshes[refuse_at]):
            try:
                train(cfg, comm="qlc", steps=2 * steps, registry=reg,
                      checkpoint_dir=comp, **kw)
                refused = None
            except ValueError as e:
                refused = str(e)
        every = [None] * args.cards
        dist.all_gather_object(every, refused)
        if not all(every):
            raise AssertionError(f"compressed at {refuse_at}: not refused "
                                 f"on every rank: {every}")
        say(f"  ok: compressed at {refuse_at}: ValueError on every rank "
            f"({every[0]})")
        dist.barrier()
        if rank == 0:
            shutil.rmtree(root)
    if cuda and rank == 0:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)


def _serve_rank(rank, args, init):
    """``--serve``: the arch served on the ``cards / M x M`` layout of each
    ``--model`` size M; see the module docstring."""
    import hashlib
    import time
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from repro_torch.comm.blockpool import BlockPool
    from repro_torch.configs import reduced
    from repro_torch.launch.mesh import (data_parallel, kv_seq_shard,
                                         make_test_mesh, row_mesh, use_mesh)
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step
    from repro_torch.models.transformer import tree_map
    from repro_torch.parallel.sharding import (decode_rules, fsdp_params,
                                               get_rules, make_rules,
                                               use_rules)
    from repro_torch.serving import (Engine, GenerationRequest, KVCacheSpec,
                                     engine as engine_mod, scheduler)
    from repro_torch.serving.scheduler import replica_requests

    cuda = args.device == "cuda"
    cfg = arch_config(args.arch, args.layers, args.moe_impl)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    if not cuda:
        # leaves wide enough for the weight wire
        cfg = arch_config(args.arch, moe_impl=args.moe_impl, cfg=reduced(
            cfg, dtype="float32", d_model=256, head_dim=32,
            **({} if cfg.moe else {"d_ff": 512})))
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    #: the current run's logits: hashed on this rank, and kept on rank 0
    #: where the run is held against the one-rank engine
    logits = {"hash": hashlib.sha256(), "keep": None}
    inner = scheduler.decode_step

    def logged_step(*a, **kw):
        lg, st = inner(*a, **kw)
        last = lg[:, -1].float().cpu()
        logits["hash"].update(last.numpy().tobytes())
        if logits["keep"] is not None:
            logits["keep"].append(last)
        return lg, st
    scheduler.decode_step = engine_mod.decode_step = logged_step

    def fresh_logits(keep=False):
        logits["hash"] = hashlib.sha256()
        logits["keep"] = [] if keep else None

    with data_parallel(args.device, rank=rank, world_size=args.cards,
                       init_method=init):
        dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
               else torch.device("cpu"))

        def say(msg):
            if rank == 0:
                print(msg, flush=True)

        def sync():
            if cuda:
                torch.cuda.synchronize()

        n_params = sum(math.prod(v) for v in _leaf_shapes(cfg))
        pagings = ("sync", "async")
        say(f"{cfg.name}: {cfg.num_layers} layers "
            f"({'/'.join(cfg.layer_kinds())}), d_model {cfg.d_model}, "
            f"{cfg.num_heads} / {cfg.num_kv_heads} heads x "
            f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}"
            + (f", {cfg.moe.num_experts} experts of {cfg.moe.d_expert} top-"
               f"{cfg.moe.top_k} ({cfg.moe.impl})" if cfg.moe else "")
            + f"; {n_params} parameters ({cfg.param_dtype}), compute "
            f"{cfg.dtype}; batch {args.batch}, {args.requests} requests, "
            f"prompt {args.prompt_len}, {args.new_tokens} new tokens, "
            f"prefill {args.prefill_chunk} tokens a step, --wire qlc, "
            f"--kv-cache qlc --kv-block {args.kv_block} "
            f"({', '.join(pagings)}); {args.cards} ranks ({args.device})"
            + ("; make_rules(decode_seq_shard=True)"
               if args.decode_seq_shard else "")
            + ("; the reference's decode rules" if args.reference_rules
               else ""))
        first_tokens = None
        for model in args.model:
            mesh = make_test_mesh(model=model)
            data = mesh.data
            rules = (decode_rules(cfg, args.batch, mesh)
                     if args.reference_rules
                     else make_rules(decode_seq_shard=True)
                     if args.decode_seq_shard else get_rules())
            with use_rules(rules):
                shard = kv_seq_shard(mesh)
            # the sequence split, and the slots split over the column
            seq = shard is not None
            split = data > 1 and rules.spec(("batch",), mesh=mesh)[0] \
                == "data"
            # a run held against the one-rank engine on card 0: every
            # sequence split, and with --against-one-rank a model row
            # without one
            alone = not split and (seq or (model > 1
                                           and args.against_one_rank))
            tag = f"{data} x {model}" + (
                f" kv_seq over {'/'.join(shard.axes)}" if seq else "")
            # under FSDP the engines hold the rank's blocks and its chunks
            # of the wire, opened a group at a time in each decode step
            fsdp = fsdp_params(rules)
            # the replica-alone reference of a split (dense models): not
            # under FSDP, where a row alone would hold every model block
            sub = (row_mesh(mesh) if split and not seq and not fsdp
                   and cfg.moe is None else None)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            max_len = args.prompt_len + args.new_tokens + 8
            row_out = {"layout": tag, "rank": rank}
            runs, regs, toks, events, hashes = {}, {}, {}, {}, {}
            with use_mesh(mesh), use_rules(rules):
                fresh_logits(keep=alone and rank == 0)
                sync()
                t0 = time.perf_counter()
                res = serve(cfg, batch=args.batch, requests=args.requests,
                            prompt_len=args.prompt_len,
                            new_tokens=args.new_tokens, wire="qlc",
                            device=args.device, seed=0,
                            prefill_chunk=args.prefill_chunk)
                sync()
                row_out["serve_s"] = time.perf_counter() - t0
                kept = logits["keep"]
                hashes["dense"] = logits["hash"].hexdigest()[:16]
                opened, prompts = res["params"], res["prompts"]
                wc, wired = res["wire_codec"], res["wired"]
                served_wc = wc if fsdp else None
                wire_b = sym = 0
                for key, m in wc.meta.items():
                    node = wired
                    for part in key.split("/"):
                        node = node[part]
                    # a rank's chunks of a leaf cut over the column
                    wire_b += sum(t.numel() * t.element_size()
                                  for t in node.values()) * (
                        m.n_chunks / node["words"].shape[-2])
                    sym += m.n_symbols * node["words"].shape[0]
                row_out["wire_bytes_per_symbol"] = wire_b / max(1, sym)
                row_out["set_up_s"] = {k: res[k] for k in (
                    "calibrate_s", "compress_s", "open_s")}
                del wired, res["wired"]
                ids = [o.request_id for o in res["outs"]]
                toks["dense"] = [o.tokens.tolist() for o in res["outs"]]
                runs["dense"], events["dense"] = res["stats"], res["events"]
                regs["weights"] = wc.registry.to_json()
                del res
                kv = {p: dict(kv_paging=p, kv_spec=KVCacheSpec(
                    block_tokens=args.kv_block, exact_capacity=p == "sync",
                    axis="model")) for p in pagings}
                for paging in pagings:
                    fresh_logits()
                    eng = Engine(opened, cfg, max_seq_len=max_len,
                                 max_batch=args.batch, pool=BlockPool(1 << 34),
                                 mesh=mesh, prefill_chunk=args.prefill_chunk,
                                 weight_codec=served_wc, **kv[paging])
                    for rid, p in zip(ids, prompts):
                        eng.submit(GenerationRequest(
                            prompt=p, max_new_tokens=args.new_tokens,
                            request_id=rid))
                    eng.run()
                    hashes[paging] = logits["hash"].hexdigest()[:16]
                    toks[paging] = [eng.poll(r).tokens.tolist() for r in ids]
                    st = runs[paging] = eng.stats()
                    events[paging] = eng.events
                    # rank-local outcomes, checked once the mesh has
                    # gathered them: a rank that raised alone would leave
                    # the others in the next collective
                    row_out[f"{paging}_equal_dense"] = \
                        toks[paging] == toks["dense"]
                    row_out[f"{paging}_overflow"] = \
                        st["kv"]["overflow_sections"]
                    if paging == "async":
                        row_out["async_misses"] = st["prefetch"]["misses"]
                    regs[paging] = eng.registry.to_json()
                    states = tree_map(torch.zeros_like, eng._states)
                    row_out["positions"] = (eng.max_seq_len, eng._offset(),
                                            eng._states_len())
                    del eng
                row_out["steps"] = _step_counts(
                    decode_step, opened, cfg, states, args.batch
                    // (data if split else 1), dev, cuda, served_wc)
                del states
                if sub is not None:
                    row_out["replica"] = _replica_alone(
                        Engine, GenerationRequest, BlockPool, opened, cfg,
                        args, sub, mesh, dict(kv, dense={}), events, toks,
                        hashes, ids, prompts, max_len, replica_requests,
                        fresh_logits, logits)
            if alone:
                if fsdp:
                    with use_mesh(mesh), use_rules(rules):
                        opened = _column_whole(opened, served_wc, cfg, mesh)
                whole = (_row_whole(opened, cfg, mesh) if model > 1
                         else opened)
                row_out["one_rank"] = _seq_against_one_rank(
                    rank, Engine, GenerationRequest, whole, cfg, args, ids,
                    prompts, max_len, toks["dense"], kept, fresh_logits,
                    logits)
            kept = whole = None
            row_out["ms_per_token"] = {
                k: {"prefill": v["ms_per_token_prefill"],
                    "decode": v["ms_per_token_decode"]}
                for k, v in runs.items()}
            row_out["pooled_over_dense"] = {
                k: runs[k]["pool"]["peak_referenced_bytes"]
                / max(1, runs[k]["peak_dense_logical_bytes"])
                for k in pagings}
            row_out["registry_sha256"] = {
                k: hashlib.sha256(v.encode()).hexdigest()[:16]
                for k, v in regs.items()}
            row_out["logits_sha256"] = hashes
            row_out["tokens_sha256"] = hashlib.sha256(
                json.dumps(toks).encode()).hexdigest()[:16]
            row_out["events_sha256"] = hashlib.sha256(json.dumps(
                events).encode()).hexdigest()[:16]
            row_out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                                   if cuda else float("nan"))
            if first_tokens is None:
                first_tokens = toks["dense"]
            row_out["requests_equal_first_layout"] = sum(
                a == b for a, b in zip(toks["dense"], first_tokens))
            gathered = [None] * args.cards
            dist.all_gather_object(gathered, row_out)
            failed = [f"{key} differs over the mesh: "
                      f"{[g[key] for g in gathered]}"
                      for key in ("registry_sha256", "tokens_sha256",
                                  "events_sha256")
                      if any(g[key] != gathered[0][key] for g in gathered)]
            # a replica's logits are its own rows' (seq: every rank's)
            rows = [gathered[r:r + model] for r in range(0, args.cards, model)]
            if any(g["logits_sha256"] != r[0]["logits_sha256"]
                   for r in (rows if split else [gathered]) for g in r):
                failed.append("logits differ over a row: "
                              f"{[g['logits_sha256'] for g in gathered]}")
            failed += [f"{paging} paging is not token-identical to the "
                       "dense engine" for paging in pagings
                       if not all(g[f"{paging}_equal_dense"]
                                  for g in gathered)]
            overflow = [[g[f"{p}_overflow"] for p in pagings]
                        for g in gathered]
            if any(any(o) for o in overflow):
                failed.append("overflow fallbacks to raw containers "
                              f"({', '.join(pagings)}) by rank: {overflow}")
            if sub is not None:
                failed += [f"rank {g['rank']}: {f}" for g in gathered
                           for f in g["replica"]["failed"]]
            one = gathered[0].get("one_rank")
            if one is not None and one["failed"]:
                failed += one["failed"]
            r0 = gathered[0]
            say(f"[{tag}] tokens (sha256 {r0['tokens_sha256']}), events "
                f"({r0['events_sha256']}), registries "
                f"{r0['registry_sha256']}, logits of every step by rank "
                f"{[g['logits_sha256']['dense'] for g in gathered]} "
                "(dense); "
                + (f"async prefetch misses (blocks redone on the sync "
                   f"path) by rank {[g['async_misses'] for g in gathered]}; "
                   f"positions (max_seq_len, first, held) by rank "
                   f"{[g['positions'] for g in gathered]}; ")
                + ("; ".join(f"FAILED: {f}" for f in failed) if failed
                   else "the same on every rank, paged token-identical to "
                   "the dense engine, no overflow fallback"))
            if sub is not None:
                say(f"[{tag}] each replica against its row alone (1 x "
                    f"{model}, batch {args.batch // data}): " + "; ".join(
                        f"rank {g['rank']} {g['replica']['requests']}: "
                        f"{g['replica']['equal']}" for g in gathered))
            if one is not None:
                say(f"[{tag}] against the one-rank engine on card 0: {one}")
            say(f"[{tag}] ms/token prefill / decode: " + ", ".join(
                f"{k} {v['prefill']:.3f} / {v['decode']:.3f}"
                for k, v in r0["ms_per_token"].items())
                + "; a decode step (batch "
                f"{args.batch // (data if split else 1)}"
                f" a rank): {r0['steps']['launches']} kernel launches, "
                f"{r0['steps']['all_reduces']} all-reduces and "
                f"{r0['steps']['all_gathers']} all-gathers, "
                f"{r0['steps']['wall_ms']:.3f} ms; wire "
                f"{r0['wire_bytes_per_symbol']:.4f} B/symbol; pooled / "
                "dense KV " + ", ".join(
                    f"{k} {v:.4f}" for k, v in
                    r0["pooled_over_dense"].items())
                + "; peak " + ", ".join(f"{g['peak_gib']:.2f}"
                                        for g in gathered) + " GiB by rank"
                + (f"; FSDP (the wire's chunks over the column), "
                   f"{r0['steps']['fsdp_gathers']} gathers a decode step"
                   if fsdp else "")
                + f"; requests equal to the first layout's "
                f"{r0['requests_equal_first_layout']} of {len(ids)}")
            if args.arch.startswith("phi3") and data == 1:
                agree = _against_one_card(rank, cfg, args, toks["dense"],
                                          prompts, dev, cuda)
                if rank == 0:
                    say(f"[{tag}] against the 1 x 1 run on card 0 (reported, "
                        f"not gated): {agree}")
                    row_out["one_card"] = agree
                dist.barrier()
            say(json.dumps({"layout": tag, "ranks": gathered,
                            "one_card": row_out.get("one_card")}))
            if failed:
                raise AssertionError(f"{tag}: " + "; ".join(failed))
            del opened
            if cuda:
                torch.cuda.empty_cache()
    if cuda and rank == 0:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)


def _replica_alone(Engine, GenerationRequest, BlockPool, opened, cfg, args,
                   sub, mesh, kinds, events, toks, hashes, ids, prompts,
                   max_len, replica_requests, fresh_logits, logits):
    """This rank's row serving its replica's requests alone, for each
    run: a ``1 x M`` engine at ``batch / data`` fed, in order, the
    requests the split schedule put on the replica -> {"requests", "equal":
    per run whether its tokens and every step's logits equal the split
    run's, "failed"}."""
    d = mesh.coords[0]
    by_id = dict(zip(ids, prompts))
    out = {"equal": {}, "failed": []}
    for kind, kw in kinds.items():
        mine = replica_requests(events[kind], args.batch, mesh.data)[d]
        fresh_logits()
        extra = {} if kind == "dense" else dict(pool=BlockPool(1 << 34))
        eng = Engine(opened, cfg, max_seq_len=max_len,
                     max_batch=args.batch // mesh.data, mesh=sub,
                     prefill_chunk=args.prefill_chunk, **kw, **extra)
        for rid in mine:
            eng.submit(GenerationRequest(prompt=by_id[rid],
                                         max_new_tokens=args.new_tokens,
                                         request_id=rid))
        eng.run()
        same_t = all(eng.poll(rid).tokens.tolist() == toks[kind][ids.index(
            rid)] for rid in mine)
        same_l = logits["hash"].hexdigest()[:16] == hashes[kind]
        out["equal"][kind] = {"tokens": same_t, "logits": same_l}
        out["requests"] = mine
        if not (same_t and same_l):
            out["failed"].append(f"replica {d}'s {kind} run differs from "
                                 "its row alone")
        del eng
    return out


def _row_whole(tree, cfg, mesh, prefix=""):
    """The whole parameter tree from the model row's local trees (``tree``
    this rank's): each split leaf all-gathered over the row and joined
    along the dim it is split on. Every rank of the row calls this."""
    import torch
    import torch.distributed as dist
    from repro_torch.convert import leaf_model_dims
    dims = leaf_model_dims(cfg, mesh.model)
    out = {}
    for key, leaf in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(leaf, dict):
            out[key] = _row_whole(leaf, cfg, mesh, path)
        elif dims.get(path) is None:
            out[key] = leaf
        else:
            parts = [torch.empty_like(leaf) for _ in range(mesh.model)]
            dist.all_gather(parts, leaf.contiguous(), group=mesh.model_group)
            out[key] = torch.cat(parts, dim=dims[path])
    return out


def _column_whole(tree, weight_codec, cfg, mesh):
    """This rank's model blocks from its FSDP blocks and its chunks of the
    wire: the wire opened over the data column, every other FSDP leaf
    gathered over it. Every rank of the column calls this, under the
    rules of the run."""
    from repro_torch.convert import leaf_data_dims
    from repro_torch.launch.mesh import fsdp_column, gather_blocks
    from repro_torch.serving import open_params
    col = fsdp_column(mesh)
    dims = leaf_data_dims(cfg, mesh.data, mesh.model)
    groups = open_params(tree["groups"], weight_codec, column=col)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        dim = dims.get(path)
        return node if dim is None else gather_blocks(node, dim, col)
    out = walk({k: v for k, v in tree.items() if k != "groups"}, "")
    gd = {k[len("groups/"):]: v for k, v in dims.items()
          if k.startswith("groups/")}

    def walk_groups(node, path):
        if isinstance(node, dict):
            return {k: walk_groups(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        wired = path in weight_codec.meta
        dim = gd.get(path)
        return node if wired or dim is None else gather_blocks(node, dim,
                                                               col)
    out["groups"] = walk_groups(groups, "")
    return out


def _seq_against_one_rank(rank, Engine, GenerationRequest, opened, cfg,
                          args, ids, prompts, max_len, tokens, kept,
                          fresh_logits, logits):
    """Rank 0 serves the same requests with no mesh on its card alone:
    its tokens must equal the dense run's over the mesh (a sequence
    split, or a model row) and every step's logits agree to rtol 1e-5 /
    atol 1e-5 (the partial softmax, and the row's ``wo`` sums, add the
    terms in another order) -> {"tokens_equal", "steps",
    "max_abs_err", "failed"}, None on the other ranks (which wait)."""
    import torch
    import torch.distributed as dist
    out = None
    if rank == 0:
        fresh_logits(keep=True)
        eng = Engine(opened, cfg, max_seq_len=max_len, max_batch=args.batch,
                     prefill_chunk=args.prefill_chunk)
        for rid, p in zip(ids, prompts):
            eng.submit(GenerationRequest(prompt=p,
                                         max_new_tokens=args.new_tokens,
                                         request_id=rid))
        eng.run()
        mine = [eng.poll(r).tokens.tolist() for r in ids]
        theirs = logits["keep"]
        fresh_logits()
        err = max(float((a - b).abs().max()) for a, b in zip(kept, theirs))
        close = len(kept) == len(theirs) and all(
            torch.allclose(a, b, rtol=1e-5, atol=1e-5)
            for a, b in zip(kept, theirs))
        out = {"tokens_equal": mine == tokens, "steps": len(theirs),
               "max_abs_err": err, "failed": []}
        if mine != tokens:
            out["failed"].append("the run's tokens differ from the "
                                 "one-rank engine's")
        if not close:
            out["failed"].append("a step's logits leave rtol 1e-5 / atol "
                                 "1e-5 of the one-rank engine's")
        del eng
    dist.barrier()
    return out


def _leaf_shapes(cfg):
    from repro_torch.convert import whole_leaf_shapes
    return list(whole_leaf_shapes(cfg).values())


def _step_counts(decode_step, params, cfg, states, batch, dev, cuda,
                 weight_codec=None):
    """One decode step at ``batch`` over the row (the mesh in scope): its
    wall time, the CUDA kernels it launched (``torch.profiler``; none
    counted on the CPU), the model row's all-reduces and all-gathers it
    made and the FSDP gathers (``launch.mesh.FSDP_COUNTS``, the dense
    leaves' gathers over the column; a wire's hops are among the
    all-gathers or its ring's sends)."""
    import functools
    import time
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    decode_step = functools.partial(decode_step, weight_codec=weight_codec)
    tok = torch.arange(1, batch + 1, dtype=torch.int32, device=dev)[:, None]
    pos = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    decode_step(params, cfg, tok, states, pos)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    tmesh.reset_fsdp_counts()
    decode_step(params, cfg, tok, states, pos)
    if cuda:
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    gathers = tmesh.FSDP_COUNTS["gathers"]
    counts = {"all_reduces": 0, "all_gathers": 0}
    real = {"all_reduce": dist.all_reduce, "all_gather": dist.all_gather}

    def counted(name, fn):
        def call(*a, **kw):
            counts[name + "s"] += 1
            return fn(*a, **kw)
        return call
    for name, fn in real.items():
        setattr(dist, name, counted(name, fn))
    try:
        if cuda:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                decode_step(params, cfg, tok, states, pos)
                torch.cuda.synchronize()
            launches = sum(e.count for e in prof.key_averages()
                           if getattr(e, "device_type", None)
                           == DeviceType.CUDA)
        else:
            decode_step(params, cfg, tok, states, pos)
            launches = 0
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
    return dict(counts, launches=launches, wall_ms=wall,
                fsdp_gathers=gathers)


def _against_one_card(rank, cfg, args, row_tokens, prompts, dev, cuda):
    """Rank 0 serves the whole model from the same seed with no mesh, on
    its card alone, and compares its tokens with the row's: requests
    whose tokens agree, and the first divergent one's step and the
    one-card model's top-1 margin there (teacher-forced)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_decode_states
    from repro_torch.serving import prefill
    if rank != 0:
        return None
    res = serve(cfg, batch=args.batch, requests=args.requests,
                prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                wire="qlc", device=args.device, seed=0)
    one = [o.tokens.tolist() for o in res["outs"]]
    same = sum(a == b for a, b in zip(one, row_tokens))
    out = {"requests_equal": same, "requests": len(one)}
    for i, (a, b) in enumerate(zip(one, row_tokens)):
        if a == b:
            continue
        t = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = np.concatenate([prompts[i], np.asarray(a[:t], np.int64)])
        with torch.no_grad():
            lg, _ = prefill(res["params"], cfg,
                            torch.from_numpy(seq[None]).to(dev),
                            init_decode_states(cfg, 1, len(seq) + 1, dev))
        top = torch.topk(lg[0].float(), 2).values
        out.update(first_request=i, first_step=t,
                   one_card_margin=float(top[0] - top[1]))
        break
    del res
    if cuda:
        torch.cuda.empty_cache()
    return out


def arch_config(arch: str, layers=None, moe_impl=None, cfg=None):
    """The full-width config this tool trains: ``arch`` at ``layers``
    layers (default: all), its MoE dispatch ``moe_impl`` (default: the
    config's); jamba as one mamba layer with its dense FFN. ``cfg``: a
    reduced one to set the dispatch of instead."""
    from repro_torch.configs import get_config
    if cfg is None:
        cfg = get_config(arch)
        if arch.startswith("jamba"):
            cfg = dataclasses.replace(cfg, attn_every=None, num_layers=1)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if moe_impl and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl=moe_impl))
    return cfg


def _wide_pools(calibrated):
    from repro_torch.core import CodecRegistry
    reg = CodecRegistry()
    for name in calibrated.names():
        e = calibrated[name]
        reg.register_tables(name, e.tables, dataclasses.replace(
            e.plan, pool_slots_per_1k=1024), counts=e.counts)
    return reg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--moe-impl", default=None,
                    choices=["gspmd", "grouped_local", "shardmap_a2a"],
                    help="an MoE's dispatch (default: the config's); "
                         "shardmap_a2a puts the expert wire on QLC")
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--model", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: all layers)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt", action="store_true",
                    help="one checkpoint for any layout: save at the first "
                         "--model, restore on N x 1, 1 x N and it")
    ap.add_argument("--fsdp", action="store_true",
                    help="the baseline step as ZeRO-3 (make_rules(): "
                         "parameters and moments cut over the data column "
                         "as well) on the N / M x M layout of each --model "
                         "M, instead of the compressed step")
    ap.add_argument("--serve", action="store_true",
                    help="serve the arch on the N / M x M layout of each "
                         "--model M instead of training it")
    ap.add_argument("--decode-seq-shard", action="store_true",
                    help="--serve under make_rules(decode_seq_shard=True): "
                         "the KV caches' sequence over the data column")
    ap.add_argument("--reference-rules", action="store_true",
                    help="--serve under the reference's decode rules for "
                         "the arch, --batch and the mesh: the KV caches' "
                         "sequence over the model row where the KV heads "
                         "do not divide it, over the whole mesh at batch 1")
    ap.add_argument("--against-one-rank", action="store_true",
                    help="--serve: hold a model row without a sequence "
                         "split against the one-rank engine on card 0, "
                         "as a split is held")
    ap.add_argument("--prefill-chunk", type=int, default=1,
                    help="--serve: prompt tokens a prefill step "
                         "(attention-only stacks)")
    ap.add_argument("--dtype", default=None,
                    help="--serve: the compute dtype (default: the "
                         "config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--kv-block", type=int, default=16)
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
    mp.start_processes(_ckpt_rank if args.ckpt else
                       _serve_rank if args.serve else
                       _fsdp_rank if args.fsdp else _rank_main,
                       args=(args, init), nprocs=args.cards,
                       start_method="spawn")


if __name__ == "__main__":
    main()
