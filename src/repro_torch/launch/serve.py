"""Serving launcher: continuous-batching engine, optionally from
QLC-compressed weights and with a compressed paged KV cache.

``--wire qlc`` calibrates a codec from the parameters' e4m3 symbol
histogram (K1's histogram output), compresses every large layer-stack
leaf to block-32 e4m3 + QLC words (K1), opens them again through the
fused decode (K2) and serves the opened parameters through ``Engine``.
Weights are random, from ``--seed``.

``--kv-cache qlc`` pages every resident sequence's KV cache, a block of
``--kv-block`` tokens at a time, through ONE shared compressed
``BlockPool``: per-layer codecs calibrated from the first prefill, blocks
encoded to QLC containers (K3) and decoded from the pooled bytes on
access — ``--kv-paging sync`` through K4 at the step that completes a
block, ``--kv-paging async`` (qlc only) from a device arena through K5 on
a side stream behind the next decode window. Lossless, so the launcher
checks it against a dense cache: for a dense model, request 0's tokens
against a dense run of it alone (at the same batch width, so that every
matmul has the shapes of the paged run); for an MoE model, whose expert
capacity the batch's rows share, every request's tokens against a dense
run of the same requests in the same submit order at the same batch.
``--kv-cache e4m3`` quantizes blocks on eviction (lossy).

The random-init tree the launcher makes is freed once the wire holds
it, before the wire is opened, so the peak is the wire plus one
parameter tree rather than two.

Under a mesh in scope (``launch.mesh.use_mesh``) every rank of its model
row serves its local tree, as ``launch.train.train`` trains it: drawn a
leaf at a time (``convert.init_local_params``), the weight codec
calibrated on the whole model's histogram summed over the row
(``comm.calibrate.histogram_of_local_tree``: the same registry on every
rank), the wire holding the rank's blocks, and ``Engine(mesh=)``, whose
paged cache binds the row (``KVCacheSpec(axis="model")``). Over a data
column the engine splits the slots, or, under
``make_rules(decode_seq_shard=True)`` in scope, the KV caches' sequence
(``serving.scheduler``); ``serve(..., reference_rules=True)`` takes the
reference's decode rules for the model, the batch and the mesh instead
(``parallel.sharding.decode_rules``: the sequence over the model row
where the KV heads do not divide it, over the whole mesh at a batch of
1). The dense-cache check runs on the same mesh, under the same rules.
Under rules that cut parameters by FSDP (the reference's decode rules
do, unless ``serve_params_tp_only``) each rank draws its ``data x
model`` blocks, and with ``--wire qlc`` keeps the layer stack on the
wire: each compressed leaf's model-block wire cut by chunks over the
data column, opened a group at a time inside every decode step
(``Engine(weight_codec=)``), K2 decoding each hop.
``tools/tp_cards.py --serve`` drives it on N cards. ``--prefill-chunk``
feeds a long prompt that many tokens a step (attention-only stacks).

Example (one H100):
  python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
      --batch 4 --requests 6 --prompt-len 32 --new-tokens 32 --wire qlc \\
      --kv-cache qlc --kv-block 16 --kv-paging async
On the CPU, with the plain versions of the kernels:
  python -m repro_torch.launch.serve --arch phi3-mini-3.8b --reduced \\
      --device cpu --wire qlc --kv-cache qlc --kv-block 4 --kv-paging sync
  python -m repro_torch.launch.serve --arch deepseek-moe-16b --reduced \\
      --device cpu --wire qlc --kv-cache qlc --kv-block 4
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import (init_local_params, leaf_data_dims,
                                 whole_leaf_shapes)
from repro_torch.core import CodecRegistry
from repro_torch.launch.mesh import current_mesh, fsdp_column, model_row
from repro_torch.models import init_params
from repro_torch.models.transformer import resolve_device
from repro_torch.parallel.sharding import decode_rules, get_rules, use_rules
from repro_torch.serving import (BlockPool, Engine, GenerationRequest,
                                 KVCacheSpec)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, *, batch: int = 4, requests: Optional[int] = None,
          prompt_len: int = 16, new_tokens: int = 32, wire: str = "none",
          kv_cache: str = "none", kv_block: int = 128,
          kv_paging: str = "sync", device="cuda", seed: int = 0,
          params=None, kv_monitor: bool = False,
          prefill_chunk: int = 1,
          reference_rules: bool = False) -> Dict[str, Any]:
    """Run the launcher's path and return what it produced: the request
    statuses, engine stats and events, the served params, the KV codecs'
    registry (``kv_registry``, None without a paged cache), with
    ``wire="qlc"`` the
    wire, its codec and the calibrate/compress/open seconds, and with
    ``kv_cache="qlc"`` the dense-cache check's tokens, which must equal
    the paged run's or this raises: ``solo_tokens`` (request 0 alone)
    for a dense model, ``dense_tokens`` (every request, the same batch)
    for an MoE model. ``kv_monitor`` attaches a ``TrafficMonitor`` to the
    paged cache (``kv_monitor`` in the result: each KV codec's measured
    traffic). A tree made here (``params=None``) is freed before the
    wire is opened. Under a mesh in scope, ``params`` (or the tree made
    here) is this rank's local tree (module docstring).
    ``prefill_chunk``: tokens a prefill step (``Engine``).
    ``reference_rules``: the engines run under the reference's decode
    rules for ``cfg`` at a batch of ``batch`` on the mesh in scope
    (``parallel.sharding.decode_rules``), in place of the rules in
    scope."""
    if kv_paging == "async" and kv_cache != "qlc":
        raise ValueError("kv_paging='async' needs kv_cache='qlc'")
    dev = resolve_device(device)
    n_req = requests or batch + 2
    mesh = current_mesh()
    rules = (decode_rules(cfg, batch, mesh)
             if reference_rules and mesh is not None else get_rules())
    with use_rules(rules):
        col = fsdp_column(mesh)
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            if col is not None:
                params = init_local_params(cfg, gen, dev, mesh.coords[1],
                                           mesh.model, col.index, col.size)
            elif model_row(mesh) is not None:
                params = init_local_params(cfg, gen, dev, mesh.coords[1],
                                           mesh.model)
            else:
                params = init_params(cfg, gen, dev)
        out: Dict[str, Any] = {}
        weight_codec = None
        if wire == "qlc":
            held, params = [params], None    # _wire frees a tree made here
            params, weight_codec = _wire(held, cfg, mesh, col, dev, out)
        elif wire != "none":
            raise ValueError(f"wire must be 'none' or 'qlc', got {wire!r}")

    kv_spec = pool = registry = monitor = None
    if kv_cache != "none":
        # async paging frames blocks on the card: fixed plan geometry
        kv_spec = KVCacheSpec(block_tokens=kv_block, mode=kv_cache,
                              exact_capacity=kv_paging != "async",
                              axis="model" if mesh is not None else None)
        pool = BlockPool(1 << 30)
        if kv_monitor:
            from repro_torch.adaptive import TrafficMonitor
            registry = CodecRegistry()
            monitor = out["kv_monitor"] = TrafficMonitor(registry)
    max_seq_len = prompt_len + new_tokens + 8
    with use_rules(rules):
        eng = Engine(params, cfg, max_seq_len=max_seq_len, max_batch=batch,
                     kv_spec=kv_spec, pool=pool, kv_paging=kv_paging,
                     registry=registry, monitor=monitor, mesh=mesh,
                     prefill_chunk=prefill_chunk, weight_codec=weight_codec)
    prompts = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (n_req, prompt_len), dtype=np.int64)
    t0 = time.perf_counter()
    handles = [eng.submit(GenerationRequest(prompt=p,
                                            max_new_tokens=new_tokens))
               for p in prompts]
    eng.run()
    outs = [eng.poll(h) for h in handles]
    out.update(serve_s=time.perf_counter() - t0, outs=outs,
               stats=eng.stats(), params=params, prompts=prompts,
               events=eng.events, kv_registry=eng.registry)
    if kv_cache == "qlc":
        # The lossless contract: pooled compressed paging is
        # token-identical to a dense cache. A dense model's rows are
        # independent, so request 0 alone decides; an MoE layer's capacity
        # is shared by the batch's rows, so the dense run gets every
        # request, in the same order, at the same batch. It takes the
        # paged engine's length (under a sequence split rounded to whole
        # blocks of every rank's range), so that both attend over caches
        # of one geometry and sum alike.
        with use_rules(rules):
            dense = Engine(params, cfg, max_seq_len=eng.max_seq_len,
                           max_batch=batch, mesh=mesh,
                           prefill_chunk=prefill_chunk,
                           weight_codec=weight_codec)
        group = prompts if cfg.moe is not None else prompts[:1]
        hs = [dense.submit(GenerationRequest(prompt=p,
                                             max_new_tokens=new_tokens))
              for p in group]
        dense.run()
        want = [dense.poll(h).tokens for h in hs]
        if cfg.moe is not None:
            out["dense_tokens"] = want
        else:
            out["solo_tokens"] = want[0]
        for i, w in enumerate(want):
            if not np.array_equal(outs[i].tokens, w):
                raise RuntimeError(
                    f"qlc KV cache must be token-identical to the dense "
                    f"run: request {i} {outs[i].tokens.tolist()} vs "
                    f"{w.tolist()}")
    return out


def _wire(held, cfg: ModelConfig, mesh, col, dev, out):
    """``held[0]`` on the QLC weight wire: a codec calibrated on the whole
    model's histogram (K1's, summed over the mesh), every large
    layer-stack leaf compressed through K1. Without FSDP the wire is
    opened again through K2 and the dense tree served (the tree made
    here freed first: ``held`` is its only reference); under FSDP
    (``col``) each rank keeps its chunks of
    the model-block wire of the layer stack, opened a group at a time in
    each decode step (``Engine(weight_codec=)``). -> (the served tree,
    the wire's codec or None); the wire, its codec and the seconds go
    into ``out``."""
    from repro_torch.comm.calibrate import histogram_of_local_tree
    from repro_torch.serving import (compress_params_for_serving,
                                     open_params)
    params = held.pop()
    t0 = time.perf_counter()
    reg = CodecRegistry()
    reg.register("default", histogram_of_local_tree(params, cfg, mesh))
    t1 = time.perf_counter()
    if col is not None:
        wired, wc = compress_params_for_serving(
            params["groups"], reg,
            whole_shapes=whole_leaf_shapes(cfg, "groups"), column=col,
            data_dims=leaf_data_dims(cfg, mesh.data, mesh.model, "groups"))
        params = dict(params, groups=wired)
        _sync(dev)
        out.update(wired=wired, wire_codec=wc, calibrate_s=t1 - t0,
                   compress_s=time.perf_counter() - t1, open_s=0.0)
        return params, wc
    wired, wc = compress_params_for_serving(
        params, reg, whole_shapes=whole_leaf_shapes(cfg)
        if model_row(mesh) is not None else None)
    _sync(dev)
    t2 = time.perf_counter()
    params = None       # frees a tree made here before the open
    params = open_params(wired, wc)
    _sync(dev)
    out.update(wired=wired, wire_codec=wc, calibrate_s=t1 - t0,
               compress_s=t2 - t1, open_s=time.perf_counter() - t2)
    return params, None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="engine slots (max concurrent sequences)")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests to submit (default: batch + 2)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--wire", default="none", choices=["none", "qlc"],
                    help="'qlc' stores weights as QLC wire and opens them "
                         "through the fused decode kernel")
    ap.add_argument("--kv-cache", default="none",
                    choices=["none", "qlc", "e4m3"],
                    help="page decode states through a shared compressed "
                         "block pool ('qlc' lossless, 'e4m3' quantized)")
    ap.add_argument("--kv-block", type=int, default=128,
                    help="tokens per paged-cache block")
    ap.add_argument("--kv-paging", default="sync", choices=["sync", "async"],
                    help="'async' keeps evicted blocks in a device arena "
                         "and decodes them through the prefetch kernel on "
                         "a side stream behind each decode window "
                         "(requires --kv-cache qlc)")
    ap.add_argument("--prefill-chunk", type=int, default=1,
                    help="prompt tokens a prefill step (attention-only "
                         "stacks; default 1, token by token)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.kv_paging == "async" and args.kv_cache != "qlc":
        ap.error("--kv-paging async requires --kv-cache qlc")
    if args.multi_pod or args.pods != 1:
        raise NotImplementedError("pods are not ported: ROADMAP queue 1, "
                                  "item 13")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg, frontend=None, frontend_prefix_len=0)
    res = serve(cfg, batch=args.batch, requests=args.requests,
                prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                wire=args.wire, kv_cache=args.kv_cache, kv_block=args.kv_block,
                kv_paging=args.kv_paging, device=args.device, seed=args.seed,
                prefill_chunk=args.prefill_chunk)
    outs = res["outs"]
    if not all(s.state == "finished" for s in outs):
        raise RuntimeError([(s.request_id, s.state, s.error) for s in outs])
    if args.wire == "qlc":
        print(f"weight wire: {len(res['wire_codec'].meta)} compressed "
              f"leaves, compress {res['compress_s'] * 1e3:.1f} ms, open "
              f"{res['open_s'] * 1e3:.1f} ms")
    st = res["stats"]
    if args.kv_cache != "none":
        ps = st["pool"]
        print(f"kv-cache={args.kv_cache}: peak "
              f"{ps['peak_referenced_bytes']} compressed B pinned vs "
              f"{st['peak_dense_logical_bytes']} dense B, "
              f"{ps['dedup_hits']} dedup hits")
        if args.kv_paging == "async":
            pf = st["prefetch"]
            print(f"async paging: {st['async']['windows']} windows, "
                  f"prefetch {pf['hits']}/{pf['scheduled']} hits, "
                  f"{pf['stalled']} stalled, "
                  f"overlap {pf['overlap_fraction']:.3f}")
    toks = sum(len(s.tokens) for s in outs)
    print(f"{len(outs)} requests / {toks} tokens in "
          f"{res['serve_s'] * 1e3:.0f}ms "
          f"({st['ms_per_token_prefill']:.1f} ms/tok prefill, "
          f"{st['ms_per_token_decode']:.1f} ms/tok decode)")
    print("first sequence:", outs[0].tokens[:16])
    return res


if __name__ == "__main__":
    main()
