"""Serving launcher: continuous-batching engine, optionally from
QLC-compressed weights.

``--wire qlc`` calibrates a codec from the parameters' e4m3 symbol
histogram (K1's histogram output), compresses every large layer-stack
leaf to block-32 e4m3 + QLC words (K1), opens them again through the
fused decode (K2) and serves the opened parameters through ``Engine``.
Weights are random, from ``--seed``.

Example (one H100):
  python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
      --batch 4 --requests 6 --prompt-len 16 --new-tokens 16 --wire qlc
On the CPU, with the plain versions of the kernels:
  python -m repro_torch.launch.serve --arch phi3-mini-3.8b --reduced \\
      --device cpu --wire qlc
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.models import init_params
from repro_torch.models.transformer import resolve_device
from repro_torch.serving import Engine, GenerationRequest


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, *, batch: int = 4, requests: Optional[int] = None,
          prompt_len: int = 16, new_tokens: int = 32, wire: str = "none",
          device="cuda", seed: int = 0, params=None) -> Dict[str, Any]:
    """Run the launcher's path and return what it produced: the request
    statuses, engine stats, the served params and, with ``wire="qlc"``,
    the wire, its codec and the calibrate/compress/open seconds."""
    dev = resolve_device(device)
    n_req = requests or batch + 2
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, gen, dev)
    out: Dict[str, Any] = {}
    if wire == "qlc":
        from repro_torch.comm.calibrate import histogram_of_tree
        from repro_torch.core import CodecRegistry
        from repro_torch.serving import (compress_params_for_serving,
                                         open_params)
        t0 = time.perf_counter()
        reg = CodecRegistry()
        reg.register("default", histogram_of_tree(params))
        t1 = time.perf_counter()
        wired, wc = compress_params_for_serving(params, reg)
        _sync(dev)
        t2 = time.perf_counter()
        params = open_params(wired, wc)
        _sync(dev)
        t3 = time.perf_counter()
        out.update(wired=wired, wire_codec=wc, calibrate_s=t1 - t0,
                   compress_s=t2 - t1, open_s=t3 - t2)
    elif wire != "none":
        raise ValueError(f"wire must be 'none' or 'qlc', got {wire!r}")

    eng = Engine(params, cfg, max_seq_len=prompt_len + new_tokens + 8,
                 max_batch=batch)
    prompts = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (n_req, prompt_len), dtype=np.int64)
    t0 = time.perf_counter()
    handles = [eng.submit(GenerationRequest(prompt=p,
                                            max_new_tokens=new_tokens))
               for p in prompts]
    eng.run()
    out.update(serve_s=time.perf_counter() - t0,
               outs=[eng.poll(h) for h in handles], stats=eng.stats(),
               params=params, prompts=prompts)
    return out


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
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg, frontend=None, frontend_prefix_len=0)
    res = serve(cfg, batch=args.batch, requests=args.requests,
                prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                wire=args.wire, device=args.device, seed=args.seed)
    outs = res["outs"]
    if not all(s.state == "finished" for s in outs):
        raise RuntimeError([(s.request_id, s.state) for s in outs])
    if args.wire == "qlc":
        print(f"weight wire: {len(res['wire_codec'].meta)} compressed "
              f"leaves, compress {res['compress_s'] * 1e3:.1f} ms, open "
              f"{res['open_s'] * 1e3:.1f} ms")
    st = res["stats"]
    toks = sum(len(s.tokens) for s in outs)
    print(f"{len(outs)} requests / {toks} tokens in "
          f"{res['serve_s'] * 1e3:.0f}ms "
          f"({st['ms_per_token_prefill']:.1f} ms/tok prefill, "
          f"{st['ms_per_token_decode']:.1f} ms/tok decode)")
    print("first sequence:", outs[0].tokens[:16])
    return res


if __name__ == "__main__":
    main()
