"""Where one all-to-all of the MoE expert wire spends its time, on one
card: deepseek-moe-16b at full width (1 layer, batch 4 x 512), layer
0's real dispatch buffer (``moe.dispatch_traffic``, the 1 x 1 send
buffer, bf16 [64, 240, 2048]) through ``Channel.all_to_all`` with the
layer's calibrated ``moe/dispatch`` codec, against the raw
``dist.all_to_all_single`` of the same buffer.

Prints each call's median time (CUDA events, ``--reps`` calls), then one
profiled call of each: the device time by kernel and the host time of
the wire's stages (``record_function`` spans around K1's encode, the
packing into one int32 message, the exchange, the unpacking and the
decode with its escape epilogue), and the card's name and power limit.

Run from the root of a checkout on a machine with a card:
  python3 tools/moe_wire_split.py
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, record_function
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.comm import compressed as comp
    from repro_torch.comm import transport as tr
    from repro_torch.comm.calibrate import calibrate_moe_entries
    from repro_torch.comm.channel import Channel, ChannelSpec
    from repro_torch.configs import get_config
    from repro_torch.core import CodecRegistry
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.kernels import qlc_fused
    from repro_torch.launch.mesh import data_parallel
    from repro_torch.models import init_params, moe, next_token_loss
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    qlc_fused.build_kernels()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), num_layers=1,
                              remat="none")
    with data_parallel("cuda") as group, torch.no_grad():
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda")
        b0 = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=512, global_batch=4)
                              ).batch_at(0)
        b0 = {k: torch.as_tensor(v).cuda() for k, v in b0.items()}
        captured = []
        with moe.capture_moe_traffic(captured):
            next_token_loss(params, cfg, b0["tokens"], b0["labels"])
        buf, _ = moe.dispatch_traffic(*captured[0], cfg)
        reg = CodecRegistry()
        calibrate_moe_entries(reg, cfg, params, b0)
        del params, captured
        ch = Channel(ChannelSpec(codec=moe.MOE_DISPATCH, group=group,
                                 axis="model", transport="oneshot"),
                     registry=reg)
        x = buf.reshape(1, -1)

        def raw():
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=group)
            return out

        def wire():
            return ch.all_to_all(x)

        def median_ms(fn):
            fn()
            torch.cuda.synchronize()
            ts = []
            for _ in range(args.reps):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                fn()
                e.record()
                torch.cuda.synchronize()
                ts.append(s.elapsed_time(e))
            return float(np.median(ts))

        print(f"payload {list(x.shape)} {x.dtype}: raw all_to_all_single "
              f"{median_ms(raw):.3f} ms, Channel.all_to_all (QLC) "
              f"{median_ms(wire):.3f} ms", flush=True)

        # The wire's stages, spanned (the same calls Channel.all_to_all
        # and transport.exchange_all_to_all make, one-shot).
        def staged():
            with record_function("wire: compress (K1)"):
                pieces, _ = tr._compress_pieces(x,
                                                1, ch.tables, ch.cfg)
            with record_function("wire: pack"):
                packed = tr._pack(pieces[0])
            with record_function("wire: all_to_all_single"):
                out = torch.empty_like(packed)
                dist.all_to_all_single(out, packed, group=group)
            with record_function("wire: unpack"):
                payload, scales = tr._unpack(out, pieces[0])
            with record_function("wire: decompress (K2 + escapes)"):
                vals, ok = comp._decompress_values(payload, scales,
                                                   ch.tables, ch.cfg)
            return vals, ok

        got, _ = staged()
        if not torch.equal(got.reshape(x.shape), wire()[0]):
            raise AssertionError("the staged wire differs from "
                                 "Channel.all_to_all")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            staged()
            torch.cuda.synchronize()
        events = prof.key_averages()

        def dev_us(e):
            return getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0))

        for e in events:
            if e.key.startswith("wire: "):
                print(f"{e.key}: host {e.cpu_time_total / 1e3:.3f} ms, "
                      f"device {dev_us(e) / 1e3:.3f} ms", flush=True)
        kern = sorted((e for e in events
                       if getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0))
                       > 0), key=lambda e: -getattr(
                           e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0)))
        for e in kern[:12]:
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
            print(f"  kernel {e.key[:80]}: {t / 1e3:.3f} ms x{e.count}",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
          .splitlines()[0])


if __name__ == "__main__":
    main()
