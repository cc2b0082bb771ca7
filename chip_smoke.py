"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

Phases, each printing its own line; any failure raises and exits
non-zero (nothing is caught and carried on):

  1. device  — needs a CUDA card; prints its name and power limit; turns
               TF32 off for f32 matmuls and convolutions.
  2. build   — compiles the kernels from ``src/repro_torch/kernels/csrc``.
  3. parity  — each kernel against its plain PyTorch version on the card,
               bit for bit: K1 (fused quantize+encode) on [4096, 1024] f32
               and bf16 with adversarial values mixed in, and its e4m3
               encoder on all 2^32 f32 bit patterns; K1 and K2 at the
               edges of their geometry (k = 32 and 4096, row counts no
               tile divides, slots over capacity, K2 at a 1409-word
               slot, codes of 12, 14 and 16 bits); K2 (fused
               decode+dequantize) in f32, bf16 and accumulate form with
               two schemes interleaved by scheme id; K3 (encode), K4
               (decode) and K5 (prefetch decode) on [4096, 256] u8 chunks
               with two schemes interleaved, at a slot that fits and at
               one that the longest chunks overrun; K4 and K5 at the
               edges of their geometry (n 1/31/33/4097, k 4 to 1024,
               slots of 1 word and even and odd ones, corrupted words,
               words at an odd offset, the most stacked schemes each
               takes and one more refused, prefixes of 4 to 8 bits); K3
               at the edges of its geometry (k 32 to 4096, worst,
               longest-chunk, median and 1-word slots, n around a full
               grid of warps, symbols at byte offsets 1-15, two tables,
               hand-made codes of up to 16, 17, 24 and 32 bits) and at
               the shapes of one 128-token KV block ([98304, 256], 45
               words) and of the ``Channel`` default ([32768, 1024], 240
               words), timed there too; the
               decode and encode entries after one warm call under
               torch's sync debug mode "error" (no synchronizing call).
               Times each (median of CUDA-event timings, L2 flushed
               before each launch) through ``ops`` and alone (the bare
               wrapper on operands made beforehand, the device's own
               time: ``time_ms(..., alone=True)``) beside its HBM bound.
               K6 (256-bin histogram) against its plain version and
               ``torch.bincount`` on [4096, 1024] skewed symbols covering
               all 256 values, on a length that is not a multiple of 16
               at an odd byte offset, and on a stream of one symbol;
               timed beside ``torch.bincount`` and its bound.
  4. small   — reduced phi3-mini-3.8b (d_model 128, f32) served from the
               QLC wire on the card and on the CPU: the wire and the
               opened params must be bit-equal, one decode step's logits
               equal to rtol 1e-4 / atol 1e-5 (f32 summation order).
  5. slice   — phi3-mini-3.8b at full width and depth, random weights
               from a seed: calibrate (K1 histogram), compress (K1), open
               (K2), serve 6 requests (batch 4, prompt 16, 16 new tokens)
               through ``Engine``; a sampled leaf must equal the plain
               dequantize of the plain quantize; K1 and K2 are held bit
               for bit against their plain versions at the shapes the
               path gave them (K1 with its histogram on the whole
               stacked ``w_in`` leaf, in row blocks; K2 on the first and
               last 4096 chunk rows of every wired leaf); and one
               ``decode_step(weight_codec=...)`` must equal the
               opened-params step. K1/K2 launch counts are zeroed right
               before the served run and read right after. One decode
               step runs first as warm-up, and one more, on the opened
               params, under torch.profiler.
  6. kv      — the paged compressed KV cache on the slice's opened params
               (``--kv-cache qlc --kv-block 16``): 6 requests at batch 4,
               prompt 32, 32 new tokens, with ``--kv-paging`` sync,
               async, async, sync (in turns, so the two compare inside
               one call). Every request finishes, request 0's tokens
               equal a dense solo run (inside ``serve``), and K3, K4 and
               K5 launch on the path: counts zeroed right before each
               run and read right after. Then, at the path's
               own shapes (one boundary of request 0: 2 byte planes x
               12,288 chunks of 256), K3/K4/K5 against their plain
               versions, the block through the host path (K3 + K4) and
               the device path (K3 + K5) back to its K/V, and the
               device-framed words equal to the host container, and K6
               on the calibration section's byte planes against its
               plain version and ``np.bincount``. The KV calibration
               counts its symbols through K6, so K6 launches in every
               run too.
  7. train   — compressed data-parallel training
               (``repro_torch.launch.train.train``) on one NCCL rank.
               First at reduced size (d_model 128, 2 layers, f32): 2
               compressed steps on the card and on the CPU from the same
               state, registry and batches, losses equal to rtol 1e-4, and
               one gradient through the wire on both: words, scales, the
               reduced segment and the gathered parameters bit-equal. Then
               phi3-mini-3.8b at full width, depth cut to 8 layers (f32
               parameters, gradients and AdamW moments of 32 layers do not
               fit in 80 GB beside the step's flat copies), global batch 4,
               sequence 512, transport oneshot: calibrate (K6 counts the
               gradient's symbols) and 4 compressed steps through
               ``Trainer``, K6/K1/K2 counts zeroed right before and read
               right after, every ``ok`` true and no fallback; K6 on the
               path's own symbols equal to ``torch.bincount`` and timed
               there; K1 with codes and K2's accumulate form on the path's
               own shape (the flat gradient's chunks at the plan's slot),
               bit-equal to their plain versions on the first and last
               4096 chunks and timed there; 2 compressed steps and 2 of the raw e4m3 twin from
               the same start, parameters bit-equal; 4 baseline steps,
               their losses beside the compressed run's (recorded: at
               this width the two do not stay within the reference's
               0.15 of each other, see PERF.md). The reference's own
               training check (its reduced model, optimizer and data,
               ``tests/test_train_integration.py``) runs on the card
               first and must pass: both steps learn and the compressed
               losses stay within 0.15 of the baseline's. Deterministic
               algorithms are on for this phase, so that two runs of the
               same step see the same gradients.

  8. ckpt    — on the same rank, first the resume check through the
               launcher's entry: ``train(comm="qlc", transport="auto",
               autotune=True, checkpoint_dir=..., checkpoint_every=3)``
               on reduced phi3, 6 steps; step 6 is then removed, as if the
               run had died while saving it, and the same launch resumes
               at step 3 and runs 3 more: parameters and ZeRO-1 state
               bit-equal to the straight run's, the step's "auto"
               channels resolving to the launcher's tuning, K1/K2/K6
               counted from zero around both launches. Then (after the
               autotune phase) the
               FP8 weight checkpoint of phi3-mini-3.8b at full width and
               all 32 layers (8, as the train phase, when the disk holds
               less than 1.5x its raw bytes): the block-32 e4m3 symbols
               and bf16 scales of every weight leaf, one float8_e4m3fn
               leaf and one f32 leaf, saved through ``CheckpointManager``
               into a temporary directory and restored bit for bit, with
               K3, K4 and K6 counted from zero around both; the stages
               timed (counts, encode, device-to-host, md5, write with
               fsync; read, decode); on-disk over raw bytes; at the
               largest leaf's shape K3 against its plain version on every
               chunk, K4 against the saved symbols and against its plain
               version on the first and last 4096 chunks, K6 whole, each
               timed there; the stored container must hold K3's words;
               one flipped container word must make the restore raise
               IOError. The directory is removed.
  9. autotune — the launcher's ``_autotune_transports`` on the train
               phase's registry and its one NCCL rank, for "grads"
               (reduce-scatter) and "params" (all-gather) at the train
               path's flat payload: the measured decode rate and the
               chosen transport; the tuning through a registry JSON round
               trip, an "auto" channel then resolving to it; what the
               decode probe measures (its payload's escapes and pool, its
               call beside the same decode under CUDA events and K2 alone
               on its words); ``psum`` and ``all_to_all`` on the card
               equal to the same calls on the CPU (plain versions). K1/K2
               counted from zero around the phase.

 10. adapt   — online codec adaptation. After the kv phase, its sync
               run again with a ``TrafficMonitor`` on the paged cache
               (``serve(..., kv_monitor=True)``): K6 counts every encoded
               section (exactly one launch each on top of the run's
               calibration), measured against planned bits/symbol per KV
               byte plane, and one section's K6 counts equal to a host
               ``np.bincount``. After the autotune phase, on the train
               cell (8 layers, full width, batch 4 x 512, one NCCL rank):
               2 compressed steps without and 2 with wire telemetry from
               the same state, parameters and moments bit-equal, each
               histogram counting every symbol of its wire; K1 alone at
               the flat-gradient shape with and without its histogram
               output (outputs bit-equal, the histogram equal to
               ``torch.bincount`` of the codes), in turns;
               ``train(comm="qlc", adapt=True, adapt_every=2)`` on real
               gradients, 6 steps, each check's measured against planned
               bits/symbol; a forced swap: the ``"grads"`` codec
               calibrated on the parameters' histogram, ``adapt_every=1``,
               6 steps: the adapter must flag, recalibrate, register a
               new scheme-id and install the rebuilt step (swap step,
               ids, bits and modeled wire B/symbol before and after, the
               swap's ms); parameter chunks encoded under the old id
               before the swap decode after it beside gradient chunks
               under the new id in one stacked K2 launch, and the same
               for codes containers through K4. K1, K2 and K6 counted
               from zero around the two launches.
 11. moe     — MoE training with the QLC-compressed expert all-to-all,
               after adapt, on the same rank (a 1 x 1 data x model
               layout): deepseek-moe-16b at full width (d_model 2048, 64
               routed experts top-6 of width 1408, 2 shared, vocab
               102400), 1 of 28 layers, batch 4 x 512. On one layer's
               real input gspmd, grouped_local(1) and raw shardmap_a2a
               route alike (idx, keep mask, drops printed) and are
               bit-equal; ``calibrate_moe_entries`` (K6 counts equal to
               ``np.bincount``) prints both codecs; K1 and K2 (f32) at
               the wire's shape bit-equal to plain on the first and last
               4096 chunks; ``train(comm="baseline", moe_wire="qlc")``, 3
               steps, bit-equal to its raw e4m3 twin, then
               ``moe_wire="raw"``; ``train(comm="qlc", moe_wire="qlc")``,
               3 steps, bit-equal to its twin. Prints per direction the
               measured and modeled wire B/symbol, ms/step and K1/K2
               launches per step of each run, the gradient and parameter
               wires' B/symbol and the peak device memory. K1-K6 counted
               from zero around the calibration and the runs.

 12. moe_serve — serving deepseek-moe-16b from the QLC weight wire,
               after moe: full width, ``MOE_SERVE_LAYERS`` of 28 layers
               (14: the whole script's time; 23 is the deepest that
               leaves over 8 GiB of the card free),
               f32 parameters, random weights from a seed. Through
               ``launch.serve.serve``: calibrate (K1's histogram),
               compress (K1), the init tree freed, open (K2), 6 requests
               at batch 4, prompt 16, 16 new tokens: wire B/symbol,
               set-up ms, ms/token prefill and decode, drops per decode
               step (capacity 1 per expert at batch 4; batch-1 prefill
               drops none); then ``--kv-cache qlc --kv-block 16`` sync
               (K3, K4) and async (K3, K5), KV codecs calibrated through
               K6, every request's tokens equal to the dense run's. K1-K6
               counted from zero around the three runs, each non-zero.
               K3-K6 against their plain versions on this model's KV
               data, as in the kv phase (its 16 kv heads' byte planes at
               the slot caps its codecs calibrate). Layer 0's expert
               leaves from an e4m3-mode wire (plain
               dequantize) bit-equal to the same leaves through QLC; the
               serving manifest with the KV recipe through JSON opens
               every wired leaf bit-identically; K2 and K1 at the
               stacked ``w_in`` leaf's path shape bit-equal to plain on
               the first and last 4096 chunks and timed there. Prints the
               peak device memory.

 13. ssm     — xlstm-125m served and trained, after moe_serve: all 12
               layers (sLSTM / mLSTM alternating), full width, f32
               parameters, bf16 compute, random weights from a seed.
               Through ``launch.serve.serve``: the weight wire (K1's
               histogram, K1, K2) and a dense run of 6 requests at batch
               4, prompt 16, 16 new tokens; ``--kv-cache qlc --kv-block
               16`` sync (K3, K4) and async (K3, K5), codecs calibrated on
               the recurrent states through K6, snapshots re-based; every
               request's tokens equal the dense run's. Two requests
               sharing a two-block prompt prefix, sync and async: their
               re-based snapshots dedup and their tokens equal each alone
               on the dense engine. K3-K6 against their plain versions on
               the mLSTM layer's snapshot planes (``check_kv_path``), K1
               and K2 at its ``wq`` leaf's wire shape; the kernel launches
               of one decode step and one training forward and backward.
               ``train(comm="qlc")`` on one NCCL rank at batch 4 x
               ``SSM_TRAIN_SEQ``: 2 compressed steps, 2 of the raw e4m3
               twin (bit-equal), 2 baseline steps. One mamba layer at
               jamba-1.5-large's widths (d_model 8192, d_inner 16384, N
               16, f32): 16 tokens, then 8 decode steps, equal to one
               24-token segment; its state through K3 and K4 bit for bit.
               K1-K6 counted from zero around the serve runs, the train
               runs and the mamba round trip, each non-zero. Before the
               moe_serve phase, the device bytes that ``gc.collect()``
               frees are printed.

 14. variants — the block variants, after ssm. musicgen-medium (gelu
               FFN without ``w_gate``): ``VARIANTS_TRAIN_LAYERS`` of its 48 layers
               at full width
               (d_model 1536, 24 heads x 64, d_ff 6144, vocab 2048), f32
               parameters, bf16 compute, random weights from a seed,
               served through ``launch.serve.serve``: the weight wire
               (K1's histogram, K1, K2), a dense run of 6 requests at
               batch 4, prompt 16, 16 new tokens, ``--kv-cache qlc
               --kv-block 16`` sync (K3, K4) and async (K3, K5), codecs
               calibrated through K6, every request's tokens equal to the
               dense run's; ``Engine(fairness_cap=0.5)`` over the same 6
               requests from two tenants: ``defer_fairness`` events, at
               most 2 running slots per tenant, tokens equal to the dense
               engine's. K1/K2 at the stacked ``w_in`` leaf ([48, 1536,
               6144]) and K3-K6 on its KV planes against their plain
               versions; one decode step's launches, kernel and wall time
               (idle share) and one training forward and backward's.
               ``train(comm="qlc")`` on one NCCL rank at batch 4 x 512
               (448 tokens a row), ``VARIANTS_TRAIN_LAYERS`` layers: 2
               compressed steps, 2 of the raw e4m3 twin (bit-equal), 2
               baseline; calibrate ms, ms/step, wire B/symbol, peak. One
               nemotron-4-340b block at its widths (d_model 18432, 96 / 8
               heads x 192, d_ff 73728 squared ReLU, f32): 24 positions
               through the training path, then 16 tokens written into a
               KV cache at once and 8 decode steps, equal to it within
               rtol 1e-4 / atol 1e-5. One mixtral-8x22b attention block
               (d_model 6144, 48 / 8 heads x 128, rope theta 1e6, window
               4096, f32): 5120 positions through the blocked training
               path, 4096 written into the cache at once and 1024 decode
               steps past the window, equal to it; with the window off
               equal to its own training path and different past the
               window. K1-K6 counted from zero around the serve and train
               runs, each non-zero.

 15. tp      — tensor parallelism of the dense layers, right after the
               train phase on its rank. The layout table: for every
               config at 2 x 2, 1 x 4 and 16 x 16, the leaves its specs
               split over the model axis and keep whole and the parameter
               bytes a rank holds. phi3-mini-3.8b at full width and all 32
               layers on the card, cut for model axes of 2 and 4
               (``convert.shard_params``), every local leaf of its spec's
               shape, gathered back bit-equal. The train cell (8 layers,
               4 x 512): 2 compressed steps through ``train()`` with no
               mesh and with a 1 x 1 mesh in scope (the 2-D step's code),
               calibrated alike, parameters bit-equal; K6/K1/K2 counted
               from zero around the second. K1 (with codes) and K2
               (accumulate form) at 2 x 2's per-rank flat-gradient shape
               (model rank 0's blocks of the 32-layer gradient of data
               rank 0's 2 rows), bit-equal to plain on the first and last
               4096 chunks and timed. With two or more cards, the layouts
               they allow through ``tools/tp_cards.py`` at 8 layers; it
               prints which layouts ran.

 16. tp_serve — serving over a model row, right after tp in the same
               NCCL world of one. phi3-mini-3.8b at ``TP_SERVE_LAYERS``
               of 32 layers, served through ``launch.serve.serve`` from
               the QLC weight wire with no mesh and under a 1 x 1 mesh
               (weight registry, opened tree, dense tokens and K1/K2
               launches identical), then ``Engine(mesh=)`` paged sync and
               async with ``KVCacheSpec(axis="model",
               exact_capacity=False)`` beside the same engines with no
               mesh: tokens, pooled bytes, KV registry digests and K3-K6
               launches identical, tokens equal to the dense engine's.
               ``all_gather_block_wire`` of a block over the world: the
               words equal its container and decode through K4 bit-equal.
               K1/K2 at a 1 x 4 deepseek-coder-33b rank's stacked
               ``w_in`` block ([62, 7168, 4800]) and K3-K6 at its KV
               block planes (2 of 8 KV heads, 62 layers, 16 tokens),
               each bit-equal to plain and timed beside its HBM bound.
               With two or more cards, ``tools/tp_cards.py --serve`` at 8
               layers over all of them.

 17. fsdp    — after dp_serve (whose runs under ``make_rules()`` and
               the reference's decode rules now gather each layer group
               over a data column of one, counted and required): the
               train cell's baseline step as ZeRO-3 on a 1 x 1 mesh,
               gathers and reduce-scatters counted, bit-equal to the
               TP-only step; phi3-mini-3.8b at all 32 layers served under
               the reference's decode rules from the QLC wire kept
               compressed and opened a group at a time through the
               sharded open of one rank (K2 each hop), token-equal to the
               unsharded engine (``phase_fsdp``).

Then a ``{"kernels": [...]}`` JSON line (each kernel's ``ms`` through
``ops`` and ``kernel_ms`` alone, at the parity shape and on its path),
the ``nvidia-smi`` name/power line, and, last, ``{"ok": true,
"device": {...}}``.

Run from the root of a checkout:  python3 chip_smoke.py

``python3 chip_smoke.py --ssm-only`` (``--variants-only``,
``--tp-only``, ``--tp-serve-only``, ``--dp-serve-only``,
``--fsdp-only``, ``--roofline-only``) runs only the build and the ssm
(variants, tp, tp_serve, dp_serve, fsdp, roofline) phase,
then the ``nvidia-smi`` line, and no result line.

``python3 chip_smoke.py --moe-serve-layers L`` runs only the build and
the moe_serve phase, at L of the 28 layers, and prints its peak device
memory and what of the card was never reserved (one depth a process;
23 is the deepest that leaves over 8 GiB), then the ``nvidia-smi``
line, and no result line.
"""
from __future__ import annotations

import argparse
import atexit
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"                  # where the KV phase and codes checks run
ROOT = os.path.dirname(os.path.abspath(__file__))


#: the script's start, for each line's elapsed seconds
START = time.perf_counter()


def log(phase: str, msg: str):
    print(f"[{phase} {time.perf_counter() - START:.1f}s] {msg}", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


#: SM cycles the device spins between a flush and a kernel-alone timing
#: (about 0.5 ms on the H100).
SETTLE_CYCLES = 1_000_000


def time_ms(fn, reps: int, flush: torch.Tensor, alone: bool = False
            ) -> float:
    """Median time of ``fn`` over ``reps`` launches, each after an L2 flush
    (the main path finds its operands cold), from CUDA events around the
    call: device time, plus any time the device waits for the host to
    issue the call's work. With ``alone`` the device spins for
    ``SETTLE_CYCLES`` after the flush, so its dirty lines drain to HBM and
    the host has issued the call before the device reaches the start
    event: the events then time the device's execution alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        if alone:
            torch.cuda._sleep(SETTLE_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def bound_ms(entry: str, *args, **kwargs) -> float:
    """The HBM bound of the kernel behind ``kernels.ops.<entry>`` called
    with these arguments: ``roofline.kernel_bytes`` (its inputs read
    once, its outputs written once) over ``roofline.hw.HBM_BW``."""
    from repro_torch.roofline import hw, kernel_bytes
    return hw.hbm_ms(kernel_bytes(entry, *args, **kwargs))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"kernel/plain mismatch in dtype or shape: "
                             f"{a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    if a.is_floating_point():
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return math.inf
        return float((a.float() - b.float()).nan_to_num().abs().max())
    return float((a.long() - b.long()).abs().max())


# Kernel-alone calls: each kernel's wrapper (``kernels.qlc_fused``,
# ``qlc_codes``, ``histogram256``) on operands that are made before the
# call is timed (device tables, scheme slots), where the ``ops`` entry
# points make or look them up on every call.

def _tables_of(tables):
    return tables if isinstance(tables, (list, tuple)) else [tables]


def bare_k1(x, tables, cap, **kw):
    from repro_torch.kernels import ops, qlc_fused as qf
    code, length, _ = ops._encode_luts(tables, x.device)
    return lambda: qf.fused_encode(x, code, length, cap, **kw)


def bare_k2(words, scales, tables, k, sid=None, **kw):
    from repro_torch.kernels import ops, qlc_fused as qf
    dev = words.device
    dec, sb, st, pb = ops._area_luts(_tables_of(tables), dev)
    vtab = ops._value_table(dev)
    sid = torch.zeros(words.shape[0], dtype=torch.int32, device=dev) \
        if sid is None else sid
    sc = scales.float().contiguous()
    return lambda: qf.fused_decode(words, sc, sid, dec, sb, st, vtab, k,
                                   prefix_bits=pb, **kw)


def bare_k3(sym, tables, cap):
    from repro_torch.kernels import ops, qlc_codes as qc
    code, length, longest = ops._encode_luts(tables, sym.device)
    return lambda: qc.encode(sym, code, length, cap, max_code_bits=longest)


def bare_codes_decode(which, words, tables, sid, k):
    """K4 (``which="decode"``) or K5 (``"prefetch_decode"``) alone."""
    from repro_torch.kernels import ops, qlc_codes as qc
    window, pb, longest = ops._window_luts(_tables_of(tables), words.device)
    fn = getattr(qc, which)
    return lambda: fn(words, sid, window, k, prefix_bits=pb,
                      max_code_bits=longest)


def bare_k6(x):
    from repro_torch.kernels import histogram256 as h6
    flat = x.reshape(-1).contiguous()
    return lambda: h6.histogram256(flat)


def require_equal(what: str, a, b) -> float:
    err = max(max_abs_err(x, y) for x, y in zip(a, b))
    if err != 0 or not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: kernel differs from plain version "
                             f"(max abs err {err})")
    return err


def phase_parity(qf, ops, ref, lut, schemes, flush):
    rng = np.random.default_rng(0)
    c1 = rng.integers(1, 1000, 256).astype(np.float64)
    c1[0] = 1e6
    t1 = lut.build_tables(c1, schemes.TABLE1)
    t2 = lut.build_tables(c1[::-1].copy(), schemes.TABLE2)
    n, k = 4096, 1024
    x = (rng.standard_normal((n, k)) * 3).astype(np.float32)
    adv = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1e30, -1e30,
                    480.0, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10, 1e-40,
                    -1e-40, 464.0, 1.0625], np.float32)
    x[::7, :16] = adv
    x[5, 32:64] = 0.0
    wc = 353                                   # worst_case_words(1024)
    res = {"K1": {"err": 0.0}, "K2": {"err": 0.0}}
    for dt in (torch.float32, torch.bfloat16):
        xd = torch.from_numpy(x).cuda().to(dt)
        a = ops.quantize_encode(xd, t1, wc, emit_codes=True, emit_hist=True)
        b = ref.quantize_encode_ref(xd, t1, wc, emit_codes=True,
                                    emit_hist=True)
        torch.cuda.synchronize()
        res["K1"]["err"] = max(res["K1"]["err"],
                               require_equal(f"K1 {dt}", a, b))
        a = ops.quantize_encode(xd, t1, 20)
        b = ref.quantize_encode_ref(xd, t1, 20)
        res["K1"]["err"] = max(res["K1"]["err"],
                               require_equal(f"K1 {dt} over capacity", a, b))
        log("parity", f"K1 {str(dt)[6:]} [{n}, {k}]: bit-equal (words, "
                      "nbits, scales, codes, hist; also at 20-word slots)")

    xf = torch.from_numpy(x).cuda()
    enc = lambda: ops.quantize_encode(xf, t1, wc)          # noqa: E731
    words, nb, sc = enc()
    res["K1"]["ms"] = time_ms(enc, 20, flush)
    res["K1"]["kernel_ms"] = time_ms(bare_k1(xf, t1, wc), 20, flush,
                                    alone=True)
    res["K1"]["plain_ms"] = time_ms(
        lambda: ref.quantize_encode_ref(xf, t1, wc), 3, flush)
    res["K1"]["bound_ms"] = bound_ms("quantize_encode", xf, t1, wc)
    log("parity", f"K1 f32 [{n}, {k}] cap {wc}: {res['K1']['ms']:.4f} ms "
                  f"(kernel alone {res['K1']['kernel_ms']:.4f}), plain "
                  f"{res['K1']['plain_ms']:.2f} ms, HBM bound "
                  f"{res['K1']['bound_ms']:.4f} ms")

    # Two schemes interleaved by chunk: even rows under t1, odd under t2,
    # cut to the exact capacity as the weight wire does.
    sid = torch.from_numpy((np.arange(n) % 2).astype(np.int32)).cuda()
    w1, n1, s1 = ops.quantize_encode(xf, t1, wc)
    w2, n2, _ = ops.quantize_encode(xf, t2, wc)
    cap = -(-int(torch.maximum(n1, n2).max()) // 32)
    mix = torch.where((sid == 1)[:, None], w2, w1)[:, :cap].contiguous()
    acc = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)
                           ).cuda()
    forms = {
        "f32": (lambda: ops.decode_dequantize(mix, s1, [t1, t2], k,
                                              scheme_ids=sid),
                lambda: ref.decode_dequantize_ref(mix, s1, [t1, t2], sid, k),
                bound_ms("decode_dequantize", mix, s1, [t1, t2], k,
                         scheme_ids=sid),
                bare_k2(mix, s1, [t1, t2], k, sid)),
        "bf16": (lambda: ops.decode_dequantize(mix, s1, [t1, t2], k,
                                               scheme_ids=sid,
                                               out_dtype=torch.bfloat16),
                 lambda: ref.decode_dequantize_ref(
                     mix, s1, [t1, t2], sid, k, out_dtype=torch.bfloat16),
                 bound_ms("decode_dequantize", mix, s1, [t1, t2], k,
                          scheme_ids=sid, out_dtype=torch.bfloat16),
                 bare_k2(mix, s1, [t1, t2], k, sid,
                            out_dtype=torch.bfloat16)),
        "acc": (lambda: ops.decode_dequantize_accumulate(
                    acc, mix, s1, [t1, t2], k, scheme_ids=sid),
                lambda: ref.decode_dequantize_ref(mix, s1, [t1, t2], sid, k,
                                                  acc=acc),
                bound_ms("decode_dequantize_accumulate", acc, mix, s1,
                         [t1, t2], k, scheme_ids=sid),
                bare_k2(mix, s1, [t1, t2], k, sid, acc=acc)),
    }
    res["K2"]["forms"] = {}
    for name, (kern, plain, bound, bare) in forms.items():
        a, b = kern(), plain()
        torch.cuda.synchronize()
        res["K2"]["err"] = max(res["K2"]["err"],
                               require_equal(f"K2 {name}", [a], [b]))
        f = {"ms": time_ms(kern, 20, flush),
             "kernel_ms": time_ms(bare, 20, flush, alone=True),
             "plain_ms": time_ms(plain, 3, flush),
             "bound_ms": bound}
        res["K2"]["forms"][name] = f
        log("parity", f"K2 {name} [{n}, {k}] cap {cap}, 2 schemes: "
                      f"bit-equal; {f['ms']:.4f} ms (kernel alone "
                      f"{f['kernel_ms']:.4f}), plain "
                      f"{f['plain_ms']:.2f} ms, HBM bound "
                      f"{f['bound_ms']:.4f} ms")
    a = ops.decode_dequantize(w1[:, :20].contiguous(), s1, t1, k)
    b = ref.decode_dequantize_ref(w1[:, :20].contiguous(), s1, [t1], 0, k)
    res["K2"]["err"] = max(res["K2"]["err"],
                           require_equal("K2 over capacity", [a], [b]))
    res["K2"].update(res["K2"]["forms"]["f32"])
    return res


def e4m3_exhaustive(qf, e4m3, piece: int = 1 << 26) -> int:
    """K1's e4m3 encoder (the hardware conversion with its two patches)
    against the plain encoder on every f32 bit pattern, in pieces of
    ``piece`` patterns. Returns the number of patterns that differ."""
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    for start in range(0, 1 << 32, piece):
        bits = torch.arange(start, start + piece, dtype=torch.int64,
                            device="cuda")
        x = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
            torch.int32).view(torch.float32)
        bad += (qf.e4m3_encode(x) != e4m3.e4m3_encode(x)).sum()
    return int(bad)


def phase_edge_parity(ops, ref, lut, schemes, codec):
    """K1 and K2 against their plain versions, bit for bit, at the edges of
    their launch geometry: chunks of one block (k = 32) and of four
    1024-symbol pieces (k = 4096), row counts that no CTA's warps or
    32-chunk tiles divide, f32 and bf16 inputs, slots that fit, that the
    median chunk overruns and of 20 words; K2 in f32, bf16 and accumulate
    form with two schemes interleaved, also at k = 4096's worst-case slot
    (1409 words: wider than 1024)."""
    from repro_torch.quant import e4m3
    rng = np.random.default_rng(7)
    err = {"K1": 0.0, "K2": 0.0}
    for k, n in ((32, 4133), (4096, 1037)):
        x = (rng.standard_normal((n, k)) * 2).astype(np.float32)
        x[0, :8] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-40, 480.0]
        x[1, :32] = 0.0
        sym = e4m3.quantize_block32(torch.from_numpy(np.nan_to_num(x)))[0]
        counts = np.bincount(sym.numpy().reshape(-1),
                             minlength=256).astype(np.float64) + 1
        tl = [lut.build_tables(counts, schemes.TABLE1),
              lut.build_tables(counts[::-1].copy(), schemes.TABLE2)]
        wc = codec.worst_case_words(k)
        for dt in (torch.float32, torch.bfloat16):
            xd = torch.from_numpy(x).cuda().to(dt)
            for cap in (wc, 20):
                err["K1"] = max(err["K1"], require_equal(
                    f"K1 edge k {k} {dt} cap {cap}",
                    ops.quantize_encode(xd, tl[0], cap, emit_codes=True,
                                        emit_hist=True),
                    ref.quantize_encode_ref(xd, tl[0], cap, emit_codes=True,
                                            emit_hist=True)))
        xf = torch.from_numpy(x).cuda()
        w1, n1, sc = ops.quantize_encode(xf, tl[0], wc)
        w2, n2, _ = ops.quantize_encode(xf, tl[1], wc)
        sid = (torch.arange(n, device="cuda") % 2).to(torch.int32)
        nb = torch.where(sid == 1, n2, n1)
        mix = torch.where((sid == 1)[:, None], w2, w1)
        acc = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)
                               ).cuda()
        caps = {"fit": -(-int(nb.max()) // 32),
                "over": max(1, int(nb.float().median()) // 32), "worst": wc}
        for what, cap in caps.items():
            w = mix[:, :cap].contiguous()
            for form, kern, plain in (
                    ("f32", lambda: ops.decode_dequantize(
                        w, sc, tl, k, scheme_ids=sid),
                     lambda: ref.decode_dequantize_ref(w, sc, tl, sid, k)),
                    ("bf16", lambda: ops.decode_dequantize(
                        w, sc, tl, k, scheme_ids=sid,
                        out_dtype=torch.bfloat16),
                     lambda: ref.decode_dequantize_ref(
                         w, sc, tl, sid, k, out_dtype=torch.bfloat16)),
                    ("acc", lambda: ops.decode_dequantize_accumulate(
                        acc, w, sc, tl, k, scheme_ids=sid),
                     lambda: ref.decode_dequantize_ref(w, sc, tl, sid, k,
                                                       acc=acc))):
                err["K2"] = max(err["K2"], require_equal(
                    f"K2 edge k {k} {form} {what} cap {cap}", [kern()],
                    [plain()]))
        log("parity", f"K1 edge k {k} [{n}, {k}] f32/bf16 at {wc} and 20 "
                      "words with codes and hist; K2 f32/bf16/acc, 2 schemes, "
                      f"at {caps} words: bit-equal")
    # Wider area codes than the paper's 3 bits: every code prefix + 8 bits
    # long, up to 16 (two per cursor top-up, K2's 64-word ring).
    n, k = 1037, 1024
    x = torch.from_numpy((rng.standard_normal((n, k)) * 2).astype(np.float32))
    counts = np.bincount(e4m3.quantize_block32(x)[0].numpy().reshape(-1),
                         minlength=256) + 1.0
    x = x.cuda()
    for pb in (4, 6, 8):
        t = lut.build_tables(counts, schemes.QLCScheme(
            areas=((256 >> pb, 8),) * (1 << pb), prefix_bits=pb))
        wc = codec.worst_case_words(k, pb + 8)
        got = ops.quantize_encode(x, t, wc)
        err["K1"] = max(err["K1"], require_equal(
            f"K1 prefix {pb}", got, ref.quantize_encode_ref(x, t, wc)))
        w, nb, sc = got
        for cap in (wc, max(1, int(nb.float().median()) // 32)):
            wcut = w[:, :cap].contiguous()
            err["K2"] = max(err["K2"], require_equal(
                f"K2 prefix {pb} cap {cap}",
                [ops.decode_dequantize(wcut, sc, t, k)],
                [ref.decode_dequantize_ref(wcut, sc, [t], 0, k)]))
        log("parity", f"K1 and K2 f32 with {pb + 8}-bit codes ({pb}-bit "
                      f"prefix) [{n}, {k}] at {wc} words and over capacity: "
                      "bit-equal")
    return err


def _skewed_symbols(rows: int, k: int, seed: int) -> torch.Tensor:
    """u8 chunks on the card: skewed rows (they code below 8 bits per
    symbol) and every fourth row uniform (it overruns a tight slot)."""
    rng = np.random.default_rng(seed)
    sym = np.minimum(rng.geometric(0.08, (rows, k)), 255).astype(np.uint8)
    sym[::4] = rng.integers(0, 256, (len(sym[::4]), k), dtype=np.uint8)
    return torch.from_numpy(sym).to(DEVICE)


def codes_checks(ops, ref, sym, tables, caps, sid=None):
    """K3 at each cap, then K4 and K5 on the (scheme-interleaved) words,
    each against its plain version on the card, bit for bit. Returns
    {kernel: max abs err} and the words at the first cap."""
    err = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
    tl = tables if isinstance(tables, list) else [tables]
    first = None
    for cap in caps:
        outs = [ops.encode(sym, t, cap) for t in tl]
        for t, o in zip(tl, outs):
            err["K3"] = max(err["K3"], require_equal(
                f"K3 cap {cap}", o, ref.encode_ref(sym, t, cap)))
        w = outs[0][0] if sid is None else torch.where(
            (sid == 1)[:, None], outs[1][0], outs[0][0])
        s = torch.zeros(w.shape[0], dtype=torch.int32, device=w.device) \
            if sid is None else sid
        want = ref.decode_ref(w, tl, s, sym.shape[1])
        for name, fn in (("K4", ops.decode), ("K5", ops.decode_block_async)):
            err[name] = max(err[name], require_equal(
                f"{name} cap {cap}", [fn(w, tl, sym.shape[1], scheme_ids=s)],
                [want]))
        if first is None:
            first = (w, s)
    return err, first


def time_codes(ops, ref, sym, tables, cap, words, sid, flush, reps=20):
    """ms, plain ms and HBM bound of K3 at ``cap`` and of K4/K5 on
    ``words``: each input read once, each output written once."""
    n, k = sym.shape
    tl = tables if isinstance(tables, list) else [tables]
    out = {}
    for name, fn, bare, plain, bound in (
            ("K3", lambda: ops.encode(sym, tl[0], cap),
             bare_k3(sym, tl[0], cap),
             lambda: ref.encode_ref(sym, tl[0], cap),
             bound_ms("encode", sym, tl[0], cap)),
            ("K4", lambda: ops.decode(words, tl, k, scheme_ids=sid),
             bare_codes_decode("decode", words, tl, sid, k),
             lambda: ref.decode_ref(words, tl, sid, k),
             bound_ms("decode", words, tl, k, scheme_ids=sid)),
            ("K5", lambda: ops.decode_block_async(words, tl, k,
                                                  scheme_ids=sid),
             bare_codes_decode("prefetch_decode", words, tl, sid, k),
             lambda: ref.decode_block_async_ref(words, tl, sid, k),
             bound_ms("decode_block_async", words, tl, k,
                      scheme_ids=sid))):
        out[name] = {"ms": time_ms(fn, reps, flush),
                     "kernel_ms": time_ms(bare, reps, flush, alone=True),
                     "plain_ms": time_ms(plain, 3, flush),
                     "bound_ms": bound, "shape": [n, k], "cap": cap}
    return out


def phase_codes_parity(ops, ref, lut, schemes, flush):
    """K3/K4/K5 at the parity shape: [4096, 256] chunks, two schemes
    interleaved, at the slot of the longest chunk and at the first
    quartile's (three quarters of the chunks over capacity)."""
    n, k = 4096, 256
    sym = _skewed_symbols(n, k, 0)
    counts = np.bincount(sym.cpu().numpy().reshape(-1),
                         minlength=256).astype(np.float64) + 1
    tl = [lut.build_tables(counts, schemes.TABLE1),
          lut.build_tables(counts[::-1].copy(), schemes.TABLE2)]
    nb = torch.maximum(*(ops.encode(sym, t, 89)[1] for t in tl))
    fit = -(-int(nb.max()) // 32) | 1
    over = int(nb.float().quantile(0.25)) // 32
    sid = (torch.arange(n, device=DEVICE) % 2).to(torch.int32)
    err, (w, s) = codes_checks(ops, ref, sym, tl, (fit, over), sid)
    res = time_codes(ops, ref, sym, tl, fit, w, s, flush)
    for name, r in res.items():
        r["err"] = err[name]
        log("parity", f"{name} [{n}, {k}] cap {r['cap']}, 2 schemes "
                      f"(also bit-equal at {over} words, over capacity): "
                      f"{r['ms']:.4f} ms (kernel alone "
                      f"{r['kernel_ms']:.4f}), plain {r['plain_ms']:.2f} ms, "
                      f"HBM bound {r['bound_ms']:.4f} ms")
    return res


def _edge_words(n, k, cw, tables, seed):
    """Words [n, cw] on the card of skewed and uniform chunks under
    schemes drawn at random per chunk (the plain encoder's, so slots the
    longer chunks overrun unless cw is wide), a quarter of the rows
    replaced by random u32 words; and the scheme slots."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(seed)
    sym = _skewed_symbols(n, k, seed)
    sid = torch.from_numpy(rng.integers(0, len(tables), n).astype(np.int32)
                           ).to(DEVICE)
    w = torch.zeros((n, cw), dtype=torch.int32, device=DEVICE)
    for j, t in enumerate(tables):
        wj, _ = ref.encode_ref(sym, t, cw)
        w[sid == j] = wj[sid == j]
    bad = torch.from_numpy(rng.random(n) < 0.25).to(DEVICE)
    w[bad] = torch.from_numpy(rng.integers(
        0, 1 << 32, (int(bad.sum()), cw), dtype=np.uint64
    ).astype(np.uint32).view(np.int32)).to(DEVICE)
    return sym, w, sid


def _at_offset(w: torch.Tensor, offset: int) -> torch.Tensor:
    buf = torch.zeros(w.numel() + offset, dtype=torch.int32, device=w.device)
    buf[offset:] = w.reshape(-1)
    return buf[offset:].view(w.shape)


def phase_codes_edge(ops, ref, lut, schemes, codec):
    """K4 and K5 against the plain decode, bit for bit, at the edges of
    their geometry: n in {1, 31, 33, 4097} chunks, k in {4, 36, 100, 256,
    1024} symbols, slots of 1 word and of an even and an odd count at the
    longest chunk's size, a quarter of the rows random u32 words, words
    at word offsets 0 and 1 of their buffer; then as many 3-bit schemes
    as each wrapper takes (one more refused), and prefixes of 4 to 8 bits
    (codes of up to 16) at worst-case and overrun slots."""
    from repro_torch.kernels import qlc_codes as qc
    err = {"K4": 0.0, "K5": 0.0}
    entries = (("K4", ops.decode), ("K5", ops.decode_block_async))
    counts = np.bincount(_skewed_symbols(64, 256, 1).cpu().numpy()
                         .reshape(-1), minlength=256).astype(np.float64) + 1
    tl = [lut.build_tables(counts, schemes.TABLE1),
          lut.build_tables(counts[::-1].copy(), schemes.TABLE2)]
    cases = 0
    for n in (1, 31, 33, 4097):
        for k in (4, 36, 100, 256, 1024):
            sym = _skewed_symbols(n, k, n + k)
            fit = max(-(-int(codec.encode_chunk_bits(sym, t.enc_len).max())
                        // 32) for t in tl)
            for cw in sorted({1, fit + (fit & 1), fit | 1}):
                _, w, sid = _edge_words(n, k, cw, tl, n + k)
                want = ref.decode_ref(w, tl, sid, k)
                for offset in (0, 1):
                    for name, fn in entries:
                        err[name] = max(err[name], require_equal(
                            f"{name} edge n {n} k {k} cw {cw} offset "
                            f"{offset}", [fn(_at_offset(w, offset), tl, k,
                                             scheme_ids=sid)], [want]))
                        cases += 1
    log("parity", f"K4, K5 edges: {cases} cases (n 1/31/33/4097, k "
                  "4/36/100/256/1024, cw 1/even/odd, corrupted rows, word "
                  "offsets 0 and 1): bit-equal")
    k, n, cw = 256, 700, 45
    rng = np.random.default_rng(21)
    for name, fn, fits in (
            ("K4", ops.decode, lambda s_: qc.decode_smem(s_, 3)
             <= qc.CTA_SMEM),
            ("K5", ops.decode_block_async,
             lambda s_: qc.prefetch_tile_rows(s_, 3, cw) > 0)):
        most = max(s_ for s_ in range(1, 64) if fits(s_))
        many = [lut.build_tables(rng.integers(1, 1000, 256).astype(
            np.float64), (schemes.TABLE1, schemes.TABLE2)[i % 2])
            for i in range(most + 1)]
        _, w, sid = _edge_words(n, k, cw, many[:most], 22)
        err[name] = max(err[name], require_equal(
            f"{name} with {most} stacked schemes",
            [fn(w, many[:most], k, scheme_ids=sid)],
            [ref.decode_ref(w, many[:most], sid, k)]))
        try:
            fn(w, many, k, scheme_ids=sid)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{name} took {most + 1} stacked schemes")
        log("parity", f"{name} with {most} stacked 3-bit schemes at {cw} "
                      f"words: bit-equal; {most + 1} refused")
    k, n = 1024, 70
    counts = np.bincount(_skewed_symbols(64, k, 5).cpu().numpy().reshape(-1),
                         minlength=256) + 1.0
    for pb in (4, 5, 6, 8):
        a = 1 << pb
        wide = [lut.build_tables(counts, schemes.QLCScheme(
                    areas=((256 // a, 8),) * a, prefix_bits=pb)),
                lut.build_tables(counts, schemes.QLCScheme(
                    areas=((1, 0),) * (a - 1) + ((257 - a, 8),),
                    prefix_bits=pb))][:1 if pb == 8 else 2]
        sym = _skewed_symbols(n, k, 23)
        nb = max(int(codec.encode_chunk_bits(sym, t.enc_len).float()
                     .median()) for t in wide)
        for cw in (codec.worst_case_words(k, pb + 8), max(1, nb // 32)):
            _, w, sid = _edge_words(n, k, cw, wide, 23)
            want = ref.decode_ref(w, wide, sid, k)
            for name, fn in entries:
                err[name] = max(err[name], require_equal(
                    f"{name} prefix {pb} cw {cw}",
                    [fn(w, wide, k, scheme_ids=sid)], [want]))
        log("parity", f"K4, K5 with {pb + 8}-bit codes ({pb}-bit prefix) "
                      f"[{n}, {k}] at worst-case and overrun slots, "
                      "corrupted rows: bit-equal")
    return err


#: K3's shapes beyond the parity and KV ones: (label, chunks, symbols
#: per chunk, slot words). block128: the KV plane of one 128-token block,
#: the reference's default --kv-block, at phi3-mini-3.8b's widths;
#: channel: the CommConfig default that Channel.compress_codes uses.
K3_SHAPES = (("block128", 98304, 256, 45), ("channel", 32768, 1024, 240))


def _k3_long_tables(base, longest: int, seed: int):
    """``base`` with hand-made encoder LUTs: random lengths in [0,
    longest] (0, 24 and ``longest`` among them), random codes below
    2^length. What K3 encodes; not a prefix code."""
    import dataclasses
    rng = np.random.default_rng(seed)
    length = rng.integers(0, longest + 1, 256)
    length[:3] = (0, min(24, longest), longest)
    code = (rng.integers(0, 1 << 32, 256, dtype=np.uint64)
            & ((np.uint64(1) << length.astype(np.uint64)) - np.uint64(1)))
    return dataclasses.replace(base, enc_code=code.astype(np.uint32),
                               enc_len=length.astype(np.uint32))


def phase_k3_edge(ops, ref, lut, schemes, codec):
    """K3 against the plain encoder, bit for bit, at the edges of its
    geometry: k in {32, 256, 1024, 4096}; slots at the worst case, the
    longest chunk's, the median chunk's (half the chunks over capacity)
    and 1 word; n in {1, 7} and one below and one above a full grid of
    warps; symbols at byte offsets 1-15 of their buffer; two tables back
    to back; hand-made tables of codes up to 16, 17, 24 and 32 bits (the
    two-codes-per-step pack and the one-code step)."""
    from repro_torch.kernels import qlc_codes as qc
    counts = np.bincount(_skewed_symbols(64, 256, 1).cpu().numpy()
                         .reshape(-1), minlength=256).astype(np.float64) + 1
    tl = [lut.build_tables(counts, schemes.TABLE1),
          lut.build_tables(counts[::-1].copy(), schemes.TABLE2)]
    err, cases = 0.0, 0

    def check(sym, t, cap, what):
        nonlocal err, cases
        err = max(err, require_equal(f"K3 {what}", ops.encode(sym, t, cap),
                                     ref.encode_ref(sym, t, cap)))
        cases += 1

    def caps_of(t, k):
        nb = codec.encode_chunk_bits(_skewed_symbols(64, k, 2), t.enc_len)
        return sorted({codec.worst_case_words(k, int(t.enc_len.max())),
                       max(1, -(-int(nb.max()) // 32)),
                       max(1, int(nb.float().median()) // 32), 1})

    for k in (32, 256, 1024, 4096):
        caps = caps_of(tl[0], k)
        for cap in caps:
            full = qc.encode_grid_chunks(k, cap, int(tl[0].enc_len.max()))
            for n in (1, 7, full - 1, full + 1):
                check(_skewed_symbols(n, k, n), tl[0], cap,
                      f"k {k} cap {cap} n {n}")
        sym = _skewed_symbols(7, k, 3)
        for offset in range(1, 16):
            buf = torch.zeros(sym.numel() + offset, dtype=torch.uint8,
                              device=DEVICE)
            buf[offset:] = sym.reshape(-1)
            for cap in caps:
                check(buf[offset:].view(sym.shape), tl[0], cap,
                      f"k {k} offset {offset} cap {cap}")
        for t in tl:
            for cap in caps:
                check(sym, t, cap, f"k {k} tables back to back cap {cap}")
        for longest in (16, 17, 24, 32):
            t = _k3_long_tables(tl[0], longest, longest)
            for cap in caps_of(t, k):
                n = qc.encode_grid_chunks(k, cap, longest) + 1
                check(_skewed_symbols(n, k, 5), t, cap,
                      f"k {k} codes of up to {longest} bits cap {cap}")
    log("parity", f"K3 edges: {cases} cases (k 32/256/1024/4096; worst, "
                  "longest-chunk, median and 1-word slots; n 1/7/full grid "
                  "-1/+1; byte offsets 1-15; two tables; codes of up to "
                  "16/17/24/32 bits): bit-equal")
    return err


def phase_k3_shapes(ops, ref, lut, schemes, flush):
    """K3 at ``K3_SHAPES`` on skewed chunks (every fourth uniform, so
    those overrun a tight slot) under one TABLE1 scheme calibrated on
    them: bit-equal to the plain version, then timed through ``ops``,
    alone and plain beside its HBM bound."""
    out = {}
    for label, n, k, cap in K3_SHAPES:
        sym = _skewed_symbols(n, k, 0)
        counts = np.bincount(sym.cpu().numpy().reshape(-1),
                             minlength=256).astype(np.float64) + 1
        t = lut.build_tables(counts, schemes.TABLE1)
        r = {"err": require_equal(f"K3 {label}", ops.encode(sym, t, cap),
                                  ref.encode_ref(sym, t, cap)),
             "shape": [n, k], "cap": cap,
             "ms": time_ms(lambda: ops.encode(sym, t, cap), 20, flush),
             "kernel_ms": time_ms(bare_k3(sym, t, cap), 20, flush,
                                  alone=True),
             "plain_ms": time_ms(lambda: ref.encode_ref(sym, t, cap), 3,
                                 flush),
             "bound_ms": bound_ms("encode", sym, t, cap)}
        log("parity", f"K3 {label} [{n}, {k}] cap {cap}: bit-equal; "
                      f"{r['ms']:.4f} ms (kernel alone "
                      f"{r['kernel_ms']:.4f}), plain {r['plain_ms']:.2f} "
                      f"ms, HBM bound {r['bound_ms']:.4f} ms")
        out[label] = r
        del sym
    return out


def phase_sync_free(ops, lut, schemes, codec):
    """After one warm call, the decode entries (K4, K5, K2 and its
    accumulate form) and the encode entries (K3, K1) run with
    device-resident scheme ids under torch's sync debug mode "error":
    none makes a synchronizing call. Host ids out of range still raise
    ValueError. The train steps' part (a compressed and a baseline step
    under the same mode) runs in the one-rank world the train phases
    set up: :func:`phase_sync_free_train`."""
    counts = np.bincount(_skewed_symbols(64, 256, 1).cpu().numpy()
                         .reshape(-1), minlength=256).astype(np.float64) + 1
    tl = [lut.build_tables(counts, schemes.TABLE1),
          lut.build_tables(counts[::-1].copy(), schemes.TABLE2)]
    n, k = 96, 256
    sym = _skewed_symbols(n, k, 9)
    sid = (torch.arange(n, device=DEVICE) % 2).to(torch.int32)
    words = ops.encode(sym, tl[0], 89)[0]
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (n, 1024)).astype(np.float32)).to(DEVICE)
    wv, _, sc = ops.quantize_encode(x, tl[0], codec.worst_case_words(1024))
    acc = torch.zeros((n, 1024), device=DEVICE)
    calls = {
        "decode": lambda: ops.decode(words, tl, k, scheme_ids=sid),
        "decode_block_async": lambda: ops.decode_block_async(
            words, tl, k, scheme_ids=sid),
        "decode_dequantize": lambda: ops.decode_dequantize(
            wv, sc, tl, 1024, scheme_ids=sid),
        "decode_dequantize_accumulate": lambda:
            ops.decode_dequantize_accumulate(acc, wv, sc, tl, 1024,
                                             scheme_ids=sid),
        "encode": lambda: ops.encode(sym, tl[0], 89),
        "quantize_encode": lambda: ops.quantize_encode(x, tl[0], 353)}
    warm = {name: call() for name, call in calls.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = {name: call() for name, call in calls.items()}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for name in calls:
        a, b = warm[name], again[name]
        require_equal(f"{name} warm vs under sync debug",
                      a if isinstance(a, tuple) else [a],
                      b if isinstance(b, tuple) else [b])
    try:
        ops.decode(words, tl, k, scheme_ids=[0, 2] * (n // 2))
    except ValueError:
        pass
    else:
        raise AssertionError("host scheme ids out of range were taken")
    log("parity", f"no synchronizing call after one warm call, device "
                  f"scheme ids ({', '.join(calls)}); host ids out of range "
                  "raise ValueError")


def phase_hist_parity(ops, ref, flush):
    """K6 against its plain version and torch.bincount: skewed [4096,
    1024] symbols covering all 256 values, a ragged length at an odd
    offset, one symbol everywhere. Times K6, the plain version and
    torch.bincount at [4096, 1024]."""
    rng = np.random.default_rng(6)
    sym = np.minimum(rng.geometric(0.05, (4096, 1024)), 255).astype(np.uint8)
    sym[0, :256] = np.arange(256)
    x = torch.from_numpy(sym).cuda()
    buf = torch.from_numpy(rng.integers(0, 256, 1 << 20, dtype=np.uint8)
                           ).cuda()
    cases = {"skewed [4096, 1024]": x,
             "ragged 1000003 at offset 3": buf[3:3 + 1000003],
             "one symbol x 16777216": torch.full((1 << 24,), 0x3C,
                                                 dtype=torch.uint8,
                                                 device="cuda")}
    err = 0.0
    for what, t in cases.items():
        got = ops.histogram(t)
        lib = torch.bincount(t.reshape(-1), minlength=256).to(torch.int32)
        err = max(err, require_equal(f"K6 {what}", [got],
                                     [ref.histogram256_ref(t)]),
                  require_equal(f"K6 {what} vs torch.bincount", [got],
                                [lib]))
        log("parity", f"K6 {what}: bit-equal to plain and torch.bincount")
    flat = x.reshape(-1)
    res = {"err": err, "shape": list(x.shape),
           "ms": time_ms(lambda: ops.histogram(x), 20, flush),
           "kernel_ms": time_ms(bare_k6(x), 20, flush, alone=True),
           "plain_ms": time_ms(lambda: ref.histogram256_ref(x), 3, flush),
           "library_ms": time_ms(
               lambda: torch.bincount(flat, minlength=256), 20, flush),
           "bound_ms": bound_ms("histogram", x)}
    log("parity", f"K6 [4096, 1024]: {res['ms']:.4f} ms (kernel alone "
                  f"{res['kernel_ms']:.4f}), plain "
                  f"{res['plain_ms']:.2f} ms, torch.bincount "
                  f"{res['library_ms']:.4f} ms, HBM bound "
                  f"{res['bound_ms']:.4f} ms")
    return res


def phase_small(serve_mod, reduced, get_config):
    """The wire and opened params bit-equal between the card (kernels)
    and the CPU (plain versions); decode-step logits within f32
    summation-order tolerance."""
    from repro_torch.models import decode_step, init_decode_states
    from repro_torch.models.transformer import tree_leaves, tree_map
    cfg = reduced(get_config("phi3-mini-3.8b"), d_model=128, d_ff=512,
                  dtype="float32")
    gen = torch.Generator(device="cpu").manual_seed(3)
    from repro_torch.models import init_params
    p_cpu = init_params(cfg, gen, "cpu")
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    kw = dict(batch=2, requests=2, prompt_len=4, new_tokens=2, wire="qlc")
    r_cpu = serve_mod.serve(cfg, device="cpu", params=p_cpu, **kw)
    r_gpu = serve_mod.serve(cfg, device="cuda", params=p_gpu, **kw)
    for what in ("wired", "params"):
        for a, b in zip(tree_leaves(r_gpu[what]), tree_leaves(r_cpu[what])):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"small: {what} differ card vs CPU")
    if r_gpu["wire_codec"].meta != r_cpu["wire_codec"].meta:
        raise AssertionError("small: wire geometry differs card vs CPU")
    tok = torch.tensor([[5], [9]], dtype=torch.int32)
    pos = torch.zeros((2, 1), dtype=torch.int32)
    lg_c, _ = decode_step(r_cpu["params"], cfg, tok,
                          init_decode_states(cfg, 2, 8, "cpu"), pos)
    lg_g, _ = decode_step(r_gpu["params"], cfg, tok.cuda(),
                          init_decode_states(cfg, 2, 8, "cuda"), pos.cuda())
    torch.testing.assert_close(lg_g.cpu(), lg_c, rtol=1e-4, atol=1e-5)
    log("small", f"reduced phi3 (d_model 128, f32): "
                 f"{len(r_gpu['wire_codec'].meta)} wired leaves and opened "
                 "params bit-equal card vs CPU; logits max abs diff "
                 f"{float((lg_g.cpu() - lg_c).abs().max()):.3e}")


def _node(tree, key: str):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def check_main_path(ops, ref, wc, wired, opened, params):
    """K1 and K2 against their plain versions, bit for bit, at the shapes
    the main path gave them. K2: the first and last 4096 chunk rows of
    every wired leaf, plain decode of its wire against the opened leaf
    (K2's output on the served run). K1: the whole stacked ``w_in`` leaf
    at worst-case slots with its histogram (calibration's shape), plain
    in row blocks; the wire must be those words cut to the leaf's
    capacity and those scales in bf16. Returns the max abs errors."""
    rows, k = 4096, 1024
    k2_err = 0.0
    for key, m in wc.meta.items():
        if m.n_symbols != m.n_chunks * k:
            raise AssertionError(f"{key}: padded leaf, rows do not align")
        node, tables = _node(wired, key), wc.registry.by_id(m.scheme_id).tables
        w = node["words"].reshape(-1, m.capacity_words)
        s = node["scales"].float().reshape(-1, k // 32)
        got = _node(opened, key).reshape(-1, k)
        for r0 in sorted({0, max(0, w.shape[0] - rows)}):
            sl = slice(r0, r0 + rows)
            want = ref.decode_dequantize_ref(w[sl], s[sl], [tables], 0, k,
                                             out_dtype=got.dtype)
            k2_err = max(k2_err, require_equal(
                f"K2 main path {key} rows {r0}:{r0 + rows}", [got[sl]],
                [want]))
    log("slice", f"K2 on the main path: {len(wc.meta)} wired leaves, first "
                 f"and last {rows} chunk rows each, opened == plain decode, "
                 "bit-equal")

    key = "groups/l0/ffn/w_in"
    m = wc.meta[key]
    tables = wc.registry.by_id(m.scheme_id).tables
    xw = _node(params, key).reshape(-1, k)
    node = _node(wired, key)
    ww = node["words"].reshape(-1, m.capacity_words)
    ws = node["scales"].reshape(-1, k // 32)
    words, nb, sc, hist = ops.quantize_encode(xw, tables, 353,
                                              emit_hist=True)
    hist_plain = torch.zeros(256, dtype=torch.int64, device=xw.device)
    k1_err = 0.0
    block = 65536
    for r0 in range(0, xw.shape[0], block):
        sl = slice(r0, r0 + block)
        pw, pn, ps, ph = ref.quantize_encode_ref(xw[sl], tables, 353,
                                                 emit_hist=True)
        k1_err = max(k1_err, require_equal(
            f"K1 main path w_in rows {r0}:{r0 + block}",
            [words[sl], nb[sl], sc[sl]], [pw, pn, ps]))
        require_equal(f"wire of w_in rows {r0}:{r0 + block}",
                      [ww[sl], ws[sl]],
                      [pw[:, :m.capacity_words].contiguous(),
                       ps.to(torch.bfloat16)])
        hist_plain += ph.long()
    k1_err = max(k1_err, require_equal("K1 main path w_in hist", [hist],
                                       [hist_plain.to(torch.int32)]))
    log("slice", f"K1 on the main path: w_in {list(xw.shape)} at 353-word "
                 "slots with hist, words/nbits/scales/hist bit-equal to the "
                 f"plain version; wire = words cut to {m.capacity_words} "
                 "words + bf16 scales")
    return k1_err, k2_err


def phase_slice(qf, serve_mod, e4m3, ref, flush):
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_decode_states, \
        init_params
    from repro_torch.serving import compress_params_for_serving
    cfg = get_config("phi3-mini-3.8b")
    log("slice", f"{cfg.name}: {cfg.num_layers} layers, d_model "
                 f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
                 f"compute {cfg.dtype}, params {cfg.param_dtype}; no cut")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log("slice", f"init {n_params} params on the card in "
                 f"{time.perf_counter() - t0:.2f} s")

    # Warm-up: one dense decode step initializes cuBLAS, so the served
    # run's ms/token is steady state rather than first-call set-up.
    tok = torch.tensor([[11], [22], [33], [44]], dtype=torch.int32,
                       device="cuda")
    pos = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    decode_step(params, cfg, tok, init_decode_states(cfg, 4, 8, "cuda"), pos)
    torch.cuda.synchronize()

    qf.fused_encode.launches = 0
    qf.fused_decode.launches = 0
    res = serve_mod.serve(cfg, batch=4, requests=6, prompt_len=16,
                          new_tokens=16, wire="qlc", device="cuda",
                          params=params)
    launches = {"K1": qf.fused_encode.launches,
                "K2": qf.fused_decode.launches}
    outs, st = res["outs"], res["stats"]
    if not all(s.state == "finished" and len(s.tokens) == 16 for s in outs):
        raise AssertionError([(s.request_id, s.state) for s in outs])
    for kname, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{kname} was not launched on the main path")
    wc, wired = res["wire_codec"], res["wired"]
    wire_b = sym = 0
    for key, m in wc.meta.items():
        node = _node(wired, key)
        wire_b += nbytes(node["words"], node["scales"])
        sym += m.n_symbols * node["words"].shape[0]
    log("slice", f"calibrate {res['calibrate_s'] * 1e3:.1f} ms, compress "
                 f"{res['compress_s'] * 1e3:.1f} ms, open "
                 f"{res['open_s'] * 1e3:.1f} ms; {len(wc.meta)} leaves, "
                 f"{sym} symbols, wire {wire_b} B = "
                 f"{wire_b / sym:.4f} B/symbol (words + bf16 scales)")
    log("slice", f"served {len(outs)} requests: "
                 f"{st['ms_per_token_prefill']:.3f} ms/token prefill, "
                 f"{st['ms_per_token_decode']:.3f} ms/token decode; "
                 f"launches K1 {launches['K1']}, K2 {launches['K2']}")

    # A sampled leaf: opened == plain dequantize(plain quantize), with the
    # scales through bf16 as the wire stores them.
    opened = res["params"]
    for g in (0, cfg.num_layers - 1):
        leaf = params["groups"]["l0"]["ffn"]["w_in"][g]
        codes, scales = e4m3.quantize_block32(leaf.reshape(1, -1))
        want = e4m3.dequantize_block32(
            codes, scales.to(torch.bfloat16).float()).reshape(leaf.shape)
        if not torch.equal(opened["groups"]["l0"]["ffn"]["w_in"][g], want):
            raise AssertionError(f"opened w_in[{g}] != plain round trip")
        del codes, scales, want
    log("slice", "sampled leaf w_in groups 0 and 31: opened == plain "
                 "dequantize(quantize), bit-equal")
    from repro_torch.kernels import ops
    k1_err, k2_err = check_main_path(ops, ref, wc, wired, opened, params)

    profile_step(decode_step, opened, cfg,
                 init_decode_states(cfg, 4, 40, "cuda"), tok, pos)

    # decode_step opening each group's wire inside the layer loop.
    wired_g, wc_g = compress_params_for_serving(params["groups"],
                                                wc.registry)
    lg_w, _ = decode_step({**params, "groups": wired_g}, cfg, tok,
                          init_decode_states(cfg, 4, 8, "cuda"), pos,
                          weight_codec=wc_g)
    lg_o, _ = decode_step(opened, cfg, tok,
                          init_decode_states(cfg, 4, 8, "cuda"), pos)
    if not torch.isfinite(lg_o).all() or not torch.equal(lg_w, lg_o):
        raise AssertionError("decode_step(weight_codec) != opened step")
    log("slice", f"decode_step(weight_codec=...) == opened-params step, "
                 f"logits {tuple(lg_o.shape)} finite")
    del wired_g, lg_w, lg_o

    # K1 and K2 at the main path's largest shape (the stacked w_in leaf).
    key = "groups/l0/ffn/w_in"
    xw = _node(params, key).reshape(-1, 1024)
    m = wc.meta[key]
    node = _node(wired, key)
    tables = wc.registry.by_id(m.scheme_id).tables
    enc = lambda: ops.quantize_encode(xw, tables, 353)     # noqa: E731
    words, nb, sc = enc()
    main = {"K1": {"shape": list(xw.shape), "ms": time_ms(enc, 3, flush),
                   "kernel_ms": time_ms(bare_k1(xw, tables, 353), 3, flush,
                                        alone=True),
                   "bound_ms": bound_ms("quantize_encode", xw, tables, 353),
                   "max_abs_err": k1_err}}
    del words, nb, sc
    w = node["words"].reshape(-1, m.capacity_words)
    s = node["scales"].float().reshape(-1, 32)
    dec = lambda: ops.decode_dequantize(w, s, tables, 1024)  # noqa: E731
    main["K2"] = {"shape": list(w.shape), "cap": m.capacity_words,
                  "ms": time_ms(dec, 3, flush),
                  "kernel_ms": time_ms(bare_k2(w, s, tables, 1024), 3,
                                       flush, alone=True),
                  "bound_ms": bound_ms("decode_dequantize", w, s, tables,
                                       1024),
                  "max_abs_err": k2_err}
    for kname, v in main.items():
        log("slice", f"{kname} at the main path's w_in shape {v['shape']}: "
                     f"{v['ms']:.3f} ms (kernel alone {v['kernel_ms']:.3f}),"
                     f" HBM bound {v['bound_ms']:.3f} ms")
    log("slice", f"peak device memory "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, main, opened, cfg


def check_kv_path(ops, ref, cfg, opened, prompt, flush, dev=DEVICE,
                  phase="kv", layer="l0", block=16, chunk=1):
    """K3-K6 at the KV path's own shapes and data: request 0's prompt
    prefilled on the opened params (``chunk`` tokens a step), the first
    ``block``-token (default 16) block of layer
    slot ``layer`` (an attention slot's K/V: 2 byte planes of chunks of
    256, 12,288 chunks for phi3-mini; a recurrent slot's whole state
    snapshot: 4 f32 byte planes, zero-padded to whole chunks as the
    cache pads them), codecs calibrated as the engine does. K6 on each
    byte plane of the slot's calibration section, against its plain
    version and np.bincount; K3/K4/K5 on the block's planes at the plan's
    slot caps, each against its plain version; the block through the
    host path (K3 + K4) and the device path (K3 + K5) back to its
    tensors; the device-framed words equal to the host container.
    Returns each kernel's error and timings: K3-K5 on the coded plane
    with the smallest slot, K6 on the first calibration plane."""
    from repro_torch.comm.calibrate import byte_planes
    from repro_torch.comm.compressed import pad_to_multiple
    from repro_torch.comm.container import stream_headers
    from repro_torch.core import CodecRegistry
    from repro_torch.models import attention as attn
    from repro_torch.models import init_decode_states, ssm
    from repro_torch.serving import (KVCacheSpec, PagedKVCache,
                                     calibrate_cache, prefill)
    from repro_torch.serving.kv_cache import calibration_arrays
    p = torch.from_numpy(np.asarray(prompt)[None, :]).to(dev)
    _, st = prefill(opened, cfg, p, init_decode_states(
        cfg, 1, max(72, p.shape[1] + 8), dev), chunk=chunk)
    reg = CodecRegistry()
    spec = KVCacheSpec(block_tokens=block, exact_capacity=False)
    calibrate_cache(reg, cfg, st, p.shape[1], spec)
    err = {"K3": 0.0, "K4": 0.0, "K5": 0.0, "K6": 0.0}
    li = int(layer[1:])
    base = spec.layer_codec(li)
    hist = [plane.reshape(-1) for plane in byte_planes(
        calibration_arrays(cfg, st, p.shape[1])[layer]).values()]
    for i, h in enumerate(hist):
        got = ops.histogram(h)
        want = np.bincount(h.cpu().numpy(), minlength=256).astype(np.int32)
        err["K6"] = max(err["K6"], require_equal(
            f"K6 calibration plane {i}", [got], [ref.histogram256_ref(h)]),
            require_equal(f"K6 calibration plane {i} vs np.bincount",
                          [got.cpu()], [torch.from_numpy(want)]))
    log(phase, f"K6 on layer slot {li}'s calibration section "
               f"({len(hist)} byte planes of {hist[0].numel()} symbols): "
               "bit-equal to plain and np.bincount")
    if cfg.layer_kinds()[li] == "attention":
        kv, what = attn.kv_block_slice(st[layer], 0, block), "K/V"
    else:
        kv, what = list(ssm.state_snapshot(st[layer])), "state snapshot"
    coded = None
    for (isz, j), plane in byte_planes(kv).items():
        entry = reg[f"{base}/w{isz}b{j}"]
        sym = pad_to_multiple(plane, 256)[0].reshape(-1, 256)
        e, (w, s) = codes_checks(ops, ref, sym, entry.tables,
                                 (entry.plan.capacity_words,))
        for name in e:
            err[name] = max(err[name], e[name])
        log(phase, f"plane w{isz}b{j} {list(sym.shape)} at the plan's "
                   f"{entry.plan.capacity_words}-word slots, "
                   f"{entry.plan.expected_bits_per_symbol:.3f} expected "
                   "bits/symbol: K3, K4, K5 bit-equal to plain")
        if coded is None or entry.plan.capacity_words < coded[3]:
            coded = (sym, entry.tables, (w, s), entry.plan.capacity_words)
    cache = PagedKVCache(spec, cfg, reg, device=dev)
    host = cache.encode_block_arrays(base, layer, kv, start=0, tokens=block)
    framed = cache.encode_block_device(base, layer, kv, start=0,
                                       tokens=block)
    if framed is None or not np.array_equal(
            host.container, framed.words.cpu().numpy().view(np.uint32)):
        raise AssertionError(f"{phase}: device framing != host container")
    for route, got in (("host path (K3+K4)",
                        cache.decode_block_arrays(host)),
                       ("device path (K3+K5)",
                        cache.decode_block_device(framed.plan,
                                                  framed.words)[0])):
        if not all(torch.equal(a, b) for a, b in zip(got, kv)):
            raise AssertionError(f"{phase}: block through the {route} "
                                 f"!= {what}")
    sections = [(h.coded, h.capacity_words)
                for _, h in stream_headers(host.container)]
    log(phase, f"block [0, {block}) of request 0, layer slot {li}: "
               f"{host.wire_bytes} B container for {host.dense_bytes} B of "
               f"{what} (sections coded/cap {sections}); host path and "
               f"device path give back the {what} bit for bit, "
               "device-framed words == host container")
    sym, tables, (w, s), cap = coded
    reps = 10
    times = time_codes(ops, ref, sym, tables, cap, w, s, flush, reps=reps)
    h = hist[0]
    times["K6"] = {
        "shape": [h.numel()],
        "ms": time_ms(lambda: ops.histogram(h), reps, flush),
        "kernel_ms": time_ms(bare_k6(h), reps, flush, alone=True),
        "plain_ms": time_ms(lambda: ref.histogram256_ref(h), 3, flush),
        "library_ms": time_ms(lambda: torch.bincount(h, minlength=256),
                              reps, flush),
        "bound_ms": bound_ms("histogram", h)}
    for name, r in times.items():
        r["err"] = err[name]
        log(phase, f"{name} at the KV shape {r['shape']}"
                   + (f" cap {r['cap']}" if "cap" in r else "")
                   + f": {r['ms']:.4f} ms (kernel alone "
                   f"{r['kernel_ms']:.4f}), plain {r['plain_ms']:.2f} ms, "
                   f"HBM bound {r['bound_ms']:.4f} ms")
    return times


def phase_kv(qf, qc, serve_mod, cfg, opened, ops, ref, flush):
    """The paged compressed KV cache on the opened params, in turns:
    sync, async, async, sync (two versions compared inside one call);
    each run's kernel launches counted from zero."""
    from repro_torch.kernels import histogram256 as h6
    counters = {"K1": qf.fused_encode, "K2": qf.fused_decode,
                "K3": qc.encode, "K4": qc.decode, "K5": qc.prefetch_decode,
                "K6": h6.histogram256}
    runs = []
    prompt0 = None
    for paging in ("sync", "async", "async", "sync"):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = serve_mod.serve(cfg, batch=4, requests=6, prompt_len=32,
                              new_tokens=32, kv_cache="qlc", kv_block=16,
                              kv_paging=paging, device=DEVICE, params=opened)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        outs, st = res["outs"], res["stats"]
        if not all(o.state == "finished" and len(o.tokens) == 32
                   for o in outs):
            raise AssertionError([(o.request_id, o.state, o.error)
                                  for o in outs])
        need = ("K3", "K4", "K6") if paging == "sync" \
            else ("K3", "K5", "K6")
        for kname in need:
            if launches[kname] <= 0:
                raise AssertionError(f"{kname} was not launched on the "
                                     f"{paging} KV path")
        ps = st["pool"]
        line = (f"{paging}: 6 requests x 32 tokens finished, request 0 == "
                f"dense solo run; {st['ms_per_token_prefill']:.3f} ms/token "
                f"prefill, {st['ms_per_token_decode']:.3f} ms/token decode, "
                f"{wall:.2f} s with the solo run; {ps['unique_blocks']} "
                f"blocks, {ps['peak_referenced_bytes']} compressed B pinned "
                f"vs {st['peak_dense_logical_bytes']} dense B "
                f"({ps['peak_referenced_bytes'] / st['peak_dense_logical_bytes']:.4f}); "
                f"launches {launches}")
        if paging == "async":
            a, pf = st["async"], st["prefetch"]
            line += (f"; {a['windows']} windows, {a['h2d_per_window']:.1f} "
                     f"up / {a['d2h_per_window']:.1f} down per window; "
                     f"prefetch {pf['hits']}/{pf['scheduled']} hits, "
                     f"{pf['stalled']} stalled, {pf['misses']} misses, "
                     f"stall {pf['stall_ms']:.3f} ms, hidden "
                     f"{pf['hidden_ms']:.3f} ms")
            if pf["hits"] <= 0 or pf["scheduled"] <= 0:
                raise AssertionError("async: no prefetch was scheduled")
        log("kv", line)
        runs.append((paging, launches))
        prompt0 = res["prompts"][0]
    times = check_kv_path(ops, ref, cfg, opened, prompt0, flush)
    return runs, times


def phase_kv_monitor(qc, h6, serve_mod, cfg, opened, sync_k6):
    """The sync-paging KV run of phase_kv with a ``TrafficMonitor`` on
    the paged cache (``serve(..., kv_monitor=True)``): every coded or raw
    section it encodes is counted by K6 on the card, one launch each on
    top of the run's calibration (``sync_k6``, the same run's K6 launches
    without the monitor). Per KV byte plane: measured against planned
    bits/symbol over the layers' codecs. Then one section's counts (layer
    0 of request 0's first block, each byte plane, encoded by a cache
    with a fresh monitor) against a host ``np.bincount``."""
    from repro_torch.adaptive import TrafficMonitor
    from repro_torch.comm.calibrate import byte_planes
    from repro_torch.core import CodecRegistry
    from repro_torch.models import attention as attn
    from repro_torch.models import init_decode_states
    from repro_torch.serving import (KVCacheSpec, PagedKVCache,
                                     calibrate_cache, prefill)
    counters = {"K3": qc.encode, "K4": qc.decode, "K6": h6.histogram256}
    for fn in counters.values():
        fn.launches = 0
    res = serve_mod.serve(cfg, batch=4, requests=6, prompt_len=32,
                          new_tokens=32, kv_cache="qlc", kv_block=16,
                          kv_paging="sync", device=DEVICE, params=opened,
                          kv_monitor=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    if not all(o.state == "finished" and len(o.tokens) == 32
               for o in res["outs"]):
        raise AssertionError("kv monitor run: a request did not finish")
    rows = res["kv_monitor"].snapshot()
    sections = sum(r["events"] for r in rows)
    if not rows or launches["K6"] != sync_k6 + sections:
        raise AssertionError(f"kv monitor: {launches['K6']} K6 launches, "
                             f"want {sync_k6} (calibration) + {sections} "
                             "(one per observed section)")
    for kname in ("K3", "K4"):
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} was not launched on the "
                                 "monitored KV path")
    planes = {}
    for r in rows:
        planes.setdefault(r["name"].rsplit("/", 1)[-1], []).append(r)
    summary = {}
    for plane, rs in sorted(planes.items()):
        m = [r["measured_bits"] for r in rs]
        e = [r["expected_bits"] for r in rs]
        x = [a - b for a, b in zip(m, e)]
        summary[plane] = {"codecs": len(rs), "measured": float(np.mean(m)),
                          "planned": float(np.mean(e)),
                          "excess_min": min(x), "excess_max": max(x),
                          "entropy": float(np.mean([r["entropy_bits"]
                                                    for r in rs])),
                          "escape_rate": max(r["escape_rate"] for r in rs),
                          "overflow_rate": max(r["overflow_rate"]
                                               for r in rs)}
        log("adapt", f"kv monitor, plane {plane}: {len(rs)} codecs, "
                     f"measured {summary[plane]['measured']:.4f} vs planned "
                     f"{summary[plane]['planned']:.4f} bits/symbol (mean; "
                     f"excess {min(x):+.4f} to {max(x):+.4f}), entropy "
                     f"{summary[plane]['entropy']:.4f}, escape rate <= "
                     f"{summary[plane]['escape_rate']:.4f}, overflow rate "
                     f"<= {summary[plane]['overflow_rate']:.4f}")
    log("adapt", f"kv monitor run (sync, 6 requests x 32 tokens, all "
                 f"finished): {len(rows)} codecs observed, {sections} "
                 f"sections; launches {launches} (K6 = {sync_k6} calibration "
                 f"+ {sections} monitored sections)")

    p = torch.from_numpy(np.asarray(res["prompts"][0])[None, :]).to(DEVICE)
    _, st = prefill(opened, cfg, p, init_decode_states(cfg, 1, 72, DEVICE))
    reg = CodecRegistry()
    spec = KVCacheSpec(block_tokens=16)
    calibrate_cache(reg, cfg, st, p.shape[1], spec)
    mon = TrafficMonitor(reg)
    cache = PagedKVCache(spec, cfg, reg, device=DEVICE, monitor=mon)
    kv = attn.kv_block_slice(st["l0"], 0, 16)
    h6.histogram256.launches = 0
    cache.encode_block_arrays("kv/layer0", "l0", kv, start=0, tokens=16)
    by_plane = byte_planes(kv)
    if h6.histogram256.launches != len(by_plane):
        raise AssertionError(f"kv monitor: {h6.histogram256.launches} K6 "
                             f"launches for {len(by_plane)} sections")
    for (isz, j), plane in by_plane.items():
        t = mon.traffic(f"kv/layer0/w{isz}b{j}")
        host = np.bincount(plane.reshape(-1).cpu().numpy(), minlength=256)
        if t is None or t.events != 1 or not np.array_equal(
                t.counts, host.astype(np.float64)):
            raise AssertionError(f"kv monitor: K6's counts of plane "
                                 f"w{isz}b{j} differ from np.bincount")
    log("adapt", f"kv monitor: layer 0 of request 0's first block, "
                 f"{len(by_plane)} byte planes of {plane.numel()} symbols: "
                 "the monitor's K6 counts == host np.bincount")
    return {"launches": launches, "sections": sections, "planes": summary}


def _flat_params(params) -> torch.Tensor:
    from repro_torch.models.transformer import pytree_leaves
    return torch.cat([p.reshape(-1) for p in pytree_leaves(params)])


def phase_train_small(reduced, get_config, dev="cuda"):
    """Reduced phi3 (d_model 128, 2 layers, f32): 2 compressed steps on
    ``dev`` and on the CPU from the same state, registry and batches
    (losses to rtol 1e-4: f32 summation order differs); then one CPU
    gradient through the wire on both: words, scales, flags, pool, the
    reduced segment and the gathered parameters bit-equal."""
    from repro_torch.launch.train import calibrate_registry, train
    from repro_torch.models import init_params
    from repro_torch.models.transformer import pytree_leaves, tree_map
    from repro_torch.training import OptConfig, init_compressed_opt_state
    from repro_torch.training.train_step import _flatten_local
    from repro_torch.data import DataConfig, SyntheticDataset
    import torch.distributed as dist
    cfg = reduced(get_config("phi3-mini-3.8b"), d_model=128,
                  dtype="float32")
    p_cpu = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    data = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=32, global_batch=4))
    reg = calibrate_registry(cfg, p_cpu, data.batch_at(0), dist.group.WORLD)
    kw = dict(comm="qlc", steps=2, seq_len=32, global_batch=4, registry=reg)
    r_cpu = train(cfg, device="cpu", params=p_cpu, **kw)
    r_dev = train(cfg, device=dev,
                  params=tree_map(lambda t: t.to(dev), p_cpu), **kw)
    lc = [h["loss"] for h in r_cpu["history"]]
    ld = [h["loss"] for h in r_dev["history"]]
    np.testing.assert_allclose(ld, lc, rtol=1e-4)
    if not all(h["ok"] for h in r_cpu["history"] + r_dev["history"]):
        raise AssertionError("small: a step's wire overflowed")

    step_c, step_d = r_cpu["step"], r_dev["step"]
    _, grads = step_c.stage1(p_cpu, data.batch_at(0))
    n = step_c.geometry(p_cpu).n_padded
    flat = _flatten_local(grads, n)
    (rs_c, _), (rs_d, _) = step_c.channels, step_d.channels
    pc, sc = rs_c.compress(flat[None])
    pd, sd = rs_d.compress(flat[None].to(dev))
    require_equal("small: wire payload and scales", list(pc) + [sc],
                  [t.cpu() for t in pd] + [sd.cpu()])
    seg_c = rs_c.reduce_scatter(flat).segment
    seg_d = rs_d.reduce_scatter(flat.to(dev)).segment
    require_equal("small: reduced segment", [seg_c], [seg_d.cpu()])
    o_c = init_compressed_opt_state(p_cpu, None, reg, OptConfig())
    p_dev = tree_map(lambda t: t.to(dev), p_cpu)
    o_d = init_compressed_opt_state(p_dev, None, reg, OptConfig())
    new_c, _, m_c = step_c.stage2(p_cpu, grads, o_c)
    new_d, _, m_d = step_d.stage2(
        p_dev, tree_map(lambda t: t.to(dev), grads), o_d)
    require_equal("small: gathered parameters",
                  pytree_leaves(new_c), [t.cpu() for t in
                                         pytree_leaves(new_d)])
    if float(m_c["grad_norm"]) != float(m_d["grad_norm"]):
        raise AssertionError("small: global gradient norms differ")
    log("train", f"small (reduced phi3, d_model 128, f32): 2 compressed "
                 f"steps, losses card {ld} vs CPU {lc}; one gradient "
                 f"({n} values) through the wire: words, flags, pool, "
                 "scales, reduced segment and gathered parameters "
                 "bit-equal card vs CPU")


def phase_sync_free_train(reduced, get_config, dev="cuda"):
    """The sync-free check of :func:`phase_sync_free` on the train path:
    reduced phi3 (d_model 128, 2 layers, f32) builds a compressed and a
    baseline step over the one-rank world, takes one warm step of each,
    then one more of each under torch's sync debug mode "error": neither
    step makes a synchronizing call (the optimizers keep their step
    count on the host). ``dev="cpu"`` rehearses it without the debug
    mode."""
    import torch.distributed as dist
    from repro_torch.comm import CommConfig
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.launch.train import calibrate_registry
    from repro_torch.models import init_params
    from repro_torch.models.transformer import pytree_leaves
    from repro_torch.training import (OptConfig, TrainConfig,
                                      init_compressed_opt_state,
                                      make_baseline_step,
                                      make_compressed_step)
    from repro_torch.training import optimizer as optm
    cfg = reduced(get_config("phi3-mini-3.8b"), d_model=128,
                  dtype="float32")
    group = dist.group.WORLD
    data = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=32, global_batch=4))
    p_cpu = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    reg = calibrate_registry(cfg, p_cpu, data.batch_at(0), group)
    opt_cfg, train_cfg = OptConfig(), TrainConfig()
    steps = {"baseline": make_baseline_step(cfg, opt_cfg, train_cfg,
                                            group=group),
             "compressed": make_compressed_step(
                 cfg, opt_cfg, train_cfg, group, reg, CommConfig(),
                 transport="oneshot")}
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(4),
                         dev)
    opts = {"baseline": optm.init_state(params, opt_cfg),
            "compressed": init_compressed_opt_state(params, group, reg,
                                                    opt_cfg)}
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                data.batch_at(i).items()} for i in range(2)]
    state = {}
    for name, step in steps.items():
        state[name] = step(params, opts[name], batches[0])[:2]
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        for name, step in steps.items():
            state[name] = step(*state[name], batches[1])
    finally:
        if dev == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    for name, (p, o, metrics) in state.items():
        if int(o["step"]) != 2 or o["step"].device.type != "cpu":
            raise AssertionError(f"sync-free: the {name} step's count is "
                                 f"{o['step']} on {o['step'].device}")
        if not all(bool(torch.isfinite(t).all()) for t in pytree_leaves(p)):
            raise AssertionError(f"sync-free: the {name} step's parameters "
                                 "are not finite")
    log("parity", f"{cfg.name} (d_model 128, 2 layers, f32): one "
                  "compressed and one baseline train step after a warm "
                  "step make no synchronizing call (sync debug mode "
                  "\"error\"); the step count stays on the host")


def phase_train(qf, h6, ops, ref, flush, cfg=None, dev="cuda",
                seq_len=512, global_batch=4):
    """phi3-mini-3.8b at full width, depth cut to 8 layers: the compressed
    training path with K6/K1/K2 counted, K6 checked and timed on the
    path's own symbols, the raw e4m3 twin and the baseline."""
    from repro_torch.comm import calibrate
    from repro_torch.launch.train import train
    from repro_torch.models import init_params
    cfg = _train_cell(cfg)
    log("train", f"{cfg.name}: {cfg.num_layers} of 32 layers (cut: f32 "
                 f"params, grads and AdamW moments of 32 layers are ~61 GB "
                 f"before the step's flat copies), d_model {cfg.d_model}, "
                 f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, params "
                 f"{cfg.param_dtype}, compute {cfg.dtype}, remat "
                 f"{cfg.remat}; global batch {global_batch}, seq {seq_len}, "
                 "one NCCL rank, transport oneshot")
    kw = dict(seq_len=seq_len, global_batch=global_batch, device=dev,
              transport="oneshot", seed=0)
    counters = {"K6": h6.histogram256, "K1": qf.fused_encode,
                "K2": qf.fused_decode}
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = train(cfg, comm="qlc", steps=4, **kw)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    hist = res["history"]
    for kname, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{kname} was not launched on the train "
                                 "path")
    if not all(h["ok"] for h in hist) or res["comm_fallbacks"]:
        raise AssertionError(f"train: ok {[h['ok'] for h in hist]}, "
                             f"fallbacks {res['comm_fallbacks']}")
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train: losses {losses}")
    reg = res["registry"]
    g = reg["grads"]
    step_ms = [h["dt"] * 1e3 for h in hist]
    peak = (torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda"
            else float("nan"))
    log("train", f"calibrate {res['calibrate_s'] * 1e3:.1f} ms (grads: "
                 f"{g.plan.expected_bits_per_symbol:.4f} expected "
                 f"bits/symbol, {g.plan.capacity_words}-word slots, pool "
                 f"{g.plan.pool_slots_per_1k}/1k); 4 compressed steps "
                 f"{[round(t, 3) for t in step_ms]} ms, losses {losses}, "
                 f"all ok, no fallback; wire "
                 f"{res['grads_wire_bytes_per_symbol']:.4f} B/symbol "
                 f"(grads), {res['params_wire_bytes_per_symbol']:.4f} "
                 f"(params); launches {launches}; {wall:.1f} s with init; "
                 f"peak device memory {peak:.2f} GiB")
    n_padded = res["step"].geometry(res["params"]).n_padded
    del res

    # K6 on the path's own symbols: the same seed, batch and backward.
    from repro_torch.data import DataConfig, SyntheticDataset
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    b0 = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=seq_len,
                                     global_batch=global_batch)).batch_at(0)
    b0 = {k: torch.as_tensor(v).to(dev) for k, v in b0.items()}
    grad = calibrate.flat_gradient(cfg, params, b0)
    del params
    syms = calibrate.quantized_symbols(grad)
    got = ops.histogram(syms)
    lib = torch.bincount(syms, minlength=256).to(torch.int32)
    k6_err = require_equal("K6 on the gradient's symbols", [got], [lib])
    path = {"shape": [syms.numel()], "err": k6_err,
            "ms": time_ms(lambda: ops.histogram(syms), 5, flush),
            "kernel_ms": time_ms(bare_k6(syms), 5, flush, alone=True),
            "library_ms": time_ms(
                lambda: torch.bincount(syms, minlength=256), 5, flush),
            "bound_ms": bound_ms("histogram", syms)}
    log("train", f"K6 on the path's {syms.numel()} gradient symbols (one "
                 f"launch): equal to torch.bincount; {path['ms']:.4f} ms "
                 f"(kernel alone {path['kernel_ms']:.4f}), "
                 f"torch.bincount {path['library_ms']:.4f} ms, HBM bound "
                 f"{path['bound_ms']:.4f} ms")
    del syms, got, lib
    fused = train_path_fused(ops, ref, g, grad, flush)
    del grad
    torch.cuda.empty_cache()

    twin = {}
    for name, enabled in (("compressed", True), ("raw e4m3", False)):
        r = train(cfg, comm="qlc", steps=2, registry=reg,
                  wire_enabled=enabled, **kw)
        if not all(h["ok"] for h in r["history"]):
            raise AssertionError(f"{name} twin run: a step's ok is False")
        twin[name] = _flat_params(r["params"])
        del r
    require_equal("compressed vs raw e4m3 twin parameters after 2 steps",
                  [twin["compressed"]], [twin["raw e4m3"]])
    log("train", "compressed run == raw e4m3 twin after 2 steps: "
                 f"{twin['compressed'].numel()} parameters bit-equal")
    del twin
    base = train(cfg, comm="baseline", steps=4, **kw)
    lb = [h["loss"] for h in base["history"]]
    base_ms = [h["dt"] * 1e3 for h in base["history"]]
    del base
    diffs = [abs(a - b) for a, b in zip(lb, losses)]
    if not all(math.isfinite(v) for v in lb):
        raise AssertionError(f"baseline losses {lb}")
    # Recorded, not gated: at this width both runs' first Adam steps move
    # every parameter by about lr, the compressed run's parameter
    # all-gather rounds most of those moves back to the e4m3 grid, and
    # the baseline's own loss is not monotone. The reference's bound is
    # gated on the reference's own recipe (phase_train_recipe).
    log("train", f"baseline 4 steps {[round(t, 3) for t in base_ms]} ms, "
                 f"losses {lb}; |baseline - compressed| per step "
                 f"{[round(d, 4) for d in diffs]}")
    if dev == "cuda":
        log("train", f"peak device memory over the phase's runs "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"launches": launches, "path": path, "fused": fused,
            "losses": losses, "registry": reg, "n_padded": n_padded,
            "step_ms": step_ms, "base_ms": base_ms, "base_losses": lb}


def train_path_fused(ops, ref, entry, grad, flush, rows=4096,
                     phase="train"):
    """K1 with codes and K2's accumulate form at the train path's own
    shape: the flat gradient as chunks of the plan's size, at the plan's
    slot, with the calibrated gradient codec. Each held bit for bit
    against its plain version on the first and last ``rows`` chunks, and
    timed beside its HBM bound. Returns {"K1": ..., "K2": ...}."""
    k, cap = entry.plan.chunk_symbols, entry.plan.capacity_words
    t = entry.tables
    x = grad.reshape(-1, k)
    n = x.shape[0]
    words, nb, sc, codes = ops.quantize_encode(x, t, cap, emit_codes=True)
    acc = grad.reshape(-1, k)
    out = ops.decode_dequantize_accumulate(acc, words, sc, t, k)
    err = {"K1": 0.0, "K2": 0.0}
    for r0 in sorted({0, max(0, n - rows)}):
        sl = slice(r0, r0 + rows)
        err["K1"] = max(err["K1"], require_equal(
            f"K1 train path rows {r0}:{r0 + rows}",
            [words[sl], nb[sl], sc[sl], codes[sl]],
            ref.quantize_encode_ref(x[sl], t, cap, emit_codes=True)))
        err["K2"] = max(err["K2"], require_equal(
            f"K2 acc train path rows {r0}:{r0 + rows}", [out[sl]],
            [ref.decode_dequantize_ref(words[sl], sc[sl], [t], 0, k,
                                       acc=acc[sl])]))
    del out
    res = {
        "K1": {"shape": [n, k], "cap": cap, "codes": True,
               "max_abs_err": err["K1"],
               "ms": time_ms(lambda: ops.quantize_encode(
                   x, t, cap, emit_codes=True), 5, flush),
               "kernel_ms": time_ms(bare_k1(x, t, cap, emit_codes=True), 5,
                                    flush, alone=True),
               "bound_ms": bound_ms("quantize_encode", x, t, cap,
                                    emit_codes=True)},
        "K2": {"shape": [n, cap], "form": "acc", "max_abs_err": err["K2"],
               "ms": time_ms(lambda: ops.decode_dequantize_accumulate(
                   acc, words, sc, t, k), 5, flush),
               "kernel_ms": time_ms(bare_k2(words, sc, t, k, acc=acc), 5,
                                    flush, alone=True),
               "bound_ms": bound_ms("decode_dequantize_accumulate", acc,
                                    words, sc, t, k)}}
    for kname, v in res.items():
        log(phase, f"{kname} at the {phase} path's shape {v['shape']} (slot "
                     f"{cap} words{', codes' if kname == 'K1' else ', acc'}):"
                     f" bit-equal to plain on the first and last {rows} "
                     f"chunks; {v['ms']:.3f} ms (kernel alone "
                     f"{v['kernel_ms']:.3f}), HBM bound "
                     f"{v['bound_ms']:.3f} ms")
    return res


def phase_train_recipe(dev="cuda", steps=8):
    """The reference's own training check (``tests/test_train_integration
    .py``): reduced deepseek-coder-33b (d_model 64, 2 layers, bf16
    compute), AdamW lr 1e-2 with 2 warmup steps and clip 1.0, 2
    microbatches, global batch 8 x 16 tokens from seed 3, the gradient
    codec calibrated on the first batch at 256-symbol chunks with a pool
    for every chunk. Both steps must learn (loss down by more than 0.1
    over 8 steps) and the compressed losses stay within 0.15 of the
    baseline's (the reference's bound)."""
    import dataclasses
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
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    b0 = {k: torch.as_tensor(v).to(dev) for k, v in data.batch_at(0).items()}
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
    lb, lc = [], []
    for s in range(steps):
        batch = data.batch_at(s)
        pb, ob, mb = base(pb, ob, batch)
        pc, oc, mc = comp(pc, oc, batch)
        if not bool(mc["ok"]):
            raise AssertionError(f"recipe: step {s} wire overflowed")
        lb.append(float(mb["loss"]))
        lc.append(float(mc["loss"]))
    diffs = [abs(a - b) for a, b in zip(lb, lc)]
    if not (lb[-1] < lb[0] - 0.1 and lc[-1] < lc[0] - 0.1
            and max(diffs) < 0.15):
        raise AssertionError(f"recipe: baseline {lb} vs compressed {lc}")
    log("train", f"the reference's training check on one rank: baseline "
                 f"{[round(v, 4) for v in lb]}, compressed "
                 f"{[round(v, 4) for v in lc]}; both learn, max |diff| "
                 f"{max(diffs):.4f} < 0.15")


#: free disk over the checkpoint's raw bytes the full-depth ckpt phase
#: needs (the compressed files, with room to spare); below it the phase
#: cuts to the train phase's 8 layers.
CKPT_DISK_FACTOR = 1.5


def _ckpt_tree(cfg, dev, min_numel=1 << 20):
    """The FP8 weight checkpoint of ``cfg`` from the slice's seed: the
    block-32 e4m3 symbols (u8, shaped like the weight; blocks of its
    flattened values) and bf16 scales of
    every weight leaf of ``min_numel`` values or more, the embedding's
    symbols once more as a ``float8_e4m3fn`` leaf, and the final norm
    (f32)."""
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models import init_params
    from repro_torch.quant import e4m3
    flat = flatten_with_paths(init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev))
    weights = {}
    for key in list(flat):
        if flat[key].numel() >= min_numel:
            w = flat.pop(key)
            codes, scales = e4m3.quantize_block32_pieces(w.reshape(-1))
            weights[key.replace("/", ".")] = {
                "codes": codes.view(w.shape),
                "scales": scales.to(torch.bfloat16)}
    return {"weights": weights,
            "fp8_embed": weights["embed"]["codes"].view(torch.float8_e4m3fn),
            "final_norm": flat["final_norm"]}


def _same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def phase_ckpt(qc, h6, ops, ref, flush, dev="cuda", cfg=None,
               min_numel=1 << 20):
    """The FP8 weight checkpoint of phi3-mini-3.8b at full width (32
    layers, or the train phase's 8 when the disk cannot hold 32) through
    ``CheckpointManager``: saved and restored bit for bit, K3, K4 and K6
    counted from zero around the save and restore, the stages timed; K3,
    K4 and K6 held against their plain versions at the largest leaf's
    shape and timed there; a flipped word must raise IOError."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.comm import container
    from repro_torch.configs import get_config
    from repro_torch.core import CodecRegistry
    cfg = cfg or get_config("phi3-mini-3.8b")
    tree = _ckpt_tree(cfg, dev, min_numel)
    tmp = tempfile.mkdtemp(prefix="qlc_ckpt_")
    try:
        raw = sum(nbytes(t) for t in flatten_with_paths(tree).values())
        free = shutil.disk_usage(tmp).free
        depth = cfg.num_layers
        if free < CKPT_DISK_FACTOR * raw:
            depth = 8
            for w in tree["weights"].values():
                if w["codes"].shape[0] == cfg.num_layers:
                    for part in ("codes", "scales"):
                        w[part] = w[part][:depth].contiguous()
            raw = sum(nbytes(t) for t in flatten_with_paths(tree).values())
        leaves = flatten_with_paths(tree)
        log("ckpt", f"{cfg.name} FP8 weight checkpoint, {depth} of "
                    f"{cfg.num_layers} layers, full width: {len(leaves)} "
                    f"leaves, {raw} raw bytes ("
                    f"{sum(w['codes'].numel() for w in tree['weights'].values())}"
                    f" e4m3 symbols); {free} bytes free at {tmp}")
        counters = {"K3": qc.encode, "K4": qc.decode, "K6": h6.histogram256}
        for fn in counters.values():
            fn.launches = 0
        mgr = CheckpointManager(tmp)
        t0 = time.perf_counter()
        mgr.save(1, tree, extra={"step": 1})
        save_s, save_t = time.perf_counter() - t0, dict(mgr.timings)
        t0 = time.perf_counter()
        got, extra = mgr.restore(tree, device=dev)
        torch.cuda.synchronize()
        restore_s, restore_t = time.perf_counter() - t0, dict(mgr.timings)
        launches = {k: fn.launches for k, fn in counters.items()}
        for kname, c in launches.items():
            if c <= 0:
                raise AssertionError(f"{kname} was not launched on the "
                                     "checkpoint path")
        back = flatten_with_paths(got)
        bad = [k for k in leaves if not _same_bytes(leaves[k], back[k])]
        if bad or extra != {"step": 1}:
            raise AssertionError(f"ckpt: restored leaves differ: {bad}")
        del got, back
        cdir = os.path.join(tmp, "step_0000000001")
        with open(os.path.join(cdir, "manifest.json")) as f:
            manifest = json.load(f)
        disk = sum(os.path.getsize(os.path.join(cdir, n))
                   for n in os.listdir(cdir))
        codes_keys = [f"weights/{k}/codes" for k in tree["weights"]]
        if not all("qlc" in manifest["leaves"][k]
                   for k in codes_keys + ["fp8_embed"]):
            raise AssertionError("ckpt: a symbol leaf was kept raw")
        codes_disk = sum(os.path.getsize(os.path.join(
            cdir, manifest["leaves"][k]["file"])) for k in codes_keys)
        codes_raw = sum(tree["weights"][k]["codes"].numel()
                        for k in tree["weights"])

        def rates(t):
            return "; ".join(f"{k} {v:.3f} s ({raw / v / 1e9:.2f} GB/s)"
                             for k, v in t.items())

        log("ckpt", f"save {save_s:.3f} s: {rates(save_t)}")
        log("ckpt", f"restore {restore_s:.3f} s: {rates(restore_t)}")
        log("ckpt", f"restored == saved, bit for bit, all {len(leaves)} "
                    f"leaves; on disk {disk} B / raw {raw} B = "
                    f"{disk / raw:.4f} (symbol leaves {codes_disk} / "
                    f"{codes_raw} = {codes_disk / codes_raw:.4f}); launches "
                    f"{launches}")

        # K3, K4 and K6 at the largest leaf's shape, against the plain
        # versions (K3 over the whole leaf, 4096 chunks at a time; K4 over
        # its first and last 4096 chunks, the plain decode being ~0.6 s
        # each; K6 whole) and the saved symbols.
        key = max(tree["weights"],
                  key=lambda k: tree["weights"][k]["codes"].numel())
        meta = manifest["leaves"][f"weights/{key}/codes"]
        stored = np.load(os.path.join(cdir, meta["file"]))
        h = container.parse_header(stored)
        t = CodecRegistry.load(os.path.join(cdir, "registry.json")).by_id(
            h.scheme_id).tables
        cap, k = h.capacity_words, h.chunk_symbols
        sym = tree["weights"][key]["codes"].reshape(-1, k)
        n = sym.shape[0]
        rows = 4096
        words, nb = ops.encode(sym, t, cap)
        err = {"K3": 0.0}
        for r0 in range(0, n, rows):
            sl = slice(r0, r0 + rows)
            err["K3"] = max(err["K3"], require_equal(
                f"K3 ckpt rows {r0}:{r0 + rows}", [words[sl], nb[sl]],
                ref.encode_ref(sym[sl], t, cap)))
        framed = torch.from_numpy(stored[container.HEADER_WORDS:
                                         container.HEADER_WORDS + n * cap]
                                  .view(np.int32)).to(dev).view(n, cap)
        if not torch.equal(words, framed):
            raise AssertionError("ckpt: the stored container's slots are "
                                 "not the words K3 encodes (framing)")
        del framed
        sid = torch.zeros(n, dtype=torch.int32, device=dev)
        dec = ops.decode(words, t, k)
        err["K4"] = require_equal("K4 at the ckpt leaf vs its symbols",
                                  [dec], [sym])
        for r0 in sorted({0, max(0, n - rows)}):
            sl = slice(r0, r0 + rows)
            err["K4"] = max(err["K4"], require_equal(
                f"K4 ckpt rows {r0}:{r0 + rows}", [dec[sl]],
                [ref.decode_ref(words[sl], [t], sid[sl], k)]))
        del dec
        flat_sym = sym.reshape(-1)
        err["K6"] = require_equal(
            "K6 at the ckpt leaf", [ops.histogram(flat_sym)],
            [ref.histogram256_ref(flat_sym)])
        part = sym[:rows]
        path = {
            "K3": {"ms": time_ms(lambda: ops.encode(sym, t, cap), 5, flush),
                   "kernel_ms": time_ms(bare_k3(sym, t, cap), 5, flush,
                                        alone=True),
                   "plain_ms": time_ms(lambda: ref.encode_ref(part, t, cap),
                                       3, flush),
                   "bound_ms": bound_ms("encode", sym, t, cap)},
            "K4": {"ms": time_ms(lambda: ops.decode(words, t, k), 5, flush),
                   "kernel_ms": time_ms(bare_codes_decode(
                       "decode", words, [t], sid, k), 5, flush, alone=True),
                   "plain_ms": time_ms(lambda: ref.decode_ref(
                       words[:rows], [t], sid[:rows], k), 3, flush),
                   "bound_ms": bound_ms("decode", words, [t], k,
                                        scheme_ids=sid)},
            "K6": {"ms": time_ms(lambda: ops.histogram(flat_sym), 5, flush),
                   "kernel_ms": time_ms(bare_k6(flat_sym), 5, flush,
                                        alone=True),
                   "plain_ms": time_ms(lambda: ref.histogram256_ref(
                       flat_sym[:rows * k]), 3, flush),
                   "library_ms": time_ms(lambda: torch.bincount(
                       flat_sym, minlength=256), 5, flush),
                   "bound_ms": bound_ms("histogram", flat_sym)}}
        checked = {
            "K3": f"bit-equal to plain on all {n} chunks ({rows} at a "
                  "time), and the stored container holds its words",
            "K4": f"equal to the saved symbols on all {n} chunks and "
                  f"bit-equal to plain on the first and last {rows}",
            "K6": "equal to plain on the whole leaf"}
        for kname, v in path.items():
            v.update(shape=[n, k], cap=cap, err=err[kname],
                     launches=launches[kname],
                     plain_shape=[rows, k])
            log("ckpt", f"{kname} at the largest leaf {key} [{n}, {k}] "
                        f"(slot {cap} words): {checked[kname]}; "
                        f"{v['ms']:.4f} ms (kernel alone "
                        f"{v['kernel_ms']:.4f}), plain on [{rows}, {k}] "
                        f"{v['plain_ms']:.3f} ms, HBM bound "
                        f"{v['bound_ms']:.4f} ms"
                        + (f", torch.bincount {v['library_ms']:.4f} ms"
                           if "library_ms" in v else ""))
        del words, nb, stored

        fp8 = manifest["leaves"]["fp8_embed"]
        fpath = os.path.join(cdir, fp8["file"])
        arr = np.load(fpath)
        arr[container.HEADER_WORDS + 5] ^= np.uint32(0xFFFF)
        np.save(fpath, arr)
        try:
            mgr.restore({"fp8_embed": tree["fp8_embed"]}, device=dev)
        except IOError as e:
            log("ckpt", f"one flipped word in fp8_embed's container: "
                        f"restore raised IOError ({e})")
        else:
            raise AssertionError("ckpt: a flipped word restored silently")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"depth": depth, "ratio": disk / raw, "save_s": save_s,
            "restore_s": restore_s, "path": path}


def phase_ckpt_resume(qf, h6, reduced, get_config, dev="cuda"):
    """Reduced phi3 (d_model 128, 2 layers, f32) through the training
    launcher's entry, ``train(comm="qlc", transport="auto", autotune=True,
    checkpoint_dir=..., checkpoint_every=3)``, 6 steps; then step 6 is
    removed, as if the run had died while saving it, and the same launch
    resumes from step 3 and runs 3 more: parameters and ZeRO-1 state
    bit-equal to the straight run's. The checkpoint is one directory of
    whole leaves, ``1/m`` and ``1/v`` as ``[1, 1, seg]``; each save and
    restore stage's seconds are logged. Both runs autotune the step's
    two wires, whose "auto" channels resolve to the tuning. K1, K2 and
    K6 counted from zero around the two launches."""
    import shutil
    import tempfile
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.launch.train import train
    cfg = reduced(get_config("phi3-mini-3.8b"), d_model=128,
                  dtype="float32")
    kw = dict(comm="qlc", steps=6, seq_len=32, global_batch=4, lr=1e-3,
              transport="auto", autotune=True, checkpoint_every=3,
              device=dev)
    counters = {"K1": qf.fused_encode, "K2": qf.fused_decode,
                "K6": h6.histogram256}
    for fn in counters.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory(prefix="qlc_resume_") as tmp:
        a = train(cfg, checkpoint_dir=tmp, **kw)
        names = sorted(os.listdir(tmp))
        with open(os.path.join(tmp, "step_0000000006",
                               "manifest.json")) as f:
            leaves = json.load(f)["leaves"]
        shutil.rmtree(os.path.join(tmp, "step_0000000006"))
        b = train(cfg, checkpoint_dir=tmp, **kw)
    launches = {k: fn.launches for k, fn in counters.items()}
    if (a["start_step"], b["start_step"]) != (0, 3):
        raise AssertionError(f"resume: started at {a['start_step']} and "
                             f"{b['start_step']}, not 0 and 3")
    seg = a["opt_state"]["m"].numel()
    if any(n.startswith("rank_") for n in names) or any(
            leaves[k]["shape"] != [1, 1, seg] for k in ("1/m", "1/v")):
        raise AssertionError(f"resume: the checkpoint is not one directory "
                             f"of whole leaves: {names}, 1/m "
                             f"{leaves['1/m']['shape']} (want [1, 1, {seg}])")
    for what, t in (("save (first run, step 6)", a["checkpoint"]["save"]),
                    ("restore (step 3)", b["checkpoint"]["restore"]),
                    ("save (resumed run, step 6)", b["checkpoint"]["save"])):
        log("ckpt", f"resume {what}: " + ", ".join(
            f"{k} {v:.4f} s" for k, v in t.items()))
    fa = flatten_with_paths((a["params"], a["opt_state"]))
    fb = flatten_with_paths((b["params"], b["opt_state"]))
    bad = [k for k in fa if not _same_bytes(fa[k], fb[k])]
    if bad or list(fa) != list(fb):
        raise AssertionError(f"resume: leaves differ: {bad}")
    n = a["step"].geometry(a["params"]).n_padded
    tuned = {}
    for res in (a, b):
        for (name, is_reduce), ch in zip((("grads", True), ("params", False)),
                                         res["channels"]):
            want = res["tuned"][name].transport
            got = ch.resolved_transport(n, is_reduce=is_reduce)
            if got != want:
                raise AssertionError(f"autotune {name}: the step's channel "
                                     f"resolves to {got}, tuned {want}")
            tuned.setdefault(name, []).append(
                [want.kind, want.hop_chunks,
                 res["tuned"][name].model.decode_Bps])
    for kname, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{kname} was not launched by the launcher")
    log("ckpt", f"resume on the card through launch.train.train (reduced "
                f"phi3, --comm qlc --transport auto --autotune "
                f"--checkpoint-every 3): 6 steps straight == 3 steps + step "
                f"6 removed + resume at step 3 + 3 steps, {len(fa)} leaves of "
                f"params and ZeRO-1 state bit-equal; one directory {names}, "
                f"1/m and 1/v [1, 1, {seg}]; fallbacks "
                f"{a['comm_fallbacks']}, {b['comm_fallbacks']}; tuned (kind, "
                f"hop pieces, decode B/s; both runs) {tuned}, the step's "
                f"'auto' channels resolve to them; launches {launches}")
    return {"launches": launches, "tuned": tuned}


def phase_autotune(qf, tr, flush, dev="cuda"):
    """The launcher's autotune (``_autotune_transports``) of the train
    phase's registry on its one NCCL rank, "grads" (reduce-scatter) and
    "params" (all-gather) at the train path's flat payload, the decode
    probe at 2^24 symbols; the tuning through a registry JSON round trip
    and an "auto" channel. Then what the probe measures: its payload's
    escapes and pool, and the probe's decode against K2 alone on it.
    Last, psum and all_to_all on the card against the same on the CPU
    (the plain versions), bit for bit. K1 and K2 counted from zero
    around the phase."""
    import torch.distributed as dist
    from repro_torch.comm import compressed as comp
    from repro_torch.comm.channel import (Channel, ChannelSpec,
                                          decode_probe_payload)
    from repro_torch.core import CodecRegistry
    from repro_torch.launch.train import _autotune_transports
    reg, n = tr["registry"], tr["n_padded"]
    group = dist.group.WORLD
    counters = {"K1": qf.fused_encode, "K2": qf.fused_decode}
    for fn in counters.values():
        fn.launches = 0
    probe_symbols = 1 << 24
    t0 = time.perf_counter()
    tuned = _autotune_transports(reg, n, group, dev,
                                 probe_symbols=probe_symbols, repeats=5)
    log("autotune", f"launch.train._autotune_transports at {4 * n} B per "
                    f"rank, {dist.get_world_size()} rank (no wire probe), "
                    f"{time.perf_counter() - t0:.2f} s: " + "; ".join(
                        f"{name} decode {ch.model.decode_Bps:.6g} B/s, "
                        f"chosen {ch.transport.kind} x"
                        f"{ch.transport.hop_chunks}"
                        for name, ch in tuned.items()))
    back = CodecRegistry.from_json(reg.to_json())
    for name, is_reduce in (("grads", True), ("params", False)):
        want = tuned[name].transport
        cached = back.cached_transport(back[name].scheme_id, "data", 4 * n,
                                       is_reduce=is_reduce)
        auto = Channel(ChannelSpec(codec=name, transport="auto",
                                   group=group), registry=back)
        got = auto.resolved_transport(n, is_reduce=is_reduce)
        if cached != want or got != want:
            raise AssertionError(f"autotune {name}: cached {cached}, auto "
                                 f"{got}, tuned {want}")
    log("autotune", "the tuning survives a registry JSON round trip; an "
                    "'auto' channel on the reloaded registry resolves to it")
    probe = {}
    for name, ch in tuned.items():
        payload, scales, m = decode_probe_payload(
            ch.tables, ch.cfg, probe_symbols, counts=ch.entry.counts,
            device=dev)
        k, cw = ch.cfg.chunk_symbols, payload.words.shape[-1]
        escaped = int(payload.flags.sum())
        used, slots = int(payload.pool_count.reshape(-1)[0]), \
            payload.pool.shape[-2]
        ok = bool(comp._decompress_values(payload, scales, ch.tables,
                                          ch.cfg)[1].all())
        whole = time_ms(lambda: comp._decompress_values(
            payload, scales, ch.tables, ch.cfg), 5, flush)
        k2 = time_ms(bare_k2(payload.words.reshape(-1, cw),
                             scales.float().reshape(-1, k // 32), ch.tables,
                             k), 5, flush, alone=True)
        call_ms = 4.0 * m / ch.model.decode_Bps * 1e3
        probe[name] = {"chunks": m // k, "escaped": escaped,
                       "pool_used": used, "pool_slots": slots, "ok": ok,
                       "slot_words": cw, "call_ms": call_ms,
                       "events_ms": whole, "k2_alone_ms": k2,
                       "wire_bytes": ch.wire_bytes(payload, scales)}
        log("autotune", f"{name} probe payload: {m // k} chunks of {k}, "
                        f"slot {cw} words, {escaped} escaped ("
                        f"{escaped / (m // k):.4f}), pool {used} of {slots} "
                        f"slots, ok {ok}, {probe[name]['wire_bytes']} wire B; "
                        f"the probe's call {call_ms:.4f} ms (host clock, "
                        f"synchronized), the same decode {whole:.4f} ms "
                        f"(CUDA events, after an L2 flush), K2 alone on its "
                        f"words {k2:.4f} ms")
    ch = Channel(ChannelSpec(codec="grads", group=group), registry=reg)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(1 << 22, generator=gen) * 1e-3
    x[: 1 << 20] *= 50.0
    s_d, ok_d = ch.psum(x.to(dev))
    s_c, ok_c = ch.psum(x)
    a_d, oka_d = ch.all_to_all(x.to(dev)[None])
    a_c, oka_c = ch.all_to_all(x[None])
    err = require_equal("psum and all_to_all: card vs CPU",
                        [s_d.cpu(), a_d.cpu()], [s_c, a_c])
    if not (bool(ok_d) and bool(ok_c) and bool(oka_d) and bool(oka_c)):
        raise AssertionError("autotune: psum / all_to_all ok is False")
    launches = {k: fn.launches for k, fn in counters.items()}
    for kname, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{kname} was not launched on the "
                                 "autotune / psum / all_to_all path")
    log("autotune", f"psum and all_to_all of {x.numel()} values on one "
                    f"rank: card (K1, K2) == CPU (plain versions), bit for "
                    f"bit, ok; launches {launches}")
    return {"launches": launches, "err": err, "probe": probe,
            "decode_Bps": {k: v.model.decode_Bps for k, v in tuned.items()},
            "transport": {k: [v.transport.kind, v.transport.hop_chunks]
                          for k, v in tuned.items()}}


def _train_cell(cfg=None):
    """The train cell's config (phi3-mini-3.8b, 8 of 32 layers), or
    ``cfg``."""
    import dataclasses
    from repro_torch.configs import get_config
    return cfg or dataclasses.replace(get_config("phi3-mini-3.8b"),
                                      num_layers=8)


def adapt_telemetry(tr, cfg, dev, seq_len, global_batch, smi):
    """Two compressed steps without and two with wire telemetry from the
    same state and registry (the train phase's): parameters and AdamW
    moments bit-equal; each telemetry histogram counts every symbol its
    wire encoded (one rank: the padded flat length, on both wires)."""
    import torch.distributed as dist
    from repro_torch.comm.compressed import CommConfig
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.models import init_params
    from repro_torch.training import (OptConfig, TrainConfig,
                                      init_compressed_opt_state,
                                      make_compressed_step)
    reg = tr["registry"]
    opt_cfg = OptConfig(lr=3e-4, total_steps=2, warmup_steps=10)
    data = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=seq_len,
                                       global_batch=global_batch))
    runs = {}
    for name, telemetry in (("plain", False), ("telemetry", True)):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        step = make_compressed_step(cfg, opt_cfg, TrainConfig(),
                                    dist.group.WORLD, reg, CommConfig(),
                                    transport="oneshot", telemetry=telemetry)
        o = init_compressed_opt_state(params, None, reg, opt_cfg)
        n = step.geometry(params).n_padded
        ms, sums = [], []
        for s in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, o, m = step(params, o, data.batch_at(s))
            ok = bool(m["ok"])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if not ok:
                raise AssertionError(f"adapt: {name} step {s} overflowed")
            if telemetry:
                sums.append([int(m[k].sum()) for k in (
                    "adapt/grads_hist", "adapt/params_hist",
                    "adapt/grads_overflow", "adapt/params_overflow")])
        runs[name] = ([_flat_params(params).cpu(), o["m"].cpu(),
                       o["v"].cpu()], ms, sums)
        del params, o, step, m
        torch.cuda.empty_cache()
    require_equal("adapt: telemetry vs plain steps (params, m, v)",
                  runs["telemetry"][0], runs["plain"][0])
    if any(g != n or p != n or go or po
           for g, p, go, po in runs["telemetry"][2]):
        raise AssertionError(f"adapt: histogram sums {runs['telemetry'][2]},"
                             f" want {n} on both wires and no overflow")
    log("adapt", f"telemetry is free of payload effect: 2 telemetry steps "
                 f"and 2 plain steps from the same state, "
                 f"{runs['plain'][0][0].numel()} parameters and both AdamW "
                 f"moments bit-equal; histogram sums (grads, params) "
                 f"{[r[:2] for r in runs['telemetry'][2]]} == {n} symbols "
                 f"each wire encoded; ms/step plain "
                 f"{[round(t, 3) for t in runs['plain'][1]]}, telemetry "
                 f"{[round(t, 3) for t in runs['telemetry'][1]]} | {smi}")
    return {"plain_ms": runs["plain"][1], "telemetry_ms": runs["telemetry"][1],
            "n_padded": n}


def adapt_k1_hist(ops, flush, entry, grad, smi):
    """K1 at the flat-gradient shape with codes, without and with its
    histogram output (what the telemetry step's encode runs): the same
    words, bits, scales and codes; the histogram equal to torch.bincount
    of the codes; both timed alone, in turns (codes, hist, hist, codes)."""
    k, cap, t = entry.plan.chunk_symbols, entry.plan.capacity_words, \
        entry.tables
    x = grad[:grad.numel() // k * k].reshape(-1, k)
    plain = ops.quantize_encode(x, t, cap, emit_codes=True)
    outs = ops.quantize_encode(x, t, cap, emit_codes=True, emit_hist=True)
    err = require_equal("K1 with emit_hist vs without, train shape",
                        list(outs[:4]), list(plain))
    lib = torch.bincount(outs[3].reshape(-1), minlength=256).to(torch.int32)
    err = max(err, require_equal("K1's histogram vs torch.bincount of its "
                                 "codes, train shape", [outs[4]], [lib]))
    bound = bound_ms("quantize_encode", x, t, cap, emit_codes=True,
                     emit_hist=True)
    del plain, lib
    times = [time_ms(bare_k1(x, t, cap, emit_codes=True, emit_hist=h), 5,
                     flush, alone=True) for h in (False, True, True, False)]
    res = {"shape": list(x.shape), "cap": cap, "max_abs_err": err,
           "kernel_ms": (times[0] + times[3]) / 2,
           "hist_kernel_ms": (times[1] + times[2]) / 2,
           "turns_ms": times, "bound_ms": bound}
    log("adapt", f"K1 alone at the flat-gradient shape {res['shape']} (slot "
                 f"{cap} words, codes): without emit_hist "
                 f"{res['kernel_ms']:.4f} ms, with {res['hist_kernel_ms']:.4f}"
                 f" ms (turns {[round(v, 4) for v in times]}); outputs "
                 f"bit-equal, histogram == torch.bincount of the codes; HBM "
                 f"bound {bound:.4f} ms | {smi}")
    return res


def adapt_escape_census(ops, cfg, dev, seq_len, global_batch, entries):
    """Batch 0's flat gradient (the calibration's) under each codec of
    ``entries``: the chunks whose code exceeds the plan's slot (they
    escape to the pool) against the pool's slots, and for the last entry
    the leaves that hold most of them (a chunk counts for the leaf it
    starts in)."""
    from repro_torch.comm import calibrate
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models import init_params
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    b0 = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=seq_len,
                                     global_batch=global_batch)).batch_at(0)
    grad = calibrate.flat_gradient(
        cfg, params, {k: torch.as_tensor(v).to(dev) for k, v in b0.items()})
    sizes = [(path, t.numel())
             for path, t in flatten_with_paths(params).items()]
    del params
    out = {}
    for label, e in entries.items():
        k, cap = e.plan.chunk_symbols, e.plan.capacity_words
        x = grad[:grad.numel() // k * k].reshape(-1, k)
        nb = ops.quantize_encode(x, e.tables, cap)[1]
        esc = nb > 32 * cap
        n = x.shape[0]
        out[label] = {"chunks": n, "escaped": int(esc.sum()),
                      "pool_slots": e.plan.pool_slots(n),
                      "capacity_words": cap,
                      "pool_slots_per_1k": e.plan.pool_slots_per_1k}
        del nb, x
    starts = np.cumsum([0] + [m for _, m in sizes])
    idx = torch.nonzero(esc).reshape(-1).cpu().numpy() * k
    leaf = np.searchsorted(starts, idx, side="right") - 1
    counts = np.bincount(leaf, minlength=len(sizes))
    top = [(sizes[i][0], int(counts[i]), -(-sizes[i][1] // k))
           for i in np.argsort(-counts)[:3] if counts[i]]
    out[label]["top_leaves"] = top
    del grad, esc
    torch.cuda.empty_cache()
    log("adapt", "escape census of batch 0's gradient (" + "; ".join(
        f"{label}: {v['escaped']} of {v['chunks']} chunks over the "
        f"{v['capacity_words']}-word slot, pool {v['pool_slots']} slots "
        f"({v['pool_slots_per_1k']}/1k)" for label, v in out.items())
        + f"); the {label}'s escapes by leaf (escaped, chunks): {top}")
    return out


def _wire_bytes_per_symbol(entry, n: int) -> float:
    from repro_torch.comm.planner import payload_wire_bytes
    p = entry.plan
    return payload_wire_bytes(n, p.chunk_symbols, p.capacity_words,
                              p.pool_slots_per_1k) / n


def _check_lines(res) -> str:
    return "; ".join(
        f"after step {c['step'] + 1} {c['name']} id {c['scheme_id']} "
        f"{c['measured_bits']:.4f} vs {c['planned_bits']:.4f}"
        f"{' FLAGGED' if c['flagged'] else ''}"
        for c in res["adapt"]["checks"])


def phase_adapt(qf, h6, ops, flush, tr, smi, dev="cuda", cfg=None,
                seq_len=512, global_batch=4):
    """Online codec adaptation on the train cell (phi3-mini-3.8b at full
    width, 8 layers, batch 4 x 512, one NCCL rank): telemetry steps
    bit-equal to plain ones; K1 with and without its histogram output at
    the flat-gradient shape; ``launch.train.train(comm="qlc", adapt=True,
    adapt_every=2)`` on real gradients, per check measured against
    planned bits/symbol; then a forced swap: the ``"grads"`` codec
    calibrated on the parameters' histogram, ``adapt_every=1``. The
    adapter must flag it, recalibrate, register a new scheme-id and
    install the rebuilt step; a payload and a codes container written
    under the old id before the swap decode bit-exactly after it through
    the registry's stacked tables (K2; K3 and K4). K1, K2 and K6 counted
    from zero around the two launches."""
    from repro_torch.comm import calibrate
    from repro_torch.comm import container as qcont
    from repro_torch.core import CodecRegistry
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.launch.train import train
    from repro_torch.models import init_params
    from repro_torch.training.train_step import _flat_slice
    cfg = _train_cell(cfg)
    kw = dict(seq_len=seq_len, global_batch=global_batch, device=dev,
              transport="oneshot", seed=0)
    tel = adapt_telemetry(tr, cfg, dev, seq_len, global_batch, smi)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    b0 = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=seq_len,
                                     global_batch=global_batch)).batch_at(0)
    grad = calibrate.flat_gradient(
        cfg, params, {k: torch.as_tensor(v).to(dev) for k, v in b0.items()})
    k1 = adapt_k1_hist(ops, flush, tr["registry"]["grads"], grad, smi)
    # Chunks of parameters and of gradient for the old-id payloads.
    rows = min(4096, grad.numel() // 1024)
    p4 = _flat_slice(params, 0, rows * 1024).reshape(rows, 1024)
    g4 = grad[:rows * 1024].reshape(rows, 1024).clone()
    hist_params = calibrate.histogram_of_tree(params)
    del grad, params
    torch.cuda.empty_cache()

    counters = {"K1": qf.fused_encode, "K2": qf.fused_decode,
                "K6": h6.histogram256}
    for fn in counters.values():
        fn.launches = 0
    real = train(cfg, comm="qlc", steps=6, adapt=True, adapt_every=2, **kw)
    launches = {k: fn.launches for k, fn in counters.items()}
    ev = real["adapt"]["events"]
    log("adapt", f"--adapt on real gradients (6 steps, checks every 2): "
                 f"{_check_lines(real)}; swaps "
                 f"{[(e.name, e.old_scheme_id, e.new_scheme_id) for e in ev]}"
                 f"; fallbacks {real['comm_fallbacks']}; ms/step "
                 f"{[round(h['dt'] * 1e3, 3) for h in real['history']]}; "
                 f"launches {launches} | {smi}")
    real_out = {"checks": real["adapt"]["checks"],
                "swaps": [vars(e) for e in ev],
                "fallbacks": real["comm_fallbacks"],
                "step_ms": [h["dt"] * 1e3 for h in real["history"]]}
    del real
    torch.cuda.empty_cache()

    forced = CodecRegistry()
    forced.register("grads", hist_params)
    forced.register("params", hist_params)
    old = forced["grads"]
    k, cap_old = old.plan.chunk_symbols, old.plan.capacity_words
    # Written under the old id before the swap: parameter chunks (the
    # old codec's own distribution) as values and as a codes container.
    w_old, nb_old, sc_old, codes_old = ops.quantize_encode(
        p4, old.tables, cap_old, emit_codes=True)
    vals_old = ops.decode_dequantize(w_old, sc_old, old.tables, k)
    box_old = qcont.encode_codes(codes_old, old, pool_slots_per_1k=1024)
    for fn in counters.values():
        fn.launches = 0
    res = train(cfg, comm="qlc", steps=6, registry=forced, adapt=True,
                adapt_every=1, **kw)
    for kname, c in launches.items():
        launches[kname] = c + counters[kname].launches
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} was not launched on the adapt "
                                 "path")
    events, swaps = res["adapt"]["events"], res["adapt"]["swaps"]
    if not events or events[0].name != "grads":
        raise AssertionError(f"adapt: the forced codec did not swap: "
                             f"{_check_lines(res)}")
    ev, sw = events[0], swaps[0]
    new = forced.by_id(ev.new_scheme_id)
    if (forced.by_id(ev.old_scheme_id) is not old
            or new.plan.chunk_symbols != k):
        raise AssertionError("adapt: the old entry was not kept, or the "
                             "revision changed the chunk size")
    after = [c["measured_bits"] for c in res["adapt"]["checks"]
             if c["name"] == "grads" and c["scheme_id"] == new.scheme_id]
    n = res["step"].geometry(res["params"]).n_padded
    step_ms = [h["dt"] * 1e3 for h in res["history"]]
    swap_ms = (sw["check_s"] + sw["rebuild_s"]) * 1e3
    log("adapt", f"forced swap (grads codec from the parameters' "
                 f"histogram): {_check_lines(res)}")
    log("adapt", f"forced swap at step {sw['step'] + 1}: grads scheme-id "
                 f"{ev.old_scheme_id} -> {ev.new_scheme_id}; measured "
                 f"{ev.measured_bits:.4f} bits/symbol before (planned "
                 f"{ev.old_expected_bits:.4f}), "
                 f"{after[0] if after else float('nan'):.4f} after (planned "
                 f"{ev.new_expected_bits:.4f}); wire "
                 f"{_wire_bytes_per_symbol(old, n):.4f} -> "
                 f"{_wire_bytes_per_symbol(new, n):.4f} B/symbol; swap "
                 f"{swap_ms:.3f} ms (check and recalibration "
                 f"{sw['check_s'] * 1e3:.3f}, step rebuild "
                 f"{sw['rebuild_s'] * 1e3:.3f}); {len(events)} swaps, "
                 f"fallbacks {res['comm_fallbacks']} (ok "
                 f"{[h['ok'] for h in res['history']]}); ms/step (the "
                 f"telemetry step, and the baseline step where it fell back) "
                 f"{[round(t, 3) for t in step_ms]} | {smi}")

    # After the swap: the old id's payloads beside gradient chunks
    # encoded under the new id, each part through the stacked tables.
    tables, id_map = forced.stacked_decode_tables([old.scheme_id,
                                                   new.scheme_id])
    cap_new = new.plan.capacity_words
    w_new, nb_new, sc_new, codes_new = ops.quantize_encode(
        g4, new.tables, cap_new, emit_codes=True)
    vals_new = ops.decode_dequantize(w_new, sc_new, new.tables, k)
    fit_old, fit_new = nb_old <= 32 * cap_old, nb_new <= 32 * cap_new
    m_old, m_new = int(fit_old.sum()), int(fit_new.sum())
    if min(m_old, m_new) < rows // 4:
        raise AssertionError(f"adapt: only {m_old} / {m_new} of {rows} "
                             "chunks fit their slots")
    cap = max(cap_old, cap_new)
    pad = torch.nn.functional.pad
    words = torch.cat([pad(w_old[fit_old], (0, cap - cap_old)),
                       pad(w_new[fit_new], (0, cap - cap_new))])
    sids = torch.tensor([int(id_map[old.scheme_id])] * m_old
                        + [int(id_map[new.scheme_id])] * m_new,
                        dtype=torch.int32, device=dev)
    out = ops.decode_dequantize(
        words, torch.cat([sc_old[fit_old], sc_new[fit_new]]), tables, k,
        scheme_ids=sids)
    err = require_equal("adapt: old- and new-id payloads after the swap "
                        "(K2, stacked)", [out[:m_old], out[m_old:]],
                        [vals_old[fit_old], vals_new[fit_new]])
    box_new = qcont.encode_codes(codes_new, new, pool_slots_per_1k=1024)
    both = qcont.decode_codes_stream(qcont.pack_stream([box_old, box_new]),
                                     forced, device=dev)
    if not all(ok and torch.equal(c, want.reshape(-1)) for (c, ok), want
               in zip(both, (codes_old, codes_new))):
        raise AssertionError("adapt: the old-id codes container does not "
                             "decode after the swap (K4, stacked)")
    log("adapt", f"after the swap: {m_old} parameter chunks encoded under "
                 f"id {old.scheme_id} before it and {m_new} gradient chunks "
                 f"under id {new.scheme_id} (those of {rows} that fit "
                 f"their slots) decode in one stacked K2 launch bit-equal to each "
                 f"id's own decode; the old-id codes container and a new-id "
                 f"one in one stream decode in one stacked K4 launch, each "
                 f"== its codes")
    census = adapt_escape_census(
        ops, cfg, dev, seq_len, global_batch,
        {"calibrated": tr["registry"]["grads"], "forced": old,
         "revision": new})
    return {"launches": launches, "telemetry": tel, "k1_hist": k1,
            "real": real_out, "err": err, "census": census,
            "forced": {"step": sw["step"] + 1, "old_id": ev.old_scheme_id,
                       "new_id": ev.new_scheme_id,
                       "measured_before": ev.measured_bits,
                       "measured_after": after[0] if after else None,
                       "planned_before": ev.old_expected_bits,
                       "planned_after": ev.new_expected_bits,
                       "wire_before": _wire_bytes_per_symbol(old, n),
                       "wire_after": _wire_bytes_per_symbol(new, n),
                       "swap_ms": swap_ms, "swaps": len(events),
                       "fallbacks": res["comm_fallbacks"],
                       "step_ms": step_ms}}


#: deepseek-moe-16b layers the moe phase keeps (of 28): f32 parameters,
#: gradients and AdamW moments of one layer with the 102400-token
#: embeddings and head are ~16 GB before the steps' copies.
MOE_LAYERS = 1


def _moe_cell(cfg=None):
    """The moe cell's config (deepseek-moe-16b, ``MOE_LAYERS`` of 28
    layers), or ``cfg``."""
    import dataclasses
    from repro_torch.configs import get_config
    return cfg or dataclasses.replace(get_config("deepseek-moe-16b"),
                                      num_layers=MOE_LAYERS)


def _with_impl(cfg, impl, **over):
    import dataclasses
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl=impl, **over))


def _same_leaves(what: str, a, b):
    from repro_torch.models.transformer import pytree_leaves
    la, lb = pytree_leaves(a), pytree_leaves(b)
    if len(la) != len(lb) or not all(torch.equal(x, y)
                                     for x, y in zip(la, lb)):
        raise AssertionError(f"{what}: parameters differ")
    return sum(t.numel() for t in la)


def moe_wire_fused(ops, ref, entry, vals, flush, rows=4096):
    """K1 and K2's f32 form at the expert wire's own shape: one
    direction's real all-to-all payload as chunks of the plan's size at
    its slot, with its calibrated codec; each bit-equal to its plain
    version on the first and last ``rows`` chunks and timed beside its
    HBM bound."""
    k, cap = entry.plan.chunk_symbols, entry.plan.capacity_words
    t = entry.tables
    x = vals.reshape(-1, k)
    n = x.shape[0]
    words, nb, sc = ops.quantize_encode(x, t, cap)
    out = ops.decode_dequantize(words, sc, t, k)
    err = {"K1": 0.0, "K2": 0.0}
    for r0 in sorted({0, max(0, n - rows)}):
        sl = slice(r0, r0 + rows)
        err["K1"] = max(err["K1"], require_equal(
            f"K1 moe wire rows {r0}:{r0 + rows}", [words[sl], nb[sl],
                                                   sc[sl]],
            ref.quantize_encode_ref(x[sl], t, cap)))
        err["K2"] = max(err["K2"], require_equal(
            f"K2 moe wire rows {r0}:{r0 + rows}", [out[sl]],
            [ref.decode_dequantize_ref(words[sl], sc[sl], [t], 0, k)]))
    res = {
        "K1": {"shape": [n, k], "dtype": str(x.dtype), "cap": cap,
               "max_abs_err": err["K1"],
               "ms": time_ms(lambda: ops.quantize_encode(x, t, cap), 5,
                             flush),
               "kernel_ms": time_ms(bare_k1(x, t, cap), 5, flush,
                                    alone=True),
               "bound_ms": bound_ms("quantize_encode", x, t, cap)},
        "K2": {"shape": [n, cap], "form": "f32", "max_abs_err": err["K2"],
               "ms": time_ms(lambda: ops.decode_dequantize(words, sc, t, k),
                             5, flush),
               "kernel_ms": time_ms(bare_k2(words, sc, t, k), 5, flush,
                                    alone=True),
               "bound_ms": bound_ms("decode_dequantize", words, sc, t, k)}}
    for kname, v in res.items():
        log("moe", f"{kname} at the expert wire's shape {v['shape']} (slot "
                   f"{cap} words, {entry.name}): bit-equal to plain on the "
                   f"first and last {rows} chunks; {v['ms']:.3f} ms (kernel "
                   f"alone {v['kernel_ms']:.3f}), HBM bound "
                   f"{v['bound_ms']:.3f} ms")
    return res


def moe_wire_overflow(entry, buf, dev="cuda", chunks=256):
    """The expert wire past an overflowing pool: ``chunks`` chunks of the
    layer's real dispatch payload through ``Channel.all_to_all`` on the
    card's one rank, at half the codec's slot and one pool slot a 1k, are
    bit-equal to the plain route's decode of the same payload on the CPU
    (the reference's values, the last pool row's past the pool) and
    report ``ok`` False, as on the CPU."""
    import torch.distributed as dist
    from repro_torch.comm.channel import Channel, ChannelSpec
    from repro_torch.comm.compressed import CommConfig
    cfg = CommConfig.from_plan(entry.plan,
                               capacity_words=entry.plan.capacity_words // 2,
                               pool_slots_per_1k=1)
    ch = Channel(ChannelSpec(codec=entry.tables, cfg=cfg,
                             group=dist.group.WORLD))
    x = buf.reshape(1, -1)[:, :chunks * cfg.chunk_symbols].float()
    got, ok = ch.all_to_all(x)
    p, sc = ch.compress(x.cpu())
    want, ok_cpu = ch.decompress(p, sc)
    past = int(p.flags.sum()) - p.pool.shape[-2]
    if past <= 0 or bool(ok.all()) or bool(ok_cpu.all()):
        raise AssertionError(f"moe overflow check: {past} chunks past the "
                             f"pool, ok {ok.tolist()} / {ok_cpu.tolist()}")
    if not torch.equal(got.cpu(), want.reshape(got.shape)):
        raise AssertionError("moe: the card's expert wire past an overflowed "
                             "pool differs from the plain route's values")
    log("moe", f"expert wire past an overflowing pool ({chunks} chunks of "
               f"the dispatch payload, {cfg.capacity_words}-word slots, "
               f"{p.pool.shape[-2]} pool slot(s), {past} chunks past it): "
               f"the card's Channel.all_to_all == the plain decode on the "
               f"CPU, bit-equal; ok False on both")


def phase_moe(qf, qc, h6, ops, ref, flush, dev="cuda", cfg=None,
              seq_len=512, global_batch=4, steps=3):
    """deepseek-moe-16b at full width, ``MOE_LAYERS`` layer(s), batch
    ``global_batch`` x ``seq_len`` of the reference's synthetic stream, on
    a 1 x 1 layout of one NCCL rank: the three dispatch impls on one
    layer's real input (routing, keep mask and drops equal; grouped(1)
    and raw expert parallelism bit-equal to gspmd); the expert wire's
    calibration (K6 counts equal to ``np.bincount``); ``train(comm=
    "baseline", moe_wire="qlc")`` against its raw e4m3 twin (bit-equal)
    and ``moe_wire="raw"``; ``train(comm="qlc", moe_wire="qlc")`` against
    its twin (bit-equal). K1-K6 counted from zero around the calibration
    and the runs. Returns the launches, K1/K2 at the wire's shape and
    the numbers the phase prints."""
    from repro_torch.comm import calibrate
    from repro_torch.comm.channel import Channel, ChannelSpec
    from repro_torch.core import CodecRegistry
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import init_params, moe, next_token_loss
    cfg = _moe_cell(cfg)
    m = cfg.moe
    n_tok = global_batch * seq_len
    log("moe", f"{cfg.name}: {cfg.num_layers} of 28 layers (cut: f32 "
               f"params, grads and AdamW moments), d_model {cfg.d_model}, "
               f"{cfg.num_heads} heads x {cfg.resolved_head_dim}, "
               f"{m.num_experts} routed experts top-{m.top_k} of width "
               f"{m.d_expert} + {m.num_shared_experts} shared, vocab "
               f"{cfg.vocab_size}, params {cfg.param_dtype}, compute "
               f"{cfg.dtype}, remat {cfg.remat}; global batch "
               f"{global_batch} x {seq_len}, one NCCL rank, layout 1 x 1")
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mesh = make_test_mesh(model=1)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    n_params = sum(t.numel() for t in _leaves(params))
    b0 = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=seq_len,
                                     global_batch=global_batch)).batch_at(0)
    b0 = {k: torch.as_tensor(v).to(dev) for k, v in b0.items()}

    # 1. The three impls on the first layer's real input.
    gspmd = _with_impl(cfg, "gspmd")
    captured = []
    with torch.no_grad(), moe.capture_moe_traffic(captured):
        next_token_loss(params, _with_impl(gspmd, "gspmd"), b0["tokens"],
                        b0["labels"])
    lp, x = captured[0]
    outs, routes, impl_ms = {}, {}, {}
    with torch.no_grad(), use_mesh(mesh), moe.bind_moe_channels(None):
        for name, c in (("gspmd", gspmd),
                        ("grouped_local(1)", _with_impl(
                            cfg, "grouped_local", dispatch_groups=1)),
                        ("shardmap_a2a raw", _with_impl(cfg,
                                                        "shardmap_a2a"))):
            rec = []
            with moe.capture_moe_routing(rec):
                outs[name] = moe.moe_block(lp, x, c)
            routes[name] = rec[0]
            impl_ms[name] = time_ms(lambda: moe.moe_block(lp, x, c), 3,
                                    flush)
    capacity = moe._capacity(n_tok, m)
    ref_r = routes["gspmd"]
    drops = int((~ref_r["keep"]).sum())
    load = torch.bincount(ref_r["idx"].reshape(-1),
                          minlength=m.num_experts)
    for name in outs:
        r = routes[name]
        if not (torch.equal(r["idx"], ref_r["idx"])
                and torch.equal(r["keep"], ref_r["keep"])):
            raise AssertionError(f"moe: {name}'s routing or keep mask "
                                 "differs from gspmd's")
        if not torch.equal(outs[name], outs["gspmd"]):
            raise AssertionError(f"moe: {name}'s output is not bit-equal "
                                 "to gspmd's")
    log("moe", f"one layer's input {list(x.shape)} {x.dtype}: gspmd, "
               f"grouped_local(1) and raw shardmap_a2a route alike (idx, "
               f"keep mask), capacity {capacity} per expert, "
               f"{drops} of {ref_r['keep'].numel()} assignments dropped "
               f"in each (expert loads {int(load.min())}-{int(load.max())},"
               f" {int((load > capacity).sum())} of {m.num_experts} over "
               f"capacity); outputs bit-equal to gspmd; ms "
               + ", ".join(f"{k} {v:.3f}" for k, v in impl_ms.items()))
    del outs, routes

    counters = {"K1": qf.fused_encode, "K2": qf.fused_decode,
                "K3": qc.encode, "K4": qc.decode, "K5": qc.prefetch_decode,
                "K6": h6.histogram256}
    for fn in counters.values():
        fn.launches = 0

    # 2. The expert wire's codecs (K6 counts each direction's symbols).
    t0 = time.perf_counter()
    reg = CodecRegistry()
    calibrate.calibrate_moe_entries(reg, cfg, params, b0)
    calib_ms = (time.perf_counter() - t0) * 1e3
    k6_calib = h6.histogram256.launches
    launches = {k: fn.launches for k, fn in counters.items()}
    with torch.no_grad():
        layers = [moe.dispatch_traffic(p, xi, cfg) for p, xi in captured]
    del captured
    # The first layer's buffers are its all-to-all payloads (1 x 1).
    payloads = dict(zip((moe.MOE_DISPATCH, moe.MOE_COMBINE), layers[0]))
    for j, name in enumerate(payloads):
        syms = calibrate.kv_symbol_stream([bufs[j] for bufs in layers],
                                          mode="e4m3")
        want = np.maximum(np.bincount(syms.cpu().numpy(), minlength=256)
                          .astype(np.float64), 1e-6)
        if not np.array_equal(reg[name].counts, want):
            raise AssertionError(f"moe: {name}'s K6 counts differ from "
                                 "np.bincount of its symbols")
    codecs = {n: (reg[n].scheme_id, reg[n].plan.expected_bits_per_symbol,
                  reg[n].plan.capacity_words, reg[n].plan.pool_slots_per_1k)
              for n in payloads}
    log("moe", f"calibrate_moe_entries {calib_ms:.1f} ms ({k6_calib} K6 "
               f"launches, counts equal to np.bincount of each direction's "
               f"{syms.numel()} symbols): "
               + "; ".join(f"{n} scheme-id {v[0]}, planned {v[1]:.4f} "
                           f"bits/symbol, {v[2]}-word slots, pool {v[3]}/1k"
                           for n, v in codecs.items()))
    # Channel.wire_bytes of the real payloads (1 x 1: a direction's whole
    # send buffer is the layer's dispatch / combine buffer).
    wire_real = {}
    for name, buf in payloads.items():
        ch = Channel(ChannelSpec(codec=name), registry=reg)
        p, sc = ch.compress(buf.reshape(1, -1))
        wire_real[name] = ch.wire_bytes(p, sc) / buf.numel()
        del p, sc
    moe_wire_overflow(reg[moe.MOE_DISPATCH], payloads[moe.MOE_DISPATCH],
                      dev)
    for fn in counters.values():
        fn.launches = 0
    fused = moe_wire_fused(ops, ref, reg[moe.MOE_DISPATCH],
                           payloads[moe.MOE_DISPATCH], flush)
    del payloads, layers, lp, x, syms
    for fn in counters.values():
        fn.launches = 0

    # 3. The expert wire in baseline training, its twin, and raw.
    kw = dict(steps=steps, seq_len=seq_len, global_batch=global_batch,
              device=dev, transport="oneshot", seed=0, params=params)
    runs = {}

    def run(name, **over):
        before = {k: fn.launches for k, fn in counters.items()}
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        res = train(cfg, **kw, **over)
        hist = res["history"]
        if not all(h["ok"] for h in hist) or res["comm_fallbacks"] \
                or not all(math.isfinite(h["loss"]) for h in hist):
            raise AssertionError(f"moe {name}: ok {[h['ok'] for h in hist]}"
                                 f", fallbacks {res['comm_fallbacks']}, "
                                 f"losses {[h['loss'] for h in hist]}")
        runs[name] = {
            "losses": [h["loss"] for h in hist],
            "step_ms": [h["dt"] * 1e3 for h in hist],
            "launches": {k: fn.launches - before[k]
                         for k, fn in counters.items() if k in ("K1", "K2")},
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if dev == "cuda" else float("nan"))}
        return res

    with use_mesh(mesh):
        q = run("baseline, qlc expert wire", comm="baseline", moe_wire="qlc",
                registry=reg)
        rep = q["moe"]
        for name, r in rep.items():
            if r["wire_bytes_per_symbol"] != wire_real[name]:
                raise AssertionError(f"moe: {name} measured wire B/symbol "
                                     f"{r['wire_bytes_per_symbol']} != "
                                     f"{wire_real[name]} of the real payload")
        q_params = q["params"]
        del q
        t = run("baseline, raw e4m3 twin", comm="baseline", moe_wire="qlc",
                registry=reg, wire_enabled=False)
        if [h["loss"] for h in t["history"]] != \
                runs["baseline, qlc expert wire"]["losses"]:
            raise AssertionError("moe: the QLC expert wire's losses differ "
                                 "from its raw e4m3 twin's")
        n_eq = _same_leaves("moe: QLC expert wire vs raw e4m3 twin",
                            q_params, t["params"])
        del q_params, t
        run("baseline, raw wire (gspmd)", comm="baseline", moe_wire="raw")
        log("moe", f"baseline training with the QLC expert wire == its raw "
                   f"e4m3 twin after {steps} steps: losses and {n_eq} "
                   "parameters bit-equal; per direction measured wire "
                   "B/symbol (Channel.all_to_all of the last step's payload "
                   "== Channel.wire_bytes of the real payload) vs modeled: "
                   + "; ".join(f"{n} {r['wire_bytes_per_symbol']:.4f} vs "
                               f"{r['modeled_wire_bytes_per_symbol']:.4f}"
                               for n, r in rep.items()))

        # 4. Both wires compressed (the gradient codec calibrated by K6,
        # the expert wire's anew into the same registry).
        c = run("qlc, qlc expert wire", comm="qlc", moe_wire="qlc")
        c_reg, c_params = c["registry"], c["params"]
        grads_b = c["grads_wire_bytes_per_symbol"]
        params_b = c["params_wire_bytes_per_symbol"]
        g = c_reg["grads"].plan
        del c
        ct = run("qlc, raw e4m3 twin", comm="qlc", moe_wire="qlc",
                 registry=c_reg, wire_enabled=False)
        if [h["loss"] for h in ct["history"]] != \
                runs["qlc, qlc expert wire"]["losses"]:
            raise AssertionError("moe: the compressed run's losses differ "
                                 "from its raw e4m3 twin's")
        n_eq = _same_leaves("moe: both wires compressed vs raw e4m3 twin",
                            c_params, ct["params"])
        del c_params, ct
    for name, r in runs.items():
        log("moe", f"{name}: {steps} steps {[round(v, 3) for v in r['step_ms']]}"
                   f" ms, losses {r['losses']}, K1/K2 launches "
                   f"{r['launches']['K1']}/{r['launches']['K2']} in the run "
                   f"({r['launches']['K1'] / steps:.1f}/"
                   f"{r['launches']['K2'] / steps:.1f} a step, its "
                   f"calibration included), peak device memory "
                   f"{r['peak_gib']:.2f} GiB")
    log("moe", f"both wires compressed == raw e4m3 twin after {steps} steps "
               f"({n_eq} parameters bit-equal); gradient wire {grads_b:.4f} "
               f"B/symbol ({g.expected_bits_per_symbol:.4f} planned "
               f"bits/symbol, {g.capacity_words}-word slots, pool "
               f"{g.pool_slots_per_1k}/1k), parameter wire {params_b:.4f} "
               f"B/symbol; {n_params} parameters")
    launches = {k: launches[k] + fn.launches for k, fn in counters.items()}
    for kname in ("K1", "K2", "K6"):
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} was not launched on the moe path")
    del params
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "fused": fused, "runs": runs,
            "codecs": codecs, "wire": rep, "grads_wire": grads_b,
            "params_wire": params_b, "drops": drops}


#: deepseek-moe-16b layers the moe_serve phase keeps (of 28): 23 is the
#: deepest that leaves over 8 GiB of the card free; 14 kept the whole
#: script under 900 s of its 1200 s limit once the tp phase grew, and 7
#: keeps it within 1,000 s on a slow host.
MOE_SERVE_LAYERS = 7


def _nest(key: str, value):
    """``value`` at path ``key`` of an otherwise empty tree."""
    for part in reversed(key.split("/")):
        value = {part: value}
    return value


def _moe_serve_cell(cfg=None):
    """The moe_serve cell's config (deepseek-moe-16b, ``MOE_SERVE_LAYERS``
    of 28 layers), or ``cfg``."""
    import dataclasses
    from repro_torch.configs import get_config
    return cfg or dataclasses.replace(get_config("deepseek-moe-16b"),
                                      num_layers=MOE_SERVE_LAYERS)


def wire_leaf_fused(ops, ref, wc, wired, key, flush, rows=4096,
                    phase="moe_serve"):
    """K2 and K1 at a wired leaf's path shape: K2 opens the stacked
    leaf's words ([G * n_chunks, cap], as ``open_params`` does), and K1
    encodes those values back ([G * n_chunks, 1024] into 353-word slots,
    as ``compress_params_for_serving`` does); each bit-equal to its plain
    version on the first and last ``rows`` chunks and timed beside its
    HBM bound."""
    from repro_torch.core import codec
    m = wc.meta[key]
    tables = wc.registry.by_id(m.scheme_id).tables
    node = _node(wired, key)
    w = node["words"].reshape(-1, m.capacity_words)
    sc = node["scales"].float().reshape(-1, 32)
    vals = ops.decode_dequantize(w, sc, tables, 1024)
    cap = codec.worst_case_words(1024)
    enc = ops.quantize_encode(vals, tables, cap)
    n = w.shape[0]
    err = {"K1": 0.0, "K2": 0.0}
    for r0 in sorted({0, max(0, n - rows)}):
        sl = slice(r0, r0 + rows)
        err["K2"] = max(err["K2"], require_equal(
            f"K2 {key} rows {r0}:{r0 + rows}", [vals[sl]],
            [ref.decode_dequantize_ref(w[sl], sc[sl], [tables], 0, 1024)]))
        err["K1"] = max(err["K1"], require_equal(
            f"K1 {key} rows {r0}:{r0 + rows}",
            [t[sl] for t in enc],
            ref.quantize_encode_ref(vals[sl], tables, cap)))
    res = {
        "K2": {"shape": [n, m.capacity_words], "form": "f32",
               "max_abs_err": err["K2"],
               "ms": time_ms(lambda: ops.decode_dequantize(w, sc, tables,
                                                           1024), 3, flush),
               "kernel_ms": time_ms(bare_k2(w, sc, tables, 1024), 3, flush,
                                    alone=True),
               "bound_ms": bound_ms("decode_dequantize", w, sc, tables,
                                    1024)},
        "K1": {"shape": [n, 1024], "cap": cap, "max_abs_err": err["K1"],
               "ms": time_ms(lambda: ops.quantize_encode(vals, tables, cap),
                             3, flush),
               "kernel_ms": time_ms(bare_k1(vals, tables, cap), 3, flush,
                                    alone=True),
               "bound_ms": bound_ms("quantize_encode", vals, tables, cap)}}
    for kname, v in res.items():
        log(phase, f"{kname} at the wired leaf {key} {v['shape']}: "
                   f"bit-equal to plain on the first and last {rows} "
                   f"chunks; {v['ms']:.3f} ms (kernel alone "
                   f"{v['kernel_ms']:.3f}), HBM bound {v['bound_ms']:.3f} ms")
    return res


def phase_moe_serve(qf, qc, h6, ops, ref, serve_mod, flush, dev="cuda",
                    cfg=None, batch=4, requests=6, prompt_len=16,
                    new_tokens=16, kv_block=16):
    """Serving deepseek-moe-16b from the QLC weight wire, after the moe
    phase: full width, ``MOE_SERVE_LAYERS`` layers, random weights from a
    seed. Through ``launch.serve.serve``: calibrate (K1's histogram),
    compress (K1), free the init tree, open (K2) and serve ``requests``
    requests at ``batch``; then ``--kv-cache qlc`` sync (K3, K4) and
    async (K3, K5), the KV codecs calibrated through K6, each token-
    identical for every request to the dense run (inside ``serve``, and
    here to the first run). K1-K6 counted from zero around the three
    runs. Then K3-K6 against their plain versions on this model's KV
    data (``check_kv_path``); one layer's expert leaves wired in e4m3
    mode open (plain dequantize) bit-equal to the same leaves through
    QLC (K1, K2); the serving manifest with the KV recipe through JSON
    opens every wired leaf bit-identically; K2 and K1 at the expert
    leaf's path shape against their plain versions. Returns the
    launches, the path timings and the phase's numbers."""
    import json
    from repro_torch.models import moe
    from repro_torch.serving import (KVCacheSpec, codec_from_manifest,
                                     compress_params_for_serving,
                                     kv_spec_from_manifest, open_params,
                                     serving_manifest)
    cfg = _moe_serve_cell(cfg)
    m = cfg.moe
    log("moe_serve", f"{cfg.name}: {cfg.num_layers} of 28 layers (cut: "
                     f"f32 params beside the wire), d_model {cfg.d_model}, "
                     f"{cfg.num_heads} heads x {cfg.resolved_head_dim}, "
                     f"{m.num_experts} routed experts top-{m.top_k} of "
                     f"width {m.d_expert} + {m.num_shared_experts} shared, "
                     f"vocab {cfg.vocab_size}, params {cfg.param_dtype}, "
                     f"compute {cfg.dtype}, impl {m.impl}; {requests} "
                     f"requests at batch {batch}, prompt {prompt_len}, "
                     f"{new_tokens} new tokens")
    if dev == "cuda":
        # Earlier phases' tensors that only reference cycles still hold
        # would go here, before the peak (8.9 GiB of them before the
        # port's cycles were broken).
        held = torch.cuda.memory_allocated()
        gc.collect()
        log("moe_serve", f"gc.collect() freed "
                         f"{held - torch.cuda.memory_allocated()} B of device "
                         "memory held only by reference cycles")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log("moe_serve", f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                         "held by earlier phases at the start")
    counters = {"K1": qf.fused_encode, "K2": qf.fused_decode,
                "K3": qc.encode, "K4": qc.decode, "K5": qc.prefetch_decode,
                "K6": h6.histogram256}
    for fn in counters.values():
        fn.launches = 0
    kw = dict(batch=batch, requests=requests, prompt_len=prompt_len,
              new_tokens=new_tokens, device=dev, seed=0)

    # 1. The wire and the dense run.
    rec = []
    t0 = time.perf_counter()
    with moe.capture_moe_routing(rec):
        res = serve_mod.serve(cfg, wire="qlc", **kw)
    run_s = {"dense": time.perf_counter() - t0}
    wc, wired, opened = res["wire_codec"], res["wired"], res["params"]
    outs = res["outs"]
    if not all(o.state == "finished" and len(o.tokens) == new_tokens
               for o in outs):
        raise AssertionError([(o.request_id, o.state) for o in outs])
    dense = [o.tokens for o in outs]
    prompt0 = res["prompts"][0]
    wire_b = sym = 0
    for key, lm in wc.meta.items():
        node = _node(wired, key)
        wire_b += nbytes(node["words"], node["scales"])
        sym += lm.n_symbols * node["words"].shape[0]
    prefill = [r for r in rec if r["idx"].shape[0] != batch]
    decode = [r for r in rec if r["idx"].shape[0] == batch]
    if any(bool((~r["keep"]).any()) for r in prefill):
        raise AssertionError("moe_serve: a batch-1 prefill step dropped")
    per_step = [sum(int((~r["keep"]).sum()) for r in
                    decode[i:i + cfg.num_layers])
                for i in range(0, len(decode), cfg.num_layers)]
    del rec, prefill, decode
    st = res["stats"]
    stats = {"dense": {"prefill": st["ms_per_token_prefill"],
                       "decode": st["ms_per_token_decode"]}}
    capacity = max(1, int(batch * m.top_k * m.capacity_factor
                          // m.num_experts))
    log("moe_serve", f"calibrate {res['calibrate_s'] * 1e3:.1f} ms, "
                     f"compress {res['compress_s'] * 1e3:.1f} ms, open "
                     f"{res['open_s'] * 1e3:.1f} ms; {len(wc.meta)} "
                     f"compressed leaves, {sym} symbols, wire {wire_b} B = "
                     f"{wire_b / sym:.4f} B/symbol (words + bf16 scales)")
    log("moe_serve", f"dense run: {len(outs)} requests, "
                     f"{st['ms_per_token_prefill']:.3f} ms/token prefill, "
                     f"{st['ms_per_token_decode']:.3f} ms/token decode "
                     f"({run_s['dense']:.1f} s with the wire); decode "
                     f"steps at batch {batch}, capacity {capacity} per "
                     f"expert: {len(per_step)} steps, drops per step "
                     f"{per_step} ({sum(per_step) / max(1, len(per_step)):.2f}"
                     f" a step of {batch * m.top_k * cfg.num_layers} "
                     "assignments); prefill (batch 1) drops none")
    res = None

    # 2. The paged QLC KV cache, sync then async: every request's tokens
    # equal the dense run's (checked inside serve against its own dense
    # run of the same requests, and here against the first run).
    pool = {}
    for paging in ("sync", "async"):
        t0 = time.perf_counter()
        r = serve_mod.serve(cfg, params=opened, kv_cache="qlc",
                            kv_block=kv_block, kv_paging=paging, **kw)
        run_s[paging] = time.perf_counter() - t0
        got = [o.tokens for o in r["outs"]]
        if len(got) != len(dense) or not all(
                np.array_equal(a, b) for a, b in zip(got, dense)):
            raise AssertionError(f"moe_serve: the {paging} paged run's "
                                 "tokens differ from the dense run's")
        st = r["stats"]
        stats[paging] = {"prefill": st["ms_per_token_prefill"],
                         "decode": st["ms_per_token_decode"]}
        ps = st["pool"]
        pool[paging] = ps["peak_referenced_bytes"] / \
            st["peak_dense_logical_bytes"]
        log("moe_serve", f"--kv-cache qlc --kv-block {kv_block} "
                         f"--kv-paging {paging}: every request's tokens == "
                         f"the dense run's; {st['ms_per_token_prefill']:.3f} "
                         f"ms/token prefill, {st['ms_per_token_decode']:.3f} "
                         f"decode; pooled/dense KV bytes {pool[paging]:.4f}"
                         f" ({run_s[paging]:.1f} s, the serve's own dense "
                         "check included)")
        del r
    launches = {k: fn.launches for k, fn in counters.items()}
    for kname, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{kname} was not launched on the "
                                 "moe_serve path")
    path_peak = (torch.cuda.max_memory_allocated() / 2**30
                 if dev == "cuda" else float("nan"))
    log("moe_serve", "launches on the path (the three runs): "
                     + ", ".join(f"{k} {v}" for k, v in launches.items())
                     + f"; peak device memory {path_peak:.2f} GiB")

    # 3. K3-K6 against their plain versions on this model's KV data: its
    # kv heads' byte planes at the slot caps its codecs calibrate.
    kv = check_kv_path(ops, ref, cfg, opened, prompt0, flush, dev=dev,
                       phase="moe_serve")

    # 4. One layer's expert leaves from an e4m3-mode wire == through QLC.
    layer = {k: opened["groups"]["l0"]["ffn"][k][:1]
             for k in moe.EXPERT_LEAVES}
    wq, wcq = compress_params_for_serving(layer, wc.registry)
    we, wce = compress_params_for_serving(layer, wc.registry, mode="e4m3")
    oq, oe = open_params(wq, wcq), open_params(we, wce)
    for k in moe.EXPERT_LEAVES:
        if not torch.equal(oq[k], oe[k]):
            raise AssertionError(f"moe_serve: expert leaf {k} opened from "
                                 "the e4m3 wire differs from QLC's")
    e4_b = sum(nbytes(*we[k].values()) for k in we)
    q_b = sum(nbytes(*wq[k].values()) for k in wq)
    n_e = sum(layer[k].numel() for k in layer)
    log("moe_serve", f"layer 0's expert leaves ({n_e} values): the e4m3 "
                     "wire (plain dequantize) opens bit-equal to the QLC "
                     f"wire (K1, K2); {e4_b / n_e:.4f} against "
                     f"{q_b / n_e:.4f} B/symbol")
    del layer, wq, we, oq, oe

    # 5. The manifest, with the KV recipe, through JSON.
    spec = KVCacheSpec(block_tokens=kv_block)
    man = json.loads(json.dumps(serving_manifest(wc, kv_spec=spec)))
    if kv_spec_from_manifest(man["kv"])[0] != spec:
        raise AssertionError("moe_serve: the manifest's KV spec differs")
    wc2 = codec_from_manifest(man)
    n_open = 0
    for key, lm in wc.meta.items():
        node = _node(wired, key)
        step = max(1, (1 << 28) // lm.n_symbols)
        for g in range(0, node["words"].shape[0], step):
            part = {k: v[g:g + step] for k, v in node.items()}
            got = _node(open_params(_nest(key, part), wc2), key)
            if not torch.equal(got, _node(opened, key)[g:g + step]):
                raise AssertionError(f"moe_serve: {key}[{g}] opened through "
                                     "the manifest differs")
            n_open += got.numel()
            del got
    log("moe_serve", f"codec_from_manifest(json(serving_manifest(wc, "
                     f"kv_spec=...))) opens all {len(wc.meta)} wired leaves "
                     f"({n_open} values) bit-identically "
                     f"({len(json.dumps(man))} B of JSON)")

    # 6. K2 and K1 at the expert leaf's path shape, the opened tree freed.
    opened = None
    if dev == "cuda":
        torch.cuda.empty_cache()
    fused = wire_leaf_fused(ops, ref, wc, wired, "groups/l0/ffn/w_in", flush)
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if dev == "cuda" else float("nan"))
    free = ((torch.cuda.get_device_properties(0).total_memory
             - torch.cuda.max_memory_reserved()) / 2**30
            if dev == "cuda" else float("nan"))
    log("moe_serve", f"peak device memory over the phase {peak:.2f} GiB "
                     f"(the path's {path_peak:.2f}); {free:.2f} GiB of the "
                     "card never reserved")
    del wired, wc, wc2
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "fused": fused, "kv": kv,
            "ms_per_token": stats,
            "drops_per_step": per_step, "wire_bytes_per_symbol": wire_b / sym,
            "pool": pool, "peak_gib": peak, "path_peak_gib": path_peak,
            "free_gib": free, "run_s": run_s}


SSM_ARCH = "xlstm-125m"
#: 512 took 28.4-29.7 s a step (the eager recurrence), over the 15 s the
#: phase allows a step, so the train cell was cut to 256; on a slow host
#: 256 took 16.5-17.3 s a step, so it is cut to 128
SSM_TRAIN_SEQ = 128


def phase_ssm(qf, qc, h6, ops, ref, serve_mod, flush, dev="cuda", cfg=None,
              batch=4, requests=6, prompt_len=16, new_tokens=16, kv_block=16,
              seq_len=SSM_TRAIN_SEQ, global_batch=4, mamba_cfg=None):
    """xlstm-125m (every layer, full width, f32 parameters, bf16 compute,
    random weights from a seed) served and trained on the card, and one
    mamba layer at jamba-1.5-large's widths. Serving through
    ``launch.serve.serve``: the weight wire (calibrate with K1's
    histogram, compress K1, open K2) and a dense run; then ``--kv-cache
    qlc --kv-block 16`` sync (K3, K4) and async (K3, K5), the KV codecs
    calibrated on the recurrent states through K6, re-based snapshots;
    every request's tokens equal the dense run's. A pair of requests
    sharing a two-block prompt prefix, paged sync and async: their
    re-based snapshots dedup, and their tokens equal each alone on the
    dense engine. K3-K6 against their plain versions on the mLSTM
    layer's snapshot planes (``check_kv_path``), K1/K2 at the mLSTM
    ``wq`` leaf's wire shape. Kernel launches of one decode step and one
    training forward and backward (torch.profiler). Training:
    ``train(comm="qlc")`` on one NCCL rank at ``global_batch x
    seq_len``, oneshot, 2 compressed steps, 2 of the raw e4m3 twin from
    the same registry (parameters bit-equal), 2 baseline steps. The
    mamba layer: a 16-token segment from a fresh state, then 8 decode
    steps from its state, equal within rtol 1e-4 / atol 1e-5 (f32
    compute) to one 24-token segment, outputs and state; its state
    through K3 then K4 bit for bit. K1-K6 counted from zero around the
    serve runs, the train runs and the mamba round trip; each must
    launch."""
    import dataclasses
    from repro_torch.roofline.trace import launch_profile
    from repro_torch.comm.calibrate import calibrate_kv_entries
    from repro_torch.configs import get_config
    from repro_torch.core import CodecRegistry
    from repro_torch.launch.mesh import data_parallel
    from repro_torch.launch.train import train
    from repro_torch.models import ssm
    from repro_torch.serving import (Engine, GenerationRequest, KVCacheSpec,
                                     PagedKVCache)
    cfg = cfg or get_config(SSM_ARCH)
    kinds = cfg.layer_kinds()
    log("ssm", f"{cfg.name}: all {cfg.num_layers} layers ("
               f"{'/'.join(kinds)} alternating), d_model {cfg.d_model}, "
               f"{cfg.num_heads} heads x {cfg.resolved_head_dim}, d_ff "
               f"{cfg.d_ff}, vocab {cfg.vocab_size}, params "
               f"{cfg.param_dtype}, compute {cfg.dtype}; {requests} requests "
               f"at batch {batch}, prompt {prompt_len}, {new_tokens} new "
               f"tokens; train {global_batch} x {seq_len}")
    counters = {"K1": qf.fused_encode, "K2": qf.fused_decode,
                "K3": qc.encode, "K4": qc.decode, "K5": qc.prefetch_decode,
                "K6": h6.histogram256}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kw = dict(batch=batch, requests=requests, prompt_len=prompt_len,
              new_tokens=new_tokens, device=dev, seed=0)

    # 1. The wire and the dense run.
    zero()
    t0 = time.perf_counter()
    res = serve_mod.serve(cfg, wire="qlc", **kw)
    run_s = {"dense": time.perf_counter() - t0}
    wc, wired, opened = res["wire_codec"], res["wired"], res["params"]
    outs = res["outs"]
    if not all(o.state == "finished" and len(o.tokens) == new_tokens
               for o in outs):
        raise AssertionError([(o.request_id, o.state) for o in outs])
    dense = [o.tokens for o in outs]
    prompt0 = res["prompts"][0]
    n_params = sum(t.numel() for t in _leaves(opened))
    wire_b = sym = 0
    for key, lm in wc.meta.items():
        node = _node(wired, key)
        wire_b += nbytes(node["words"], node["scales"])
        sym += lm.n_symbols * node["words"].shape[0]
    st = res["stats"]
    stats = {"dense": {"prefill": st["ms_per_token_prefill"],
                       "decode": st["ms_per_token_decode"]}}
    log("ssm", f"{n_params} parameters; calibrate "
               f"{res['calibrate_s'] * 1e3:.1f} ms, compress "
               f"{res['compress_s'] * 1e3:.1f} ms, open "
               f"{res['open_s'] * 1e3:.1f} ms; {len(wc.meta)} compressed "
               f"leaves, {sym} symbols, wire {wire_b} B = "
               f"{wire_b / sym:.4f} B/symbol (words + bf16 scales); dense "
               f"run {st['ms_per_token_prefill']:.3f} ms/token prefill, "
               f"{st['ms_per_token_decode']:.3f} ms/token decode "
               f"({run_s['dense']:.1f} s with the wire)")
    res = None

    # 2. The paged cache, sync then async, every request == dense.
    pool = {}
    for paging in ("sync", "async"):
        t0 = time.perf_counter()
        r = serve_mod.serve(cfg, params=opened, kv_cache="qlc",
                            kv_block=kv_block, kv_paging=paging, **kw)
        run_s[paging] = time.perf_counter() - t0
        got = [o.tokens for o in r["outs"]]
        if len(got) != len(dense) or not all(
                np.array_equal(a, b) for a, b in zip(got, dense)):
            raise AssertionError(f"ssm: the {paging} paged run's tokens "
                                 "differ from the dense run's")
        st = r["stats"]
        stats[paging] = {"prefill": st["ms_per_token_prefill"],
                         "decode": st["ms_per_token_decode"]}
        ps = st["pool"]
        pool[paging] = ps["peak_referenced_bytes"] / \
            st["peak_dense_logical_bytes"]
        line = (f"--kv-cache qlc --kv-block {kv_block} --kv-paging {paging}:"
                f" every request's tokens == the dense run's; "
                f"{st['ms_per_token_prefill']:.3f} ms/token prefill, "
                f"{st['ms_per_token_decode']:.3f} decode; "
                f"{ps['unique_blocks']} snapshot containers, pooled/dense "
                f"bytes {pool[paging]:.4f} ({ps['peak_referenced_bytes']} "
                f"of {st['peak_dense_logical_bytes']}); {run_s[paging]:.1f}"
                " s with the serve's own dense check")
        if paging == "async":
            pf = st["prefetch"]
            line += (f"; {st['async']['windows']} windows, prefetch "
                     f"{pf['hits']}/{pf['scheduled']} hits, "
                     f"{pf['stalled']} stalled, {pf['misses']} misses")
            if pf["scheduled"] <= 0:
                raise AssertionError("ssm: no prefetch was scheduled")
        log("ssm", line)
        del r

    # 3. A shared two-block prefix: re-based snapshots dedup.
    rng = np.random.default_rng(7)
    pre = rng.integers(0, cfg.vocab_size, 2 * kv_block)
    pair = [np.concatenate([pre, rng.integers(0, cfg.vocab_size, 8)])
            for _ in range(2)]
    max_len = pair[0].size + 8 + 8

    def run(prompts, **ekw):
        eng = Engine(opened, cfg, max_seq_len=max_len, max_batch=batch,
                     **ekw)
        hs = [eng.submit(GenerationRequest(prompt=q, max_new_tokens=8))
              for q in prompts]
        eng.run()
        return [eng.poll(h).tokens for h in hs], eng.stats()

    solo = [run([q])[0][0] for q in pair]
    hits = {}
    for paging in ("sync", "async"):
        got, st = run(pair, kv_paging=paging, kv_spec=KVCacheSpec(
            block_tokens=kv_block, exact_capacity=paging == "sync"))
        if not all(np.array_equal(a, b) for a, b in zip(got, solo)):
            raise AssertionError(f"ssm: shared-prefix pair ({paging}) "
                                 "differs from its solo runs")
        hits[paging] = st["pool"]["dedup_hits"]
        if hits[paging] <= 0:
            raise AssertionError(f"ssm: the shared prefix's re-based "
                                 f"snapshots did not dedup ({paging})")
    log("ssm", f"two requests sharing a {2 * kv_block}-token prefix "
               f"(prompts of {pair[0].size}): tokens == each alone on the "
               f"dense engine; re-based snapshot dedup hits sync "
               f"{hits['sync']}, async {hits['async']} (2 boundaries x "
               f"{len(kinds)} layer slots, each stacking its "
               f"{cfg.num_layers // len(kinds)} groups)")
    launches = {"serve": read()}

    # 4. K3-K6 on the mLSTM layer's snapshot planes; K1/K2 at its wq leaf.
    mlstm = f"l{kinds.index('mlstm')}"
    kv = check_kv_path(ops, ref, cfg, opened, prompt0, flush, dev=dev,
                       phase="ssm", layer=mlstm)
    fused = wire_leaf_fused(ops, ref, wc, wired,
                            f"groups/{mlstm}/mixer/wq", flush, phase="ssm")
    del wired, wc
    prof = launch_profile(cfg, opened, dev) if dev == "cuda" else None
    if prof is not None:
        d, t = prof["decode"], prof["train"]
        log("ssm", f"one decode step (batch {batch}): {d['launches']} kernel "
                   f"launches, {d['busy_ms']} ms of kernels, "
                   f"{d['wall_ms']:.3f} ms wall; one training forward + "
                   f"backward (remat recompute included) at "
                   f"{prof['train_shape']}: {t['launches']} launches, "
                   f"{t['busy_ms']} ms of kernels, {t['wall_ms']:.1f} ms "
                   "wall (the recurrence is eager: launches grow with the "
                   "sequence)")
    opened = None

    # 5. Training on one rank: compressed, its raw e4m3 twin, baseline.
    tkw = dict(seq_len=seq_len, global_batch=global_batch, device=dev,
               transport="oneshot", seed=0)
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero()
    train_runs = {}
    with data_parallel(dev):
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            t0 = time.perf_counter()
            r = train(cfg, comm="qlc", steps=2, **tkw)
            train_runs["compressed"] = time.perf_counter() - t0
            hist = r["history"]
            if not all(h["ok"] for h in hist) or r["comm_fallbacks"]:
                raise AssertionError(f"ssm train: ok "
                                     f"{[h['ok'] for h in hist]}, fallbacks "
                                     f"{r['comm_fallbacks']}")
            losses = [h["loss"] for h in hist]
            step_ms = [h["dt"] * 1e3 for h in hist]
            reg, g = r["registry"], r["registry"]["grads"]
            flat = _flat_params(r["params"])
            gw, pw = (r["grads_wire_bytes_per_symbol"],
                      r["params_wire_bytes_per_symbol"])
            calib_ms = r["calibrate_s"] * 1e3
            del r
            twin = train(cfg, comm="qlc", steps=2, registry=reg,
                         wire_enabled=False, **tkw)
            require_equal("ssm: compressed vs raw e4m3 twin parameters "
                          "after 2 steps", [flat],
                          [_flat_params(twin["params"])])
            del twin
            base = train(cfg, comm="baseline", steps=2, **tkw)
            lb = [h["loss"] for h in base["history"]]
            base_ms = [h["dt"] * 1e3 for h in base["history"]]
            del base
        finally:
            torch.use_deterministic_algorithms(False)
    if not all(math.isfinite(v) for v in losses + lb):
        raise AssertionError(f"ssm train: losses {losses}, baseline {lb}")
    launches["train"] = read()
    peak = (torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda"
            else float("nan"))
    log("ssm", f"train: calibrate {calib_ms:.1f} ms (grads "
               f"{g.plan.expected_bits_per_symbol:.4f} expected bits/symbol,"
               f" {g.plan.capacity_words}-word slots); 2 compressed steps "
               f"{[round(t, 1) for t in step_ms]} ms, losses {losses}, all "
               f"ok, no fallback; wire {gw:.4f} B/symbol (grads), {pw:.4f} "
               f"(params); == raw e4m3 twin after 2 steps ({flat.numel()} "
               f"parameters bit-equal); baseline 2 steps "
               f"{[round(t, 1) for t in base_ms]} ms, losses {lb}; "
               f"launches {launches['train']}; peak device memory "
               f"{peak:.2f} GiB")
    del flat

    # 6. One mamba layer at jamba-1.5-large's widths.
    mcfg = mamba_cfg or dataclasses.replace(
        get_config("jamba-1.5-large-398b"), num_layers=1, attn_every=None,
        family="ssm", d_ff=0, moe=None, dtype="float32")
    di, dtr = ssm.mamba_dims(mcfg)
    gen = torch.Generator(device=dev).manual_seed(11)
    mp = ssm.init_mamba(gen, mcfg, torch.float32, dev)
    n_pre, n_dec = 16, 8
    x = torch.randn((1, n_pre + n_dec, mcfg.d_model), generator=gen,
                    device=dev)
    st0 = ssm.mamba_init_state(x, 1, mcfg)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_pre, st_pre = ssm.mamba_block(mp, x[:, :n_pre], mcfg, state=st0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs, stt = [], st_pre
        for t in range(n_pre, n_pre + n_dec):
            o, stt = ssm.mamba_block(mp, x[:, t:t + 1], mcfg, state=stt)
            outs.append(o)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out_all, st_all = ssm.mamba_block(mp, x, mcfg, state=st0)
    tol = dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(torch.cat(outs, 1), out_all[:, n_pre:], **tol)
    torch.testing.assert_close(out_pre, out_all[:, :n_pre], **tol)
    for f, a, b in zip(stt._fields, stt, st_all):
        torch.testing.assert_close(a, b, **tol, msg=f"mamba state {f}")
    reg = CodecRegistry()
    snap = list(ssm.state_snapshot(st_pre))
    zero()
    calibrate_kv_entries(reg, {"l0": snap}, mode="qlc", chunk_symbols=256)
    cache = PagedKVCache(KVCacheSpec(block_tokens=n_pre), mcfg, reg,
                         device=dev)
    blk = cache.encode_block_arrays("kv/layer0", "l0", snap, start=n_pre,
                                    tokens=n_pre)
    back = cache.decode_block_arrays(blk)
    if not all(_same_bytes(a, b) for a, b in zip(back, snap)):
        raise AssertionError("ssm: MambaState through K3 and K4 differs")
    launches["mamba"] = read()
    for kname in ("K3", "K4"):
        if launches["mamba"][kname] <= 0:
            raise AssertionError(f"{kname} was not launched on the mamba "
                                 "state's round trip")
    err = max(float((a - b).abs().max()) for a, b in
              [(torch.cat(outs, 1), out_all[:, n_pre:])]
              + list(zip(stt, st_all)))
    log("ssm", f"mamba at {mcfg.name}'s widths (d_model {mcfg.d_model}, "
               f"d_inner {di}, dt_rank {dtr}, N {mcfg.ssm_state_dim}, conv "
               f"{mcfg.conv_kernel}; f32): {n_pre}-token segment "
               f"{(t1 - t0) * 1e3:.2f} ms, then {n_dec} decode steps "
               f"{(t2 - t1) * 1e3 / n_dec:.2f} ms each; == one "
               f"{n_pre + n_dec}-token segment, outputs and state (max abs "
               f"diff {err:.3e}); its MambaState "
               f"{[list(a.shape) for a in snap]} through K3 and K4 bit for "
               f"bit: {blk.wire_bytes} B container for {blk.dense_bytes} B; "
               f"launches {launches['mamba']}")
    del mp, x, cache
    total = {k: sum(run[k] for run in launches.values()) for k in counters}
    for kname, c in total.items():
        if c <= 0:
            raise AssertionError(f"{kname} was not launched on the ssm path")
    log("ssm", "launches on the phase's paths (serve, train, mamba): "
               + ", ".join(f"{k} {v}" for k, v in total.items()))
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"launches": total, "launches_by_run": launches, "kv": kv,
            "fused": fused, "ms_per_token": stats, "pool": pool,
            "dedup_hits": hits, "profile": prof, "step_ms": step_ms,
            "base_ms": base_ms, "losses": losses, "base_losses": lb,
            "wire_bytes_per_symbol": wire_b / sym, "peak_gib": peak,
            "n_params": n_params, "run_s": run_s, "train_s": train_runs}


VARIANTS_ARCH = "musicgen-medium"
#: depth of the variants phase's serving and training cells
#: (musicgen-medium has 48; cut to make room for the dp_serve phase,
#: then to keep the script within 1,000 s on a slow host)
VARIANTS_TRAIN_LAYERS = 12


def _fairness_run(opened, cfg, prompts, dense, max_seq_len, batch,
                  new_tokens):
    """``Engine(fairness_cap=0.5)`` at ``batch`` with the prompts of the
    dense run, two thirds from tenant A then one third from tenant B:
    ``defer_fairness`` events, never more than ``ceil(batch / 2)``
    running slots of one tenant after any step, and every request's
    tokens equal to its tokens on the dense engine."""
    from repro_torch.serving import Engine, GenerationRequest
    eng = Engine(opened, cfg, max_seq_len=max_seq_len, max_batch=batch,
                 fairness_cap=0.5)
    n_a = -(-2 * len(prompts) // 3)
    tenant = ["A"] * n_a + ["B"] * (len(prompts) - n_a)
    hs = [eng.submit(GenerationRequest(prompt=p, max_new_tokens=new_tokens,
                                       tenant=t))
          for p, t in zip(prompts, tenant)]
    cap, most = -(-batch // 2), {"A": 0, "B": 0}
    t0 = time.perf_counter()
    while eng.step():
        for t in most:
            most[t] = max(most[t], sum(
                1 for h, ht in zip(hs, tenant)
                if ht == t and eng.poll(h).state == "running"))
    run_s = time.perf_counter() - t0
    deferred = sum(1 for _, e, _ in eng.events if e == "defer_fairness")
    if not deferred or max(most.values()) > cap:
        raise AssertionError(f"variants: fairness cap {cap}: "
                             f"{deferred} deferrals, most running {most}")
    for i, h in enumerate(hs):
        st = eng.poll(h)
        if st.state != "finished" or not np.array_equal(st.tokens,
                                                        dense[i]):
            raise AssertionError(f"variants: request {i} under the fairness "
                                 "cap differs from the dense engine's")
    return {"deferrals": deferred, "most_running": most, "cap": cap,
            "tenants": {"A": n_a, "B": len(prompts) - n_a}, "run_s": run_s}


def _block_check(what, cfg, block, dev, n_pre, n_dec, seed):
    """One block at ``cfg``'s widths (f32): ``block(x, positions,
    cache)`` over ``n_pre + n_dec`` positions through the training path
    (no cache), then ``n_pre`` tokens written into an empty KV cache at
    once and ``n_dec`` single decode steps; both equal to the training
    path's outputs at those positions within rtol 1e-4 / atol 1e-5.
    Returns the decode outputs, the max abs diff and the timings."""
    from repro_torch.models import attention as attn
    n = n_pre + n_dec
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((1, n, cfg.d_model), generator=gen, device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None]
    tol = dict(rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full, _ = block(x, pos, None)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache = attn.KVCache.init(1, n, cfg.num_kv_heads,
                                  cfg.resolved_head_dim, torch.float32, dev)
        out_pre, cache = block(x[:, :n_pre], pos[:, :n_pre], cache)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        outs = [out_pre]
        for t in range(n_pre, n):
            o, cache = block(x[:, t:t + 1], pos[:, t:t + 1], cache)
            outs.append(o)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    got = torch.cat(outs, 1)
    torch.testing.assert_close(got, full, **tol,
                               msg=lambda m: f"{what}: {m}")
    if int(cache.length[0]) != n:
        raise AssertionError(f"{what}: cache length {cache.length}")
    return got, float((got - full).abs().max()), {
        "train_ms": (t1 - t0) * 1e3, "write_ms": (t2 - t1) * 1e3,
        "decode_ms_per_step": (t3 - t2) * 1e3 / n_dec}


def phase_variants(qf, qc, h6, ops, ref, serve_mod, flush, dev="cuda",
                   cfg=None, batch=4, requests=6, prompt_len=16,
                   new_tokens=16, kv_block=16, seq_len=512, global_batch=4,
                   train_cfg=None, nemo_cfg=None, nemo_tokens=(16, 8),
                   mix_cfg=None, mix_tokens=(4096, 1024)):
    """The block variants on the card. musicgen-medium (gelu FFN without
    ``w_gate``; all 48 layers at full width, f32 parameters, bf16
    compute, random weights from a seed) served through
    ``launch.serve.serve``: the weight wire (K1's histogram, K1, K2) and
    a dense run; ``--kv-cache qlc`` sync (K3, K4) and async (K3, K5),
    codecs calibrated through K6, every request's tokens equal to the
    dense run's; ``Engine(fairness_cap=0.5)`` over the same requests from
    two tenants (``_fairness_run``). K1/K2 at the stacked ``w_in`` leaf
    and K3-K6 on its KV planes against their plain versions; one decode
    step's and one training forward and backward's launches, kernel and
    wall time. ``train(comm="qlc")`` on one NCCL rank at ``global_batch x
    seq_len`` (``seq_len - 64`` tokens a row, as the launcher gives): 2
    compressed steps, 2 of the raw e4m3 twin (bit-equal), 2 baseline.
    One nemotron-4-340b block (squared ReLU, 96 / 8 heads x 192, d_ff
    73728, f32) and one mixtral-8x22b attention block (window 4096, f32)
    through ``_block_check``; mixtral's decode with the window off must
    differ past the window. K1-K6 counted from zero around the serve and
    train runs, each non-zero."""
    import dataclasses
    from repro_torch.roofline.trace import launch_profile
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import data_parallel
    from repro_torch.launch.train import train
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer
    cfg = cfg or dataclasses.replace(get_config(VARIANTS_ARCH),
                                     num_layers=VARIANTS_TRAIN_LAYERS)
    log("variants", f"{cfg.name}: {cfg.num_layers} layers, d_model "
                    f"{cfg.d_model}, {cfg.num_heads} heads x "
                    f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff} "
                    f"{cfg.activation}, vocab {cfg.vocab_size}, params "
                    f"{cfg.param_dtype}, compute {cfg.dtype}; {requests} "
                    f"requests at batch {batch}, prompt {prompt_len}, "
                    f"{new_tokens} new tokens")
    if dev == "cuda":
        held = torch.cuda.memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log("variants", f"gc.collect() freed "
                        f"{held - torch.cuda.memory_allocated()} B; "
                        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                        "held by earlier phases at the start")
    counters = {"K1": qf.fused_encode, "K2": qf.fused_decode,
                "K3": qc.encode, "K4": qc.decode, "K5": qc.prefetch_decode,
                "K6": h6.histogram256}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    kw = dict(batch=batch, requests=requests, prompt_len=prompt_len,
              new_tokens=new_tokens, device=dev, seed=0)

    # 1. The wire and the dense run.
    zero()
    t0 = time.perf_counter()
    res = serve_mod.serve(cfg, wire="qlc", **kw)
    run_s = {"dense": time.perf_counter() - t0}
    wc, wired, opened = res["wire_codec"], res["wired"], res["params"]
    if "w_gate" in opened["groups"]["l0"]["ffn"]:
        raise AssertionError("variants: a gelu FFN holds a w_gate")
    outs = res["outs"]
    if not all(o.state == "finished" and len(o.tokens) == new_tokens
               for o in outs):
        raise AssertionError([(o.request_id, o.state) for o in outs])
    dense = [o.tokens for o in outs]
    prompts = res["prompts"]
    n_params = sum(t.numel() for t in _leaves(opened))
    wire_b = sym = 0
    for key, lm in wc.meta.items():
        node = _node(wired, key)
        wire_b += nbytes(node["words"], node["scales"])
        sym += lm.n_symbols * node["words"].shape[0]
    st = res["stats"]
    stats = {"dense": {"prefill": st["ms_per_token_prefill"],
                       "decode": st["ms_per_token_decode"]}}
    log("variants", f"{n_params} parameters; calibrate "
                    f"{res['calibrate_s'] * 1e3:.1f} ms, compress "
                    f"{res['compress_s'] * 1e3:.1f} ms, open "
                    f"{res['open_s'] * 1e3:.1f} ms; {len(wc.meta)} "
                    f"compressed leaves ({sorted(wc.meta)}), {sym} symbols, "
                    f"wire {wire_b} B = {wire_b / sym:.4f} B/symbol (words "
                    f"+ bf16 scales); dense run "
                    f"{st['ms_per_token_prefill']:.3f} ms/token prefill, "
                    f"{st['ms_per_token_decode']:.3f} ms/token decode "
                    f"({run_s['dense']:.1f} s with the wire)")
    res = None

    # 2. The paged cache, sync then async, every request == dense.
    pool = {}
    for paging in ("sync", "async"):
        t0 = time.perf_counter()
        r = serve_mod.serve(cfg, params=opened, kv_cache="qlc",
                            kv_block=kv_block, kv_paging=paging, **kw)
        run_s[paging] = time.perf_counter() - t0
        got = [o.tokens for o in r["outs"]]
        if len(got) != len(dense) or not all(
                np.array_equal(a, b) for a, b in zip(got, dense)):
            raise AssertionError(f"variants: the {paging} paged run's "
                                 "tokens differ from the dense run's")
        st = r["stats"]
        stats[paging] = {"prefill": st["ms_per_token_prefill"],
                         "decode": st["ms_per_token_decode"]}
        ps = st["pool"]
        pool[paging] = ps["peak_referenced_bytes"] / \
            st["peak_dense_logical_bytes"]
        line = (f"--kv-cache qlc --kv-block {kv_block} --kv-paging {paging}:"
                f" every request's tokens == the dense run's; "
                f"{st['ms_per_token_prefill']:.3f} ms/token prefill, "
                f"{st['ms_per_token_decode']:.3f} decode; "
                f"{ps['unique_blocks']} blocks, pooled/dense KV bytes "
                f"{pool[paging]:.4f}; {run_s[paging]:.1f} s with the "
                "serve's own dense check")
        if paging == "async":
            pf = st["prefetch"]
            line += (f"; {st['async']['windows']} windows, prefetch "
                     f"{pf['hits']}/{pf['scheduled']} hits, "
                     f"{pf['stalled']} stalled, {pf['misses']} misses")
        log("variants", line)
        del r

    # 3. The fairness cap over the same requests.
    fair = _fairness_run(opened, cfg, prompts, dense,
                         prompt_len + new_tokens + 8, batch, new_tokens)
    log("variants", f"Engine(fairness_cap=0.5) at batch {batch}, requests "
                    f"per tenant {fair['tenants']}: "
                    f"{fair['deferrals']} defer_fairness events, most "
                    f"running per tenant {fair['most_running']} (cap "
                    f"{fair['cap']}); every request's tokens == the dense "
                    f"engine's ({fair['run_s']:.1f} s)")
    launches = {"serve": read()}
    path_peak = (torch.cuda.max_memory_allocated() / 2**30
                 if dev == "cuda" else float("nan"))

    # 4. K3-K6 on musicgen's KV planes, K1/K2 at the stacked w_in leaf;
    # one decode step's and one training step's launches.
    kv = check_kv_path(ops, ref, cfg, opened, prompts[0], flush, dev=dev,
                       phase="variants")
    fused = wire_leaf_fused(ops, ref, wc, wired, "groups/l0/ffn/w_in", flush,
                            phase="variants")
    del wired, wc
    prof = launch_profile(cfg, opened, dev) if dev == "cuda" else None
    if prof is not None:
        d, t = prof["decode"], prof["train"]
        idle = (None if d["busy_ms"] is None
                else max(0.0, 1 - d["busy_ms"] / d["wall_ms"]))
        prof["decode"]["idle_share"] = idle
        log("variants", f"one decode step (batch {batch}): {d['launches']} "
                        f"kernel launches, {d['busy_ms']} ms of kernels, "
                        f"{d['wall_ms']:.3f} ms wall, device idle share "
                        f"{idle}; one training forward + backward at "
                        f"{prof['train_shape']}: {t['launches']} launches, "
                        f"{t['busy_ms']} ms of kernels, {t['wall_ms']:.1f} "
                        "ms wall")
    opened = None
    log("variants", f"peak device memory over the serve runs "
                    f"{path_peak:.2f} GiB")

    # 5. Training on one rank: compressed, its raw e4m3 twin, baseline.
    tcfg = train_cfg or dataclasses.replace(
        cfg, num_layers=VARIANTS_TRAIN_LAYERS)
    tkw = dict(seq_len=seq_len, global_batch=global_batch, device=dev,
               transport="oneshot", seed=0)
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero()
    t_train = time.perf_counter()
    with data_parallel(dev):
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            r = train(tcfg, comm="qlc", steps=2, **tkw)
            hist = r["history"]
            if not all(h["ok"] for h in hist) or r["comm_fallbacks"]:
                raise AssertionError(f"variants train: ok "
                                     f"{[h['ok'] for h in hist]}, fallbacks "
                                     f"{r['comm_fallbacks']}")
            losses = [h["loss"] for h in hist]
            step_ms = [h["dt"] * 1e3 for h in hist]
            reg, g = r["registry"], r["registry"]["grads"]
            # held on the host while the twin runs: 5.5 GB of the card
            flat = _flat_params(r["params"]).cpu()
            gw, pw = (r["grads_wire_bytes_per_symbol"],
                      r["params_wire_bytes_per_symbol"])
            calib_ms = r["calibrate_s"] * 1e3
            del r
            twin = train(tcfg, comm="qlc", steps=2, registry=reg,
                         wire_enabled=False, **tkw)
            require_equal("variants: compressed vs raw e4m3 twin "
                          "parameters after 2 steps", [flat],
                          [_flat_params(twin["params"]).cpu()])
            del twin
            base = train(tcfg, comm="baseline", steps=2, **tkw)
            lb = [h["loss"] for h in base["history"]]
            base_ms = [h["dt"] * 1e3 for h in base["history"]]
            del base
        finally:
            torch.use_deterministic_algorithms(False)
    train_s = time.perf_counter() - t_train
    if not all(math.isfinite(v) for v in losses + lb):
        raise AssertionError(f"variants train: losses {losses}, baseline "
                             f"{lb}")
    launches["train"] = read()
    peak = (torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda"
            else float("nan"))
    log("variants", f"train {tcfg.num_layers} layers at {global_batch} x "
                    f"{seq_len} ({seq_len - tcfg.frontend_prefix_len} tokens "
                    f"a row, no prefix): calibrate {calib_ms:.1f} ms (grads "
                    f"{g.plan.expected_bits_per_symbol:.4f} expected "
                    f"bits/symbol, {g.plan.capacity_words}-word slots); 2 "
                    f"compressed steps {[round(t, 1) for t in step_ms]} ms, "
                    f"losses {losses}, all ok, no fallback; wire {gw:.4f} "
                    f"B/symbol (grads), {pw:.4f} (params); == raw e4m3 twin "
                    f"after 2 steps ({flat.numel()} parameters bit-equal); "
                    f"baseline 2 steps {[round(t, 1) for t in base_ms]} ms, "
                    f"losses {lb}; launches {launches['train']}; peak "
                    f"device memory {peak:.2f} GiB; {train_s:.1f} s")
    del flat
    if dev == "cuda":
        torch.cuda.empty_cache()

    # 6. One nemotron-4-340b block at its widths.
    ncfg = nemo_cfg or dataclasses.replace(
        get_config("nemotron-4-340b"), num_layers=1, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(12)
    nb = transformer.tree_map(lambda a: a[0], transformer._init_block(
        gen, "attention", ncfg, 0, 1, torch.float32, dev))
    n_nb = sum(t.numel() for t in _leaves(nb))

    def nemo_block(x, pos, cache):
        return transformer._apply_block(nb, "attention", x, pos, ncfg, cache)

    _, nerr, nt = _block_check("nemotron block", ncfg, nemo_block, dev,
                               *nemo_tokens, seed=13)
    log("variants", f"{ncfg.name} block at its widths (d_model "
                    f"{ncfg.d_model}, {ncfg.num_heads} / {ncfg.num_kv_heads} "
                    f"heads x {ncfg.resolved_head_dim}, d_ff {ncfg.d_ff} "
                    f"{ncfg.activation}, {n_nb} parameters, f32): "
                    f"{sum(nemo_tokens)} positions through the training path "
                    f"{nt['train_ms']:.2f} ms; {nemo_tokens[0]} tokens "
                    f"written into the cache at once {nt['write_ms']:.2f} "
                    f"ms, then {nemo_tokens[1]} decode steps "
                    f"{nt['decode_ms_per_step']:.2f} ms each; == the "
                    f"training path (max abs diff {nerr:.3e})")
    del nb
    if dev == "cuda":
        torch.cuda.empty_cache()

    # 7. One mixtral-8x22b attention block with its window, past it.
    mcfg = mix_cfg or dataclasses.replace(
        get_config("mixtral-8x22b"), num_layers=1, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(14)
    mb = transformer.tree_map(lambda a: a[0], transformer._init_mixer(
        gen, "attention", mcfg, 1, torch.float32, dev))
    mix = {}
    for w in (mcfg.sliding_window, None):
        c = dataclasses.replace(mcfg, sliding_window=w)

        def mix_block(x, pos, cache, c=c):
            return attn.attention_block(mb, x, c, pos, cache=cache)

        got, err, tm = _block_check(f"mixtral block, window {w}", c,
                                    mix_block, dev, *mix_tokens, seed=15)
        mix[w] = (got[:, mix_tokens[0]:], err, tm)
        del got
    past = float((mix[mcfg.sliding_window][0] - mix[None][0]).abs().max())
    if not past > 1e-3:
        raise AssertionError(f"mixtral: decode past the window equals the "
                             f"unwindowed decode (max diff {past})")
    mt = mix[mcfg.sliding_window][2]
    log("variants", f"{mcfg.name} attention block (d_model {mcfg.d_model}, "
                    f"{mcfg.num_heads} / {mcfg.num_kv_heads} heads x "
                    f"{mcfg.resolved_head_dim}, rope theta "
                    f"{mcfg.rope_theta:g}, window {mcfg.sliding_window}, "
                    f"f32): {sum(mix_tokens)} positions through the blocked "
                    f"training path {mt['train_ms']:.1f} ms; "
                    f"{mix_tokens[0]} tokens written into the cache at once "
                    f"{mt['write_ms']:.1f} ms, then {mix_tokens[1]} decode "
                    f"steps past the window {mt['decode_ms_per_step']:.3f} "
                    f"ms each; == the training path (max abs diff "
                    f"{mix[mcfg.sliding_window][1]:.3e}); window off: == "
                    f"its own training path ({mix[None][1]:.3e}) and "
                    f"differs past the window by up to {past:.3e}")
    del mb, mix
    total = {k: sum(run[k] for run in launches.values()) for k in counters}
    for kname, c in total.items():
        if c <= 0:
            raise AssertionError(f"{kname} was not launched on the variants "
                                 "path")
    log("variants", "launches on the phase's paths (serve, train): "
                    + ", ".join(f"{k} {v}" for k, v in total.items()))
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"launches": total, "launches_by_run": launches, "kv": kv,
            "fused": fused, "ms_per_token": stats, "pool": pool,
            "fairness": fair, "profile": prof, "step_ms": step_ms,
            "base_ms": base_ms, "calibrate_ms": calib_ms, "losses": losses,
            "base_losses": lb, "grads_wire": gw, "params_wire": pw,
            "wire_bytes_per_symbol": wire_b / sym, "peak_gib": peak,
            "path_peak_gib": path_peak, "n_params": n_params,
            "run_s": run_s, "train_s": train_s, "nemotron": nt,
            "mixtral": mt}


TP_LAYOUTS = ((2, 2), (1, 4), (16, 16))


def tp_layout_table():
    """Per config, at each of ``TP_LAYOUTS``: the leaves its resolved
    specs split over the model axis (every block kind's), the leaves they
    keep whole, and the parameter bytes one rank holds. Pure arithmetic
    on the shapes."""
    from repro_torch.configs import REGISTRY
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import pytree_leaves
    from repro_torch.parallel import sharding
    table = {}
    for name, cfg in REGISTRY.items():
        shapes = sharding.param_shapes(cfg)
        leaf_shapes = pytree_leaves(shapes)
        item = torch.empty((), dtype=getattr(torch, cfg.param_dtype)
                           ).element_size()
        row = {}
        for data, model in TP_LAYOUTS:
            mesh = Mesh(data=data, model=model, rank=0, world_group=None,
                        data_group=None, model_group=None)
            specs = pytree_leaves(sharding.param_pspecs(cfg, mesh, shapes))
            split = sum(sharding.model_dim(sp) is not None for sp in specs)
            local = sum(sharding.local_numel(sh, sp, mesh)
                        for sh, sp in zip(leaf_shapes, specs))
            row[f"{data}x{model}"] = {"split": split,
                                      "whole": len(specs) - split,
                                      "bytes": local * item}
        table[name] = row
        log("tp", f"{name}: " + "; ".join(
            f"{k} {v['split']} split / {v['whole']} whole leaves, "
            f"{v['bytes'] / 2**30:.3f} GiB a rank" for k, v in row.items()))
    return table


#: the MoE and recurrent configs whose whole trees the tp phase cuts and
#: gathers back: xlstm-125m whole, deepseek-moe-16b at 8 of 28 layers
#: (~20 GB of f32 parameters; its cut and the tree gathered back take as
#: much again each), and jamba-1.5-large's mamba layer with its dense
#: FFN at its widths
TP_BLOCK_LAYERS = {"xlstm-125m": None, "deepseek-moe-16b": 8,
                   "jamba-1.5-large-398b": 1}


def _tp_block_cfgs():
    import dataclasses
    from repro_torch.configs import get_config
    out = []
    for arch, layers in TP_BLOCK_LAYERS.items():
        cfg = get_config(arch)
        if arch.startswith("jamba"):
            cfg = dataclasses.replace(cfg, attn_every=None)
        out.append(dataclasses.replace(cfg, num_layers=layers)
                   if layers else cfg)
    return out


def tp_cut_and_gather(cfg, dev):
    """The whole tree of ``cfg`` on ``dev`` cut for a model axis of 2 and
    of 4 (``convert.shard_params``), every local leaf of its resolved
    shape, and gathered back (``convert.gather_params``) bit-equal.
    Returns {model: (cut ms, gather ms)}."""
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_params
    from repro_torch.models.transformer import pytree_leaves
    from repro_torch.parallel import sharding
    whole = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    out = {}
    for model in (2, 4):
        layout = Mesh(data=1, model=model, rank=0, world_group=None,
                      data_group=None, model_group=None)
        specs = pytree_leaves(sharding.param_pspecs(cfg, layout))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts = [shard_params(whole, cfg, m, model) for m in range(model)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = gather_params(parts, cfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for part in parts:
            for leaf, sp, full in zip(pytree_leaves(part), specs,
                                      pytree_leaves(whole)):
                want = sharding.local_shape(tuple(full.shape), sp, layout)
                if tuple(leaf.shape) != want:
                    raise AssertionError(f"tp: a {model}-way cut leaf is "
                                         f"{tuple(leaf.shape)}, not {want}")
        for a, b in zip(pytree_leaves(back), pytree_leaves(whole)):
            if not torch.equal(a, b):
                raise AssertionError(f"tp: the {model}-way cut gathered "
                                     "back differs from the whole tree")
        out[model] = ((t1 - t0) * 1e3, (t2 - t1) * 1e3)
        n = sum(t.numel() for t in pytree_leaves(parts[0]))
        log("tp", f"{cfg.name} ({sum(t.numel() for t in pytree_leaves(whole))}"
                  f" parameters) cut for a model axis of {model} on the "
                  f"card: {n} a rank, every leaf of its spec's shape, "
                  f"gathered back bit-equal; cut {out[model][0]:.1f} ms, "
                  f"gather {out[model][1]:.1f} ms")
        del parts, back
    del whole
    return out


def _tp_one_by_one(qf, h6, cell, kw, what):
    """``cell`` trained 2 compressed steps through ``train()`` with no
    mesh and with a 1 x 1 mesh in scope, bit-equal, K6/K1/K2 counted
    from zero around the second. Returns (launches, the registry)."""
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.launch.train import train
    import hashlib
    plain = train(cell, **kw)
    reg = plain["registry"]
    flat_plain = _flat_params(plain["params"]).cpu()
    del plain
    torch.cuda.empty_cache()
    counters = {"K6": h6.histogram256, "K1": qf.fused_encode,
                "K2": qf.fused_decode}
    for fn in counters.values():
        fn.launches = 0
    with use_mesh(make_test_mesh(model=1)):
        meshed = train(cell, **kw)
    launches = {k: fn.launches for k, fn in counters.items()}
    for kname, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{kname} was not launched on the tp path "
                                 f"({what})")
    if meshed["registry"].to_json() != reg.to_json():
        raise AssertionError(f"tp: the 1 x 1 run of the {what} calibrated "
                             "another registry")
    if not all(h["ok"] for h in meshed["history"]):
        raise AssertionError(f"tp: a 1 x 1 step's ok is False ({what})")
    flat_meshed = _flat_params(meshed["params"]).cpu()
    require_equal(f"tp: {what} at 1 x 1 vs no mesh, parameters after 2 "
                  "steps", [flat_meshed], [flat_plain])
    digest = hashlib.sha256(flat_meshed.numpy().tobytes()).hexdigest()[:16]
    losses = [h["loss"] for h in meshed["history"]]
    log("tp", f"{what} ({cell.name}, {cell.num_layers} layers) at 1 x 1 "
              f"through the 2-D step: 2 compressed steps bit-equal to the "
              f"run with no mesh ({flat_meshed.numel()} parameters, sha256 "
              f"{digest}), losses {losses}; launches {launches}")
    del meshed, flat_meshed, flat_plain
    torch.cuda.empty_cache()
    return launches, reg


def phase_tp(qf, h6, ops, ref, flush, dev="cuda", cfg=None, train_cfg=None,
             seq_len=512, global_batch=4, block_cfgs=None, moe_cfg=None):
    """The tensor-parallel slice on one card: the layout table; the whole
    of ``cfg`` (phi3-mini-3.8b, all 32 layers) cut for model axes of 2
    and 4 and gathered back, and the MoE and recurrent configs of
    ``block_cfgs`` likewise (default: :data:`TP_BLOCK_LAYERS`); the
    train cell (``train_cfg``: 8 layers) and the moe cell (``moe_cfg``:
    deepseek-moe-16b, 1 layer) each trained 2 compressed steps through
    ``train()`` with no mesh and with a 1 x 1 mesh in scope, bit-equal,
    K6/K1/K2 counted from zero around the second; K1 and K2 at 2 x 2's
    per-rank flat-gradient shape (model rank 0's blocks of the whole
    model's gradient on data rank 0's 2 rows) bit-equal to plain and
    timed; with two or more cards the layouts they allow through
    ``tools/tp_cards.py``."""
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_params
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_params
    from repro_torch.training.train_step import (_flatten_local,
                                                 _value_and_grad,
                                                 flat_geometry)
    cfg = cfg or get_config("phi3-mini-3.8b")
    table = tp_layout_table()
    cut = tp_cut_and_gather(cfg, dev)
    torch.cuda.empty_cache()
    for bcfg in (block_cfgs or _tp_block_cfgs()):
        cut[bcfg.name] = tp_cut_and_gather(bcfg, dev)
        torch.cuda.empty_cache()

    kw = dict(comm="qlc", steps=2, seq_len=seq_len,
              global_batch=global_batch, device=dev, transport="oneshot",
              seed=0)
    launches, reg = _tp_one_by_one(qf, h6, _train_cell(train_cfg), kw,
                                   "train cell")
    moe_launches, _ = _tp_one_by_one(qf, h6, _moe_cell(moe_cfg), kw,
                                     "moe cell")

    # K1 / K2 at 2 x 2's per-rank flat-gradient shape
    layout = Mesh(data=2, model=2, rank=0, world_group=None, data_group=None,
                  model_group=None)
    whole = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = SyntheticDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch)).batch_at(0)
    rows = {k: torch.as_tensor(v)[:global_batch // 2].to(dev)
            for k, v in batch.items()}
    _, grads = _value_and_grad(whole, cfg, rows)
    del whole
    local = shard_params(grads, cfg, 0, 2)
    del grads
    geom = flat_geometry(local, 2, reg["grads"].config(), cfg, layout)
    grad = _flatten_local(local, geom.n_padded)
    del local
    torch.cuda.empty_cache()
    log("tp", f"2 x 2 on {cfg.name}, all {cfg.num_layers} layers: a model "
              f"rank's flat vector {geom.n_local} of {geom.n_padded} "
              f"(segment {geom.seg}); K1 / K2 at its shape on model rank "
              "0's blocks of the gradient of data rank 0's rows")
    fused = train_path_fused(ops, ref, reg["grads"], grad, flush, phase="tp")
    del grad
    torch.cuda.empty_cache()

    n_cards = torch.cuda.device_count() if dev == "cuda" else 1
    ran = ["1 x 1"]
    if n_cards >= 2:
        models = [m for m in (2, 4) if m <= n_cards and n_cards % m == 0]
        cmd = [sys.executable, os.path.join(ROOT, "tools", "tp_cards.py"),
               "--cards", str(n_cards), "--layers", "8", "--steps", "2",
               "--model"] + [str(m) for m in models]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        for line in r.stdout.splitlines():
            log("tp", f"cards: {line}")
        if r.returncode:
            raise AssertionError(f"tp: tools/tp_cards.py exited "
                                 f"{r.returncode}:\n{r.stderr[-4000:]}")
        ran += [f"{n_cards // m} x {m}" for m in models]
    log("tp", f"layouts run: {', '.join(ran)} ({n_cards} card"
              f"{'s' if n_cards > 1 else ''}; the 2-D layouts run on gloo "
              "CPU ranks in tests/test_torch_tp.py and on 4 cards in "
              "tools/tp_cards.py)")
    return {"launches": launches, "moe_launches": moe_launches,
            "fused": fused, "table": table, "cut_ms": cut, "layouts": ran,
            "n_padded": geom.n_padded}


#: the tp_serve cell: phi3-mini-3.8b at this many of its 32 layers
TP_SERVE_LAYERS = 8
#: phi3-mini-3.8b layers the kv phase pages (of the slice's 32; cut to
#: make room for the dp_serve phase, then to keep the script within
#: 1,000 s on a slow host)
KV_LAYERS = 8


def depth_cut(cfg, params, layers: int):
    """The first ``layers`` layer groups of ``params`` (views) and the
    config of that depth."""
    import dataclasses
    from repro_torch.models.transformer import tree_map
    return (dataclasses.replace(cfg, num_layers=layers),
            dict(params, groups=tree_map(lambda a: a[:layers],
                                         params["groups"])))
#: deepseek-coder-33b (arXiv:2401.14196) over a model row of 4: a rank's
#: largest leaf (the stacked ``w_in``, its ``mlp`` block) and its KV heads
CODER_ROW = 4


def _digest(text: str) -> str:
    import hashlib
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def tp_serve_engines(qc, h6, cfg, opened, prompts, mesh, dev, new_tokens,
                     kv_block=16):
    """``Engine(mesh=mesh)`` (None: no mesh) on the opened tree, paged
    sync then async with ``KVCacheSpec(axis="model",
    exact_capacity=False)``, each run's K3-K6 launches counted from zero.
    Returns {paging: (tokens, pool stats, KV registry digest, launches,
    stats, the engine)}."""
    from repro_torch.serving import (BlockPool, Engine, GenerationRequest,
                                     KVCacheSpec)
    counters = {"K3": qc.encode, "K4": qc.decode, "K5": qc.prefetch_decode,
                "K6": h6.histogram256}
    out = {}
    for paging in ("sync", "async"):
        eng = Engine(opened, cfg, max_seq_len=prompts.shape[1] + new_tokens
                     + 8, max_batch=4, kv_spec=KVCacheSpec(
                         block_tokens=kv_block, exact_capacity=False,
                         axis="model" if mesh is not None else None),
                     pool=BlockPool(1 << 30), kv_paging=paging, mesh=mesh)
        for fn in counters.values():
            fn.launches = 0
        hs = [eng.submit(GenerationRequest(prompt=p,
                                           max_new_tokens=new_tokens))
              for p in prompts]
        eng.run()
        launches = {k: fn.launches for k, fn in counters.items()}
        st = eng.stats()
        out[paging] = ([eng.poll(h).tokens.tolist() for h in hs],
                       {k: st["pool"][k] for k in (
                           "unique_blocks", "peak_referenced_bytes",
                           "resident_bytes", "dedup_hits")},
                       _digest(eng.registry.to_json()), launches, st, eng)
    return out


def tp_serve_migration(eng, cfg, opened, prompt, dev):
    """``all_gather_block_wire`` over the mesh-bound cache of ``eng``'s
    world of one: request 0's first 16-token block of layer slot 0,
    prefilled on the opened tree; the gathered words == the block's
    container, decoded through K4 bit-equal to the block's K/V."""
    import dataclasses
    from repro_torch.models import attention as attn
    from repro_torch.models import init_decode_states
    from repro_torch.serving import all_gather_block_wire, prefill
    codec = eng._codec
    p = torch.from_numpy(np.asarray(prompt)[None, :]).to(dev)
    _, st = prefill(opened, cfg, p, init_decode_states(cfg, 1, 72, dev))
    kv = attn.kv_block_slice(st["l0"], 0, 16)
    block = codec.encode_block_arrays("kv/layer0", "l0", kv, start=0,
                                      tokens=16)
    ch = codec.channels[sorted(codec.channels)[0]]
    got = all_gather_block_wire(codec.block_wire(block), ch)
    rows = got.cpu().numpy().view(np.uint32)
    if rows.shape != (1, block.container.size) or not np.array_equal(
            rows[0], block.container):
        raise AssertionError("tp_serve: gathered block words != container")
    dec = codec.decode_block_arrays(dataclasses.replace(block,
                                                        container=rows[0]))
    if not all(torch.equal(a, b) for a, b in zip(dec, kv)):
        raise AssertionError("tp_serve: the migrated block decodes to "
                             "other K/V")
    log("tp_serve", f"all_gather_block_wire over the world of one: "
                    f"{rows.shape[1]} words ({block.wire_bytes} B for "
                    f"{block.dense_bytes} B of K/V) == the container, "
                    "decoded through K4 bit-equal")


def tp_serve_kernels(qf, ops, ref, flush, dev, coder=None):
    """K2 (and K1) at a 1 x 4 rank's largest deepseek-coder-33b leaf,
    the stacked ``w_in`` block [62, 7168, 19200 / 4] (normal values at
    the init's scale), and K3-K6 at a 1 x 4 rank's KV block planes: rank
    0's 2 of 8 KV heads of 16 tokens in each of 62 layers, from a prefill
    of deepseek-coder-33b at full width, 4 layers, repeated over the
    depth. Each bit-equal to its plain version, timed alone, beside its
    HBM bound. ``coder``: another config in deepseek-coder's place."""
    import dataclasses
    from repro_torch.comm.calibrate import (byte_planes,
                                            calibrate_kv_entries,
                                            histogram_of_tree)
    from repro_torch.comm.compressed import pad_to_multiple
    from repro_torch.configs import get_config
    from repro_torch.core import CodecRegistry
    from repro_torch.models import attention as attn
    from repro_torch.models import init_decode_states, init_params
    from repro_torch.serving import compress_params_for_serving, prefill
    coder = coder or get_config("deepseek-coder-33b")
    g, d, ff = coder.num_layers, coder.d_model, coder.d_ff // CODER_ROW
    gen = torch.Generator(device=dev).manual_seed(0)
    leaf = torch.randn((g, d, ff), generator=gen, device=dev).mul_(d ** -0.5)
    tree = {"groups": {"l0": {"ffn": {"w_in": leaf}}}}
    reg = CodecRegistry()
    reg.register("default", histogram_of_tree(tree))
    wired, wc = compress_params_for_serving(tree, reg)
    del tree, leaf
    torch.cuda.empty_cache()
    fused = wire_leaf_fused(ops, ref, wc, wired, "groups/l0/ffn/w_in",
                            flush, phase="tp_serve")
    del wired
    torch.cuda.empty_cache()

    small = dataclasses.replace(coder, num_layers=min(4, coder.num_layers))
    params = init_params(small, torch.Generator(device=dev).manual_seed(0),
                         dev)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, small.vocab_size, (1, 32))).to(dev)
    _, st = prefill(params, small, prompt,
                    init_decode_states(small, 1, 40, dev))
    del params
    torch.cuda.empty_cache()
    heads = attn.decode_kv_heads(coder, 0, CODER_ROW)
    reps = -(-g // small.num_layers)

    def rank_kv(t0, t1):
        return [a.narrow(3, heads[0], len(heads)).narrow(2, t0, t1 - t0)
                .repeat(reps, 1, 1, 1, 1)[:g].contiguous()
                for a in (st["l0"].k, st["l0"].v)]
    creg = CodecRegistry()
    calibrate_kv_entries(creg, {"l0": rank_kv(0, 32)}, chunk_symbols=256)
    kv = rank_kv(0, 16)
    err = {"K3": 0.0, "K4": 0.0, "K5": 0.0, "K6": 0.0}
    coded = None
    for (isz, j), plane in byte_planes(kv).items():
        entry = creg[f"kv/layer0/w{isz}b{j}"]
        sym = pad_to_multiple(plane, 256)[0].reshape(-1, 256)
        e, (w, s) = codes_checks(ops, ref, sym, entry.tables,
                                 (entry.plan.capacity_words,))
        for name in e:
            err[name] = max(err[name], e[name])
        err["K6"] = max(err["K6"], require_equal(
            f"K6 plane w{isz}b{j}", [ops.histogram(plane)],
            [ref.histogram256_ref(plane)]))
        if coded is None or entry.plan.capacity_words < coded[3]:
            coded = (sym, entry.tables, (w, s), entry.plan.capacity_words,
                     plane)
    sym, tables, (w, s), cap, plane = coded
    times = time_codes(ops, ref, sym, tables, cap, w, s, flush, reps=10)
    times["K6"] = {"shape": [plane.numel()],
                   "ms": time_ms(lambda: ops.histogram(plane), 10, flush),
                   "kernel_ms": time_ms(bare_k6(plane), 10, flush,
                                        alone=True),
                   "plain_ms": time_ms(lambda: ref.histogram256_ref(plane),
                                       3, flush),
                   "library_ms": time_ms(lambda: torch.bincount(
                       plane, minlength=256), 10, flush),
                   "bound_ms": bound_ms("histogram", plane)}
    for name, r in times.items():
        r["err"] = err[name]
        log("tp_serve", f"{name} at a 1 x {CODER_ROW} rank's deepseek-coder "
                        f"KV block plane {r['shape']}"
                        + (f" cap {r['cap']}" if "cap" in r else "")
                        + f" ({len(heads)} of {coder.num_kv_heads} KV heads, "
                        f"{g} layers, 16 tokens): bit-equal to plain; "
                        f"{r['ms']:.4f} ms (kernel alone "
                        f"{r['kernel_ms']:.4f}), plain {r['plain_ms']:.2f} "
                        f"ms, HBM bound {r['bound_ms']:.4f} ms")
    del st, kv
    torch.cuda.empty_cache()
    return fused, times


def phase_tp_serve(qf, qc, h6, ops, ref, serve_mod, flush, dev="cuda",
                   cfg=None, prompt_len=16, new_tokens=16, kv_block=16,
                   coder=None):
    """Serving over a model row on one card (inside the NCCL world of
    one): phi3-mini-3.8b at ``TP_SERVE_LAYERS`` of 32 layers (``cfg``)
    through ``launch.serve.serve`` from the QLC weight wire with no mesh
    and under a 1 x 1 mesh (the same weight registry and opened tree),
    then ``Engine(mesh=)`` paged sync and async with
    ``KVCacheSpec(axis="model", exact_capacity=False)`` beside the same
    engines with no mesh: tokens, pooled bytes, KV registry digests and
    K3-K6 launches identical; ``all_gather_block_wire`` over the world;
    K1-K6 at a 1 x 4 deepseek-coder-33b rank's shapes
    (:func:`tp_serve_kernels`, ``coder`` in its place); with two or more
    cards, ``tools/tp_cards.py --serve``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.models import init_params
    from repro_torch.models.transformer import tree_leaves
    cfg = cfg or dataclasses.replace(get_config("phi3-mini-3.8b"),
                                     num_layers=TP_SERVE_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    mesh = make_test_mesh(model=1)
    counters = {"K1": qf.fused_encode, "K2": qf.fused_decode}
    served = {}
    for name, m in (("none", None), ("1 x 1", mesh)):
        for fn in counters.values():
            fn.launches = 0
        with use_mesh(m):
            res = serve_mod.serve(cfg, batch=4, requests=6,
                                  prompt_len=prompt_len,
                                  new_tokens=new_tokens, wire="qlc",
                                  device=dev, params=params)
        served[name] = (res, {k: fn.launches for k, fn in counters.items()})
    (plain, k12_plain), (meshed, k12) = served["none"], served["1 x 1"]
    for kname, c in k12.items():
        if c <= 0 or c != k12_plain[kname]:
            raise AssertionError(f"tp_serve: {kname} launches {c} under the "
                                 f"1 x 1 mesh, {k12_plain[kname]} without")
    if plain["wire_codec"].registry.to_json() != \
            meshed["wire_codec"].registry.to_json():
        raise AssertionError("tp_serve: the 1 x 1 weight registry differs")
    if not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(plain["params"]), tree_leaves(meshed["params"]))):
        raise AssertionError("tp_serve: the 1 x 1 opened tree differs")
    if [o.tokens.tolist() for o in plain["outs"]] != \
            [o.tokens.tolist() for o in meshed["outs"]]:
        raise AssertionError("tp_serve: the 1 x 1 dense engine's tokens "
                             "differ")
    opened, prompts = meshed["params"], meshed["prompts"]
    dense = [o.tokens.tolist() for o in meshed["outs"]]
    log("tp_serve", f"{cfg.name}, {cfg.num_layers} of 32 layers: served "
                    f"from the QLC weight wire with no mesh and under a "
                    f"1 x 1 mesh: weight registry "
                    f"{_digest(meshed['wire_codec'].registry.to_json())}, "
                    "opened tree and dense tokens identical; launches "
                    f"{k12}")
    del plain, served, params
    torch.cuda.empty_cache()
    runs = {name: tp_serve_engines(qc, h6, cfg, opened, prompts, m, dev,
                                   new_tokens, kv_block)
            for name, m in (("none", None), ("1 x 1", mesh))}
    for paging in ("sync", "async"):
        a, b = runs["none"][paging], runs["1 x 1"][paging]
        for i, what in enumerate(("tokens", "pooled bytes",
                                  "KV registry digest", "K3-K6 launches")):
            if a[i] != b[i]:
                raise AssertionError(f"tp_serve: {paging}: {what} under the "
                                     f"1 x 1 mesh {b[i]} != {a[i]}")
        if b[0] != dense:
            raise AssertionError(f"tp_serve: {paging} paging is not "
                                 "token-identical to the dense engine")
        need = ("K3", "K4", "K6") if paging == "sync" else ("K3", "K5", "K6")
        for kname in need:
            if b[3][kname] <= 0:
                raise AssertionError(f"{kname} was not launched on the "
                                     f"tp_serve {paging} path")
        st = b[4]
        log("tp_serve", f"Engine(mesh=1 x 1) {paging}: tokens == no mesh "
                        f"== dense; pool {b[1]} == no mesh; KV registry "
                        f"{b[2]} == no mesh; launches {b[3]} == no mesh; "
                        f"{st['ms_per_token_prefill']:.3f} / "
                        f"{st['ms_per_token_decode']:.3f} ms/token "
                        f"prefill / decode (no mesh "
                        f"{a[4]['ms_per_token_prefill']:.3f} / "
                        f"{a[4]['ms_per_token_decode']:.3f})")
    tp_serve_migration(runs["1 x 1"]["sync"][5], cfg, opened, prompts[0],
                       dev)
    launches = {"K1": k12["K1"], "K2": k12["K2"]}
    for kname in ("K3", "K4", "K5", "K6"):
        launches[kname] = sum(runs["1 x 1"][p][3][kname]
                              for p in ("sync", "async"))
    del runs, opened, meshed
    torch.cuda.empty_cache()
    out = {"launches": launches}
    out["fused"], out["kv"] = tp_serve_kernels(qf, ops, ref, flush, dev,
                                               coder)

    n_cards = torch.cuda.device_count() if dev == "cuda" else 1
    ran = ["1 x 1"]
    if n_cards >= 2:
        cmd = [sys.executable, os.path.join(ROOT, "tools", "tp_cards.py"),
               "--serve", "--cards", str(n_cards), "--model", str(n_cards),
               "--layers", "8", "--requests", "6", "--new-tokens", "16"]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        for line in r.stdout.splitlines():
            log("tp_serve", f"cards: {line}")
        if r.returncode:
            raise AssertionError(f"tp_serve: tools/tp_cards.py --serve "
                                 f"exited {r.returncode}:\n"
                                 f"{r.stderr[-4000:]}")
        ran.append(f"1 x {n_cards}")
    log("tp_serve", f"layouts served: {', '.join(ran)} ({n_cards} card"
                    f"{'s' if n_cards > 1 else ''}; rows of 2 and 4 on gloo "
                    "CPU ranks in tests/test_torch_tp_serve.py and on 4 "
                    "cards in tools/tp_cards.py --serve)")
    out["layouts"] = ran
    return out


#: the sequence split's full-width cell: chatglm3-6b (arXiv:2406.12793),
#: its own 8k context, and the reference's DECODE_32K for the combine
DP_SEQ_ARCH = "chatglm3-6b"
DP_SEQ_PROMPT = 8192
DP_COMBINE_POSITIONS = 32768
#: the prompt and new tokens of the reference's decode rules' runs (sync
#: and async, with no mesh and under each rule set)
DP_RULES_PROMPT, DP_RULES_NEW = 1024, 8


def _split_calls():
    """Wrap the sequence split's decode functions to count their calls
    -> (the counts, a function that puts the originals back): the
    shard's combine (``models.attention._seq_sharded_decode``) and the
    row's decode over every KV head of a range (``_decode_tp`` under a
    shard over the model axis, over a row of one on a 1 x 1 mesh)."""
    from repro_torch.models import attention as attn
    n = {"combine": 0, "every_head": 0}
    combine, row_decode = attn._seq_sharded_decode, attn._decode_tp

    def counted_combine(*a, **kw):
        n["combine"] += 1
        return combine(*a, **kw)

    def counted_row(params, x, cfg, positions, cache, row, shard=None):
        if shard is not None and shard.over_model:
            n["every_head"] += 1
        return row_decode(params, x, cfg, positions, cache, row, shard)

    def restore():
        attn._seq_sharded_decode, attn._decode_tp = combine, row_decode
    attn._seq_sharded_decode, attn._decode_tp = counted_combine, counted_row
    return n, restore


def _dp_serve_runs(serve_mod, counters, cfg, params, mesh, rules, dev,
                   wire="qlc", **kw):
    """``launch.serve.serve`` (from the QLC weight wire unless ``wire`` is
    ``"none"``: ``params`` served as they are) with the paged cache,
    under ``mesh`` and the sharding ``rules``, K1-K6, the split's decode
    calls (:func:`_split_calls`) and the FSDP gathers
    (``launch.mesh.FSDP_COUNTS``) counted from zero -> (tokens, pool
    stats, KV registry digest, launches, stats, split calls, FSDP
    gathers)."""
    from repro_torch.launch.mesh import (FSDP_COUNTS, reset_fsdp_counts,
                                         use_mesh)
    from repro_torch.parallel.sharding import use_rules
    for fn in counters.values():
        fn.launches = 0
    reset_fsdp_counts()
    calls, restore = _split_calls()
    try:
        with use_mesh(mesh), use_rules(rules):
            res = serve_mod.serve(cfg, wire=wire, kv_cache="qlc", device=dev,
                                  params=params, **kw)
    finally:
        restore()
    st = res["stats"]
    return ([o.tokens.tolist() for o in res["outs"]],
            {k: st["pool"][k] for k in ("unique_blocks",
                                         "peak_referenced_bytes",
                                         "resident_bytes", "dedup_hits")},
            _digest(res["kv_registry"].to_json()),
            {k: fn.launches for k, fn in counters.items()}, st, calls,
            FSDP_COUNTS["gathers"])


def _check_fsdp_gathers(where, gathers, fsdp):
    """Fail unless a run under rules that cut parameters by FSDP
    (``fsdp``; on a 1 x 1 mesh a column of one) gathered layer groups
    over the column, and a run without FSDP gathered none."""
    if (gathers > 0) != fsdp:
        raise AssertionError(f"dp_serve: {where}: {gathers} FSDP gathers")


def _served_dense(res, mesh, rules):
    """The dense tree a ``launch.serve.serve`` result served: under FSDP
    its weight wire opened over the data column (here a column of one,
    so the whole tree), else its ``params``."""
    from repro_torch.launch.mesh import fsdp_column, use_mesh
    from repro_torch.parallel.sharding import use_rules
    from repro_torch.serving import open_params
    params = res["params"]
    if res.get("wired") is None or params["groups"] is not res["wired"]:
        return params
    with use_mesh(mesh), use_rules(rules):
        groups = open_params(res["wired"], res["wire_codec"],
                             column=fsdp_column(mesh))
    return dict(params, groups=groups)


def _check_split_calls(where, calls, split, over_model=False):
    """Fail unless a run under a sequence split (``split``) combined the
    shard's partials and, ``over_model``, decoded every KV head of its
    range through the row's branch; and a run with no split did
    neither."""
    want = {"combine": split, "every_head": split and over_model}
    for key, ran in want.items():
        if (calls[key] > 0) != ran:
            raise AssertionError(f"dp_serve: {where}: the split's {key} "
                                 f"decode ran {calls[key]} times")


def dp_serve_combine(cfg, dev, flush, positions=DP_COMBINE_POSITIONS):
    """One attention layer of ``cfg`` (its query and KV heads, f32) decoding
    one token against ``positions`` cached ones, at batch 1 and 4: the
    cache split into D = 2 and D = 4 shards in one process through the
    sequence split's partial and combine functions
    (``models.attention.decode_partial``, ``combine_partials``; a shard
    holds every KV head of its positions, as a range over the model row
    or the mesh does), each held against the unsharded decode within
    rtol 1e-5 / atol 1e-5 (the CPU tests' tolerance) and timed beside
    it."""
    import dataclasses
    from repro_torch.models import attention as attn
    cfg = dataclasses.replace(cfg, dtype="float32")
    hd, h, kv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    need = [j // (h // kv) for j in range(h)]
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for batch in (1, 4):
        q = torch.randn((batch, 1, h, hd), generator=gen, device=dev)
        k, v = (torch.randn((batch, positions, kv, hd), generator=gen,
                            device=dev) for _ in range(2))
        # the last row attends over every position, the others over fewer
        pos = torch.tensor([[positions - 1 - (positions // 8 + 1) * i]
                            for i in range(batch)][::-1], dtype=torch.int32,
                           device=dev)
        whole = attn.KVCache(k=k, v=v, length=pos[:, 0])

        def unsharded():
            return attn._grouped_decode(q, whole, pos, cfg, need)

        want = unsharded()
        row = {"unsharded_ms": time_ms(unsharded, 10, flush)}
        for d in (2, 4):
            n = positions // d
            shards = [attn.KVCache(k=k[:, i * n:(i + 1) * n],
                                   v=v[:, i * n:(i + 1) * n],
                                   length=pos[:, 0]) for i in range(d)]

            def split(shards=shards, n=n):
                return attn.combine_partials([
                    attn.decode_partial(q, c, pos, cfg, need, i * n)
                    for i, c in enumerate(shards)]).reshape(q.shape)
            got = split()
            err = max_abs_err(got, want)
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"dp_serve: the D = {d} combine at "
                                     f"batch {batch} is {err} from the "
                                     "unsharded decode")
            row[f"D{d}"] = {"max_abs_err": err,
                            "ms": time_ms(split, 10, flush)}
        out[f"batch {batch}"] = row
        log("dp_serve", f"combine, one {cfg.name} attention layer ({h} "
                        f"heads over {kv} KV heads x {hd}, f32) at "
                        f"{positions} cached positions, batch {batch}: "
                        + "; ".join(f"D = {d}: max abs err "
                                    f"{row[f'D{d}']['max_abs_err']:.3g}, "
                                    f"partials + combine "
                                    f"{row[f'D{d}']['ms']:.4f} ms"
                                    for d in (2, 4))
                        + f"; unsharded {row['unsharded_ms']:.4f} ms")
        del q, k, v, whole, want
    return out


def phase_dp_serve(qf, qc, h6, ops, ref, serve_mod, flush, dev="cuda",
                   cfg=None, prompt_len=16, new_tokens=16, kv_block=16,
                   glm=None, glm_prompt=DP_SEQ_PROMPT, glm_new=32,
                   glm_block=128, glm_chunk=256,
                   positions=DP_COMBINE_POSITIONS,
                   rules_prompt=DP_RULES_PROMPT, rules_new=DP_RULES_NEW):
    """Serving over the data column on one card (inside the NCCL world of
    one). (a) phi3-mini-3.8b at ``TP_SERVE_LAYERS`` of 32 layers
    (``cfg``) through ``launch.serve.serve`` from the QLC weight wire,
    paged sync and async, with no mesh and under a 1 x 1 mesh, once
    with the default rules (tokens, pool stats, KV registry digests and
    K1-K6 launches identical) and once, in f32, with
    ``make_rules(decode_seq_shard=True)``, whose shard of one rank
    decodes by the split's combine (the same, but the pool's counts
    for its bytes). (b) chatglm3-6b at
    all 28 layers (``glm``), 2 requests at batch 1, a ``glm_prompt``
    prompt prefilled ``glm_chunk`` tokens a step, ``glm_new`` new
    tokens, ``glm_block``-token blocks, sync paging, under the
    sequence-split rules on a 1 x 1 mesh: ms/token, peak, pooled /
    dense, and K3-K6 against plain at its KV planes
    (:func:`check_kv_path`); then, from its served parameters,
    :func:`dp_serve_rules` (the reference's decode rules, sync and
    async, at a ``rules_prompt`` prompt and ``rules_new`` new tokens).
    (c) :func:`dp_serve_combine`
    at ``positions``. Split layouts over several ranks run on gloo CPU
    ranks (tests/test_torch_dp_serve.py) and on four cards
    (``tools/tp_cards.py --serve``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import (fsdp_params, get_rules,
                                               make_rules)
    cfg = cfg or dataclasses.replace(get_config("phi3-mini-3.8b"),
                                     num_layers=TP_SERVE_LAYERS)
    glm = glm or get_config(DP_SEQ_ARCH)
    counters = {"K1": qf.fused_encode, "K2": qf.fused_decode,
                "K3": qc.encode, "K4": qc.decode, "K5": qc.prefetch_decode,
                "K6": h6.histogram256}
    mesh = make_test_mesh(model=1)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    launches = {k: 0 for k in counters}
    # the data column's split of one rank decodes by the shard's combine,
    # in f32 where it and the unsplit softmax round alike
    for rname, rules, run_cfg in (
            ("default", get_rules(), cfg),
            ("decode_seq_shard", make_rules(decode_seq_shard=True),
             dataclasses.replace(cfg, dtype="float32"))):
        split = rname != "default"
        for paging in ("sync", "async"):
            kw = dict(batch=4, requests=6, prompt_len=prompt_len,
                      new_tokens=new_tokens, kv_block=kv_block,
                      kv_paging=paging)
            a = _dp_serve_runs(serve_mod, counters, run_cfg, params, None,
                               rules, dev, **kw)
            b = _dp_serve_runs(serve_mod, counters, run_cfg, params, mesh,
                               rules, dev, **kw)
            _check_split_calls(f"{rname} rules, {paging}, no mesh", a[5],
                               False)
            _check_split_calls(f"{rname} rules, {paging}, 1 x 1", b[5],
                               split)
            # make_rules() cuts parameters by FSDP: on a column of one
            # every decode step gathers each group and opens its wire
            fsdp = fsdp_params(rules)
            _check_fsdp_gathers(f"{rname} rules, {paging}, no mesh", a[6],
                                False)
            _check_fsdp_gathers(f"{rname} rules, {paging}, 1 x 1", b[6],
                                fsdp)
            # the split's decode writes the same blocks from other low
            # bits: their count, not their compressed bytes, must match
            pool_a, pool_b = ((p if not split else
                               {k: p[k] for k in ("unique_blocks",
                                                  "dedup_hits")})
                              for p in (a[1], b[1]))
            # the wire opened once with no mesh, in every step under FSDP
            same = [k for k in a[3] if not (fsdp and k == "K2")]
            if fsdp and not b[3]["K2"] > a[3]["K2"]:
                raise AssertionError(f"dp_serve: {rname} rules, {paging}: "
                                     f"K2 {b[3]['K2']} launches under FSDP, "
                                     f"{a[3]['K2']} with no mesh")
            for what, x, y in (("tokens", a[0], b[0]),
                               ("pool", pool_a, pool_b),
                               ("KV registry digest", a[2], b[2]),
                               ("K1-K6 launches but an FSDP run's K2",
                                {k: a[3][k] for k in same},
                                {k: b[3][k] for k in same})):
                if x != y:
                    raise AssertionError(
                        f"dp_serve: {rname} rules, {paging}: {what} under "
                        f"the 1 x 1 mesh {y} != {x} with no mesh")
            need = ("K1", "K2", "K3", "K6") + (
                ("K4",) if paging == "sync" else ("K5",))
            for kname in need:
                if b[3][kname] <= 0:
                    raise AssertionError(f"{kname} was not launched on the "
                                         f"dp_serve {paging} path")
            for kname, c in b[3].items():
                launches[kname] += c
            log("dp_serve", f"{cfg.name}, {cfg.num_layers} of 32 layers, "
                            f"compute {run_cfg.dtype}, {rname} rules, "
                            f"{paging}: the 1 x 1 mesh == no mesh in "
                            f"tokens, pool {pool_b}, KV registry {b[2]}, "
                            f"launches {b[3]}; pool {b[1]} (no mesh "
                            f"{a[1]}); split decode calls {b[5]}; FSDP "
                            f"gathers {b[6]}; "
                            f"{b[4]['ms_per_token_prefill']:.3f} / "
                            f"{b[4]['ms_per_token_decode']:.3f} ms/token "
                            "prefill / decode (no mesh "
                            f"{a[4]['ms_per_token_prefill']:.3f} / "
                            f"{a[4]['ms_per_token_decode']:.3f})")
    del params, a, b
    torch.cuda.empty_cache()

    # (b) chatglm3-6b at all 28 layers, the sequence-split rules, 8k
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.parallel.sharding import use_rules
    calls, restore = _split_calls()
    try:
        with use_mesh(mesh), use_rules(make_rules(decode_seq_shard=True)):
            res = serve_mod.serve(glm, batch=1, requests=2,
                                  prompt_len=glm_prompt, new_tokens=glm_new,
                                  wire="qlc", kv_cache="qlc",
                                  kv_block=glm_block, kv_paging="sync",
                                  device=dev, seed=0,
                                  prefill_chunk=glm_chunk)
    finally:
        restore()
    run_s = time.perf_counter() - t0
    _check_split_calls(f"{glm.name} at {glm_prompt}", calls, True)
    glm_params = _served_dense(res, mesh, make_rules(decode_seq_shard=True))
    glm_launches = {k: fn.launches for k, fn in counters.items()}
    for kname in ("K1", "K2", "K3", "K4", "K6"):
        if glm_launches[kname] <= 0:
            raise AssertionError(f"{kname} was not launched on the dp_serve "
                                 f"{glm.name} path")
    for kname, c in glm_launches.items():
        launches[kname] += c
    outs, st = res["outs"], res["stats"]
    if not all(o.state == "finished" and len(o.tokens) == glm_new
               for o in outs):
        raise AssertionError([(o.request_id, o.state) for o in outs])
    ps = st["pool"]
    pooled = ps["peak_referenced_bytes"] / max(
        1, st["peak_dense_logical_bytes"])
    peak = (torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda"
            else float("nan"))
    n_params = sum(t.numel() for t in _leaves(glm_params))
    log("dp_serve", f"{glm.name}: all {glm.num_layers} layers, d_model "
                    f"{glm.d_model}, {glm.num_heads} heads over "
                    f"{glm.num_kv_heads} KV heads x {glm.resolved_head_dim}, "
                    f"d_ff {glm.d_ff}, vocab {glm.vocab_size}, {n_params} "
                    f"parameters ({glm.param_dtype}), compute {glm.dtype}; "
                    f"make_rules(decode_seq_shard=True) on a 1 x 1 mesh "
                    f"(a shard of one rank: split decode calls {calls}), "
                    f"2 requests at batch 1, prompt {glm_prompt} "
                    f"({glm_chunk} tokens a prefill step), {glm_new} new "
                    f"tokens, --wire qlc --kv-cache qlc --kv-block "
                    f"{glm_block} sync: the paged run == the dense one; "
                    f"{st['ms_per_token_prefill']:.4f} ms/token prefill, "
                    f"{st['ms_per_token_decode']:.3f} ms/token decode; "
                    f"pooled / dense {pooled:.4f} ({ps['unique_blocks']} "
                    f"blocks); peak {peak:.2f} GiB; launches "
                    f"{glm_launches}; {run_s:.1f} s")
    kv = check_kv_path(ops, ref, glm, glm_params,
                       res["prompts"][0][:2 * glm_block], flush, dev,
                       phase="dp_serve", block=glm_block, chunk=glm_block)
    rules_runs = dp_serve_rules(serve_mod, counters, glm, glm_params,
                                mesh, dev, rules_prompt, rules_new,
                                glm_block, glm_chunk)
    for kname, c in rules_runs.pop("launches").items():
        launches[kname] += c
    del res, outs, glm_params
    torch.cuda.empty_cache()
    combine = dp_serve_combine(glm, dev, flush, positions)
    return {"launches": launches, "kv": kv, "combine": combine,
            "glm": {"prefill": st["ms_per_token_prefill"],
                    "decode": st["ms_per_token_decode"],
                    "pooled_over_dense": pooled, "peak_gib": peak},
            "rules": rules_runs}


def dp_serve_rules(serve_mod, counters, glm, params, mesh, dev, prompt_len,
                   new_tokens, kv_block, chunk):
    """``glm`` (its served parameters ``params``, computing in f32, where
    the split's combine and the unsplit softmax round alike) under the
    reference's decode rules on the 1 x 1 ``mesh``: ``kv_seq -> model``,
    and ``parallel.sharding.decode_rules`` at a batch of 1 (``kv_seq ->
    ("data", "model")``, ``batch -> None``), paged sync and async, 2
    requests at batch 1. Each rule gives a shard of one rank, whose
    decode runs the split path (:func:`_check_split_calls`: the row's
    branch over every KV head of its range, over a row of one, and the
    shard's combine) and pages its range: tokens equal to the same
    paging's run with no mesh, and K3 and K6 launched on every run, K4
    on the sync ones, K5 on the async ones -> {rule: {paging:
    ms/token}}, and ``launches``."""
    import dataclasses
    from repro_torch.parallel.sharding import (decode_rules, get_rules,
                                               make_rules)
    glm = dataclasses.replace(glm, dtype="float32")
    rule_sets = {"kv_seq -> model": make_rules(extra={"kv_seq": "model"}),
                 "kv_seq -> (data, model), batch -> None":
                     decode_rules(glm, 1, mesh)}
    launches = {k: 0 for k in counters}
    out = {}
    for paging in ("sync", "async"):
        kw = dict(batch=1, requests=2, prompt_len=prompt_len,
                  new_tokens=new_tokens, kv_block=kv_block,
                  kv_paging=paging, prefill_chunk=chunk, seed=0)
        alone = _dp_serve_runs(serve_mod, counters, glm, params, None,
                               get_rules(), dev, wire="none", **kw)
        _check_split_calls(f"{glm.name}, {paging}, no mesh", alone[5],
                           False)
        _check_fsdp_gathers(f"{glm.name}, {paging}, no mesh", alone[6],
                            False)
        for rname, rules in rule_sets.items():
            got = _dp_serve_runs(serve_mod, counters, glm, params, mesh,
                                 rules, dev, wire="none", **kw)
            _check_split_calls(f"{glm.name} under {rname}, {paging}",
                               got[5], True, True)
            # both rule sets cut parameters by FSDP: a column of one
            _check_fsdp_gathers(f"{glm.name} under {rname}, {paging}",
                                got[6], True)
            if got[0] != alone[0]:
                raise AssertionError(f"dp_serve: {glm.name} under {rname}, "
                                     f"{paging}: tokens {got[0]} != "
                                     f"{alone[0]} with no mesh")
            need = ("K3", "K6") + (("K4",) if paging == "sync" else ("K5",))
            for kname in need:
                if got[3][kname] <= 0:
                    raise AssertionError(f"{kname} was not launched on the "
                                         f"dp_serve {rname} {paging} path")
            for kname, c in got[3].items():
                launches[kname] += c
            st = got[4]
            out.setdefault(rname, {})[paging] = {
                "prefill": st["ms_per_token_prefill"],
                "decode": st["ms_per_token_decode"]}
            log("dp_serve", f"{glm.name}, all {glm.num_layers} layers, "
                            f"{rname} on a 1 x 1 mesh (a shard of one "
                            f"rank), f32, {paging}, prompt {prompt_len}, "
                            f"{new_tokens} new tokens, 2 requests at batch "
                            f"1: tokens == no mesh; split decode calls "
                            f"{got[5]}; FSDP gathers {got[6]}; launches "
                            f"{got[3]}; "
                            f"{st['ms_per_token_prefill']:.4f} / "
                            f"{st['ms_per_token_decode']:.3f} ms/token "
                            f"prefill / decode (no mesh "
                            f"{alone[4]['ms_per_token_prefill']:.4f} / "
                            f"{alone[4]['ms_per_token_decode']:.3f})")
    out["launches"] = launches
    return out


def phase_fsdp(qf, serve_mod, dev="cuda", cfg=None, seq_len=512,
               global_batch=4, steps=2, serve_cfg=None, prompt_len=16,
               new_tokens=8):
    """FSDP on a data column of one (inside the NCCL world of one, a 1 x 1
    mesh): (a) the train cell's baseline step (phi3-mini-3.8b, 8 of 32
    layers, ``global_batch`` x ``seq_len``) under ``make_rules()``, each
    layer group gathered over the column and its gradients
    reduce-scattered (``launch.mesh.FSDP_COUNTS``; the phase fails
    without them), bit-equal to the TP-only baseline step on the same
    mesh (deterministic algorithms on, as around the train phases);
    (b) the slice's decode (phi3-mini-3.8b, all 32 layers, the QLC
    weight wire) under the reference's decode rules
    (``serve(reference_rules=True)``: FSDP), the wire kept compressed and
    opened a group at a time through the sharded open over the column of
    one (K2 each hop), token-equal to the unsharded engine (the wire
    opened once, no mesh) -> {"launches": K1 / K2 of (b), "train":
    ms/step, gathers and reduce-scatters a step, "serve": ms/token}."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.train import train
    from repro_torch.parallel.sharding import make_rules, use_rules
    cfg = _train_cell(cfg)
    mesh = tmesh.make_test_mesh(model=1)
    kw = dict(steps=steps, seq_len=seq_len, global_batch=global_batch,
              device=dev, seed=0)
    runs = {}
    for name, rules in (("tp_only", None), ("fsdp", make_rules())):
        if dev == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        tmesh.reset_fsdp_counts()
        with tmesh.use_mesh(mesh), use_rules(rules):
            res = train(cfg, comm="baseline", **kw)
        runs[name] = {
            "losses": [h["loss"] for h in res["history"]],
            "step_ms": [h["dt"] * 1e3 for h in res["history"]],
            "params": _flat_params(res["params"]),
            "counts": dict(tmesh.FSDP_COUNTS),
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if dev == "cuda" else float("nan"))}
        del res
    a, b = runs["tp_only"], runs["fsdp"]
    if a["counts"]["gathers"] or a["counts"]["reduce_scatters"]:
        raise AssertionError(f"fsdp: the TP-only step gathered: "
                             f"{a['counts']}")
    if not (b["counts"]["gathers"] and b["counts"]["reduce_scatters"]):
        raise AssertionError(f"fsdp: the FSDP step did not gather and "
                             f"reduce-scatter: {b['counts']}")
    if a["losses"] != b["losses"]:
        raise AssertionError(f"fsdp: losses {b['losses']} != TP-only "
                             f"{a['losses']}")
    require_equal("the FSDP baseline step's parameters vs the TP-only "
                  "step's", [b["params"]], [a["params"]])
    per_step = {k: v / steps for k, v in b["counts"].items()}
    log("fsdp", f"{cfg.name}, {cfg.num_layers} of 32 layers, batch "
                f"{global_batch} x {seq_len}, {steps} baseline steps on a "
                f"1 x 1 mesh under make_rules() (a column of one): "
                f"{per_step['gathers']:.0f} gathers and "
                f"{per_step['reduce_scatters']:.0f} reduce-scatters a "
                f"step; {b['params'].numel()} parameters and losses "
                f"{b['losses']} bit-equal to the TP-only step; "
                f"{[round(t, 3) for t in b['step_ms']]} ms/step (TP-only "
                f"{[round(t, 3) for t in a['step_ms']]}); peak "
                f"{b['peak_gib']:.2f} GiB (TP-only {a['peak_gib']:.2f})")
    del runs, a, b
    if dev == "cuda":
        torch.cuda.empty_cache()

    serve_cfg = serve_cfg or get_config("phi3-mini-3.8b")
    skw = dict(batch=4, requests=4, prompt_len=prompt_len,
               new_tokens=new_tokens, wire="qlc", device=dev, seed=0)
    plain = serve_mod.serve(serve_cfg, **skw)
    want = [o.tokens.tolist() for o in plain["outs"]]
    plain_ms = plain["stats"]["ms_per_token_decode"]
    del plain
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    counters = {"K1": qf.fused_encode, "K2": qf.fused_decode}
    for fn in counters.values():
        fn.launches = 0
    tmesh.reset_fsdp_counts()
    with tmesh.use_mesh(mesh):
        res = serve_mod.serve(serve_cfg, reference_rules=True, **skw)
    launches = {k: fn.launches for k, fn in counters.items()}
    counts = dict(tmesh.FSDP_COUNTS)
    got = [o.tokens.tolist() for o in res["outs"]]
    wc, wired = res["wire_codec"], res["wired"]
    if res["params"]["groups"] is not wired:
        raise AssertionError("fsdp: the engine did not serve the wire")
    if got != want:
        raise AssertionError(f"fsdp: tokens from the wire opened over the "
                             f"column {got} != the unsharded engine's "
                             f"{want}")
    for kname, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{kname} was not launched on the fsdp "
                                 "serving path")
    if not counts["gathers"]:
        raise AssertionError("fsdp: the decode gathered no FSDP block")
    st = res["stats"]
    peak = (torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda"
            else float("nan"))
    log("fsdp", f"{serve_cfg.name}, all {serve_cfg.num_layers} layers, "
                f"--wire qlc under the reference's decode rules on a 1 x 1 "
                f"mesh: {len(wc.meta)} leaves on the wire, kept compressed "
                f"and opened a group at a time through the sharded open of "
                f"one rank (K2 {launches['K2']} launches, K1 "
                f"{launches['K1']}); {counts['gathers']} FSDP gathers of "
                f"the dense leaves; tokens == the unsharded engine's; "
                f"{st['ms_per_token_prefill']:.3f} / "
                f"{st['ms_per_token_decode']:.3f} ms/token prefill / "
                f"decode (the wire opened once, no mesh: {plain_ms:.3f} "
                f"decode); peak {peak:.2f} GiB")
    del res, wired
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "train": per_step,
            "serve": {"decode": st["ms_per_token_decode"],
                      "prefill": st["ms_per_token_prefill"],
                      "plain_decode": plain_ms, "peak_gib": peak}}


def codes_kernel_entries(src, codes_par, kv_runs, kv_times, k3_shapes):
    """The kernels-line entries of K3-K5: parity-shape times, KV-path
    times (and K3's at ``K3_SHAPES``), and launches summed over the KV
    runs that use each kernel."""
    run_of = {"K3": ("sync", "async"), "K4": ("sync",), "K5": ("async",)}
    out = []
    for kname, fn, cu, replaces in (
            ("K3", "encode", "qlc_encode.cu", "qlc_encode.py:56"),
            ("K4", "decode", "qlc_decode.cu", "qlc_decode.py:75"),
            ("K5", "prefetch_decode", "qlc_prefetch.cu",
             "qlc_prefetch.py:102")):
        p, kv = codes_par[kname], kv_times[kname]
        out.append({
            "name": f"{kname} {fn}", "route": "cuda", "source": src + cu,
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": sum(n[kname] for paging, n in kv_runs
                            if paging in run_of[kname]),
            "launches_by_run": [[paging, n[kname]] for paging, n in kv_runs],
            "max_abs_err": max(p["err"], kv["err"]),
            "ms": p["ms"], "kernel_ms": p["kernel_ms"],
            "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shape": p["shape"], "cap": p["cap"],
            "kv_path": {k: kv[k] for k in ("shape", "cap", "ms", "kernel_ms",
                                           "plain_ms", "bound_ms")}})
    out[0]["shapes"] = k3_shapes
    out[0]["max_abs_err"] = max([out[0]["max_abs_err"]]
                                + [r["err"] for r in k3_shapes.values()])
    return out


def profile_step(decode_step, params, cfg, states, tok, pos):
    """One engine-shaped decode step (batch 4): its wall time without the
    profiler, then under torch.profiler the device's busy time
    (``roofline.trace``: kernels and copies, not PyTorch's annotation
    ranges), the device idle share, and the kernels that took the most
    time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.roofline.trace import busy_us, device_events
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_step(params, cfg, tok, states, pos)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode_step(params, cfg, tok, states, pos)
        torch.cuda.synchronize()
    events = device_events(prof)
    if not events:
        log("profile", f"one decode step, batch 4: wall {wall_ms:.3f} ms; "
                       "device time not measured (the profiler recorded "
                       "no kernels)")
        return
    busy_ms = busy_us(events) / 1e3
    by_name = {}
    for _, name, t0, t1 in events:
        v = by_name.setdefault(name, [0, 0.0])
        v[0] += 1
        v[1] += (t1 - t0) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    log("profile", f"one decode step, batch 4: wall {wall_ms:.3f} ms, "
                   f"device busy {busy_ms:.3f} ms in {len(events)} "
                   f"launches, device idle share {1 - busy_ms / wall_ms:.3f}"
                   "; top kernels: " + "; ".join(
                       f"{n[:72]} {ms:.3f} ms x{k}" for n, (k, ms) in top))


#: The roofline phase's cells: (name, arch, shape, comm, layers, seq_len,
#: global batch). The train cell at 8 of 32 layers, 4 x 512, compressed
#: and baseline; the slice's decode step at all 32 layers, batch 4, on
#: the QLC weight wire (a 64-position cache).
ROOFLINE_CELLS = (
    ("train_qlc", "phi3-mini-3.8b", "train_4k", "qlc", 8, 512, 4),
    ("train_baseline", "phi3-mini-3.8b", "train_4k", "baseline", 8, 512, 4),
    ("slice_decode", "phi3-mini-3.8b", "decode_32k", "qlc", 32, 64, 4),
)
#: the phase's tolerances: counted product FLOPs against the profiler's
#: ``with_flops`` total, and the counted peak against the allocator's
ROOFLINE_FLOP_TOL = 0.02
ROOFLINE_PEAK_TOL = 0.15
#: the profiled steps' data: parameters, the synthetic stream's batch and
#: the decode's tokens drawn from it, the decode's weights on their wire
ROOFLINE_SEED = 0


def nccl_calls(record) -> int:
    """The counted collectives that NCCL runs on the device: every call
    over more than one rank; on one rank NCCL runs an in-place
    all-reduce or broadcast as nothing at all, and a gather, scatter or
    all-to-all as a copy inside the call's ``nccl:`` range, which
    ``roofline.trace.device_events`` gives to NCCL."""
    if sum(record.coll_ranks.values()):
        return sum(record.coll_calls.values())
    return sum(n for k, n in record.coll_calls.items()
               if k not in ("all-reduce", "broadcast"))


def _stop(procs):
    for p, _ in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _start_dryrun(out_dir: str, cell, wire_caps=None):
    """Start the dry run of one roofline cell in a subprocess of its own
    (a process holds one default process group; this one holds NCCL's),
    on a fake world of 1 -> (Popen, json path). ``wire_caps``: a decode
    cell's real weight wire slots by leaf."""
    name, arch, shape, comm, layers, seq, batch = cell
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    out = os.path.join(out_dir, f"{name}.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--comm", comm, "--world", "1",
           "--seq-len", str(seq), "--global-batch", str(batch),
           "--override", f"num_layers={layers}",
           "--no-checkpoint-early-stop", "--out", out]
    if wire_caps is not None:
        caps = os.path.join(out_dir, f"{name}.caps.json")
        with open(caps, "w") as f:
            json.dump(wire_caps, f)
        cmd += ["--wire-caps", caps]
    return (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True), out)


def start_roofline_dryruns(out_dir: str):
    """Start the dry runs of the train cells while the card runs the other
    phases (a decode cell's waits for its real wire's slots, in
    :func:`phase_roofline`). -> {cell: (Popen, json path)}."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    atexit.register(_stop, procs)
    for cell in ROOFLINE_CELLS:
        if cell[2].startswith("train"):
            procs[cell[0]] = _start_dryrun(out_dir, cell)
    return procs


def phase_roofline(procs, smi, dev="cuda", out_dir=None):
    """Each roofline cell counted by its dry run and profiled once on the
    card (``roofline.trace``) on real data (``ROOFLINE_SEED``: the
    synthetic stream's batch; the decode's weights on their QLC wire,
    whose slots its dry run takes): per class device ms against its
    bound, idle share and mfu. Fails unless the counted product FLOPs
    are within 2 % of the profiler's, each of K1-K6 was counted as often
    as it launched, the collectives counted equal those NCCL ran on the
    device (:func:`nccl_calls`), the counted peak is within 15 % of the
    allocator's, and the device's busy time is within the step's wall
    time. The dry run counts each checkpointed block's recompute whole,
    as the profiled step runs it."""
    import dataclasses
    import gzip
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.comm.weights import wire_capacities
    from repro_torch.roofline import analysis, trace
    from repro_torch.roofline.op_count import OpRecord
    res = {}
    for cell in ROOFLINE_CELLS:
        name, arch, shape_name, comm, layers, seq, batch = cell
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        shape = dryrun.cell_shape(cfg, shape_name,
                                  {"seq_len": seq, "global_batch": batch})
        mesh = make_test_mesh(model=1)
        rules, _ = dryrun.cell_rules(cfg, shape, mesh, comm)
        tables = dryrun.cell_tables(shape.kind)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        with shd.use_rules(rules), use_mesh(mesh):
            step, live = dryrun.build_cell(cfg, shape, mesh, comm, dev,
                                           tables, seed=ROOFLINE_SEED)
        if name not in procs:
            procs[name] = _start_dryrun(
                out_dir, cell, wire_capacities(live[0]["groups"]))
        proc, path = procs[name]
        out = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise AssertionError(f"roofline: the dry run of {name} failed:\n"
                                 + out[-3000:])
        with gzip.open(path.replace(".json", ".ops.json.gz"), "rt") as f:
            record = OpRecord.from_json(json.load(f))
        with shd.use_rules(rules), use_mesh(mesh):
            prof = trace.profile_step(
                step, record=record,
                model_flops=analysis.model_flops_for(cfg, shape))
        del step, live
        torch.cuda.empty_cache()
        cls = prof["classes"]
        counted = record.kernel_calls()
        launched = {k: cls[k]["launches"] for k in counted}
        flops, pflops = record.flops, prof["profiler_flops"]
        peak = prof["peak_bytes"] - base
        coll = nccl_calls(record)
        coll_ranks = sum(record.coll_ranks.values())
        nccl = cls["NCCL"]["launches"]
        log("roofline", f"{name} ({arch}, {layers} layers, {batch} x {seq}, "
                        f"{comm}, data from seed {ROOFLINE_SEED}; {smi}): wall {prof['wall_ms']:.3f} ms, "
                        f"device busy {prof['busy_ms']:.3f} ms, idle share "
                        f"{prof['idle_share']:.3f}, mfu {prof['mfu']:.4f}")
        for c, v in cls.items():
            if v["launches"] or v["bound_ms"]:
                b = v["bound_ms"]
                log("roofline", f"  {c}: {v['launches']} launches, "
                                f"{v['ms']:.3f} ms, bound "
                                f"{'-' if b is None else f'{b:.3f}'} ms; "
                                + "; ".join(f"{n} x{k} {t:.3f} ms"
                                            for n, k, t in v["top"]))
        counted_products = {k: [o["calls"], sum(o["flops"].values())]
                            for k, o in record.ops.items() if o["flops"]}
        log("roofline", f"  products: profiler {prof['products']}; counted "
                        f"{counted_products}")
        log("roofline", f"  product FLOPs counted {flops:.6g}, profiler "
                        f"{pflops:.6g}; kernels counted {counted}, launched "
                        f"{launched}; collectives counted {record.coll_calls}"
                        f" ({coll_ranks} over more than one rank; {coll} "
                        f"with device work), NCCL on the device {nccl}; "
                        f"peak counted {record.peak_bytes / 2**30:.3f} GiB, "
                        f"allocated {peak / 2**30:.3f} GiB")
        bad = []
        if not pflops or abs(flops - pflops) > ROOFLINE_FLOP_TOL * pflops:
            bad.append(f"FLOPs {flops:.6g} vs profiler {pflops:.6g}")
        if counted != launched:
            bad.append(f"kernels counted {counted} vs launched {launched}")
        if nccl != coll:
            bad.append(f"collectives counted {coll} vs NCCL kernels {nccl}")
        if abs(record.peak_bytes - peak) > ROOFLINE_PEAK_TOL * peak:
            bad.append(f"peak counted {record.peak_bytes} vs allocated {peak}")
        if prof["idle_share"] < 0:
            bad.append(f"device busy {prof['busy_ms']:.3f} ms over the "
                       f"step's {prof['profiled_wall_ms']:.3f} ms")
        if bad:
            raise AssertionError(f"roofline {name}: " + "; ".join(bad))
        res[name] = {"wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
                     "idle_share": prof["idle_share"], "mfu": prof["mfu"],
                     "classes": cls, "flops": flops,
                     "profiler_flops": pflops, "peak_bytes": peak,
                     "counted_peak_bytes": record.peak_bytes}
        if out_dir:
            with open(os.path.join(out_dir, f"{name}.trace.json"), "w") as f:
                json.dump({"cell": name, "card": smi,
                           "data_seed": ROOFLINE_SEED, **res[name]}, f,
                          indent=1)
    return res


def _leaves(tree):
    from repro_torch.models.transformer import tree_leaves
    return tree_leaves(tree)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--moe-serve-layers", type=int, default=None,
                    metavar="L", help="run only the moe_serve phase, at L "
                    "of deepseek-moe-16b's 28 layers, and print its peak")
    ap.add_argument("--ssm-only", action="store_true",
                    help="run only the build and the ssm phase")
    ap.add_argument("--variants-only", action="store_true",
                    help="run only the build and the variants phase")
    ap.add_argument("--tp-only", action="store_true",
                    help="run only the build and the tp phase")
    ap.add_argument("--tp-serve-only", action="store_true",
                    help="run only the build and the tp_serve phase")
    ap.add_argument("--dp-serve-only", action="store_true",
                    help="run only the build and the dp_serve phase")
    ap.add_argument("--roofline-only", action="store_true",
                    help="run only the build and the roofline phase")
    ap.add_argument("--fsdp-only", action="store_true",
                    help="run only the build and the fsdp phase")
    args = ap.parse_args(argv)
    # Both are read when CUDA first starts. cuBLAS reads this when it
    # first makes its handle; the train phase runs with deterministic
    # algorithms, which need it.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # The train, adapt and moe phases each hold most of the card; the
    # allocator's expandable segments keep the blocks earlier phases
    # left cached from fragmenting what the next one needs.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    roof_dir = os.path.join(ROOT, "results", "roofline")
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import lut, schemes
    from repro_torch.kernels import histogram256 as h6
    from repro_torch.kernels import ops, qlc_codes as qc, qlc_fused as qf
    from repro_torch.kernels import ref
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.mesh import data_parallel
    from repro_torch.quant import e4m3

    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{torch.cuda.get_device_name(0)} | {smi} | torch "
                  f"{torch.__version__} cuda {torch.version.cuda} | "
                  f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
                  f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    build_s, build_log = qf.build_kernels()
    regs = [ln.strip() for ln in build_log.splitlines() if "registers" in ln]
    log("build", f"{build_s:.2f} s (nvcc, sources built in parallel); "
                 + " | ".join(regs))

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    if args.moe_serve_layers is not None:
        import dataclasses
        res = phase_moe_serve(qf, qc, h6, ops, ref, serve_mod, flush,
                              cfg=dataclasses.replace(
                                  get_config("deepseek-moe-16b"),
                                  num_layers=args.moe_serve_layers))
        steps = res["drops_per_step"]
        log("depth", f"{args.moe_serve_layers} layers alone: peak "
                     f"{res['peak_gib']:.2f} GiB (the path's "
                     f"{res['path_peak_gib']:.2f}), {res['free_gib']:.2f} "
                     "GiB never reserved; ms/token prefill/decode "
                     + ", ".join(f"{k} {v['prefill']:.3f}/{v['decode']:.3f}"
                                 for k, v in res["ms_per_token"].items())
                     + f"; {sum(steps) / len(steps):.2f} drops a decode "
                     "step")
        print(smi)
        return
    if args.ssm_only:
        phase_ssm(qf, qc, h6, ops, ref, serve_mod, flush)
        print(smi)
        return
    if args.variants_only:
        phase_variants(qf, qc, h6, ops, ref, serve_mod, flush)
        print(smi)
        return
    if args.tp_only:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with data_parallel("cuda"):
            phase_tp(qf, h6, ops, ref, flush)
        print(smi)
        return
    if args.tp_serve_only:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with data_parallel("cuda"):
            phase_tp_serve(qf, qc, h6, ops, ref, serve_mod, flush)
        print(smi)
        return
    if args.dp_serve_only:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with data_parallel("cuda"):
            phase_dp_serve(qf, qc, h6, ops, ref, serve_mod, flush)
        print(smi)
        return
    if args.fsdp_only:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with data_parallel("cuda"):
            phase_fsdp(qf, serve_mod)
        print(smi)
        return
    if args.roofline_only:
        roof = start_roofline_dryruns(roof_dir)
        with data_parallel("cuda"):
            phase_roofline(roof, smi, out_dir=roof_dir)
        print(smi)
        return
    par = phase_parity(qf, ops, ref, lut, schemes, flush)
    t0 = time.perf_counter()
    bad = e4m3_exhaustive(qf, e4m3)
    if bad:
        raise AssertionError(f"K1's e4m3 encoder differs from the plain one "
                             f"on {bad} of 2^32 f32 bit patterns")
    log("parity", "K1's e4m3 encoder == plain e4m3_encode on all 2^32 f32 "
                  f"bit patterns ({time.perf_counter() - t0:.2f} s)")
    from repro_torch.core import codec
    for kname, e in phase_edge_parity(ops, ref, lut, schemes, codec).items():
        par[kname]["err"] = max(par[kname]["err"], e)
    codes_par = phase_codes_parity(ops, ref, lut, schemes, flush)
    for kname, e in phase_codes_edge(ops, ref, lut, schemes, codec).items():
        codes_par[kname]["err"] = max(codes_par[kname]["err"], e)
    codes_par["K3"]["err"] = max(codes_par["K3"]["err"],
                                 phase_k3_edge(ops, ref, lut, schemes, codec))
    k3_shapes = phase_k3_shapes(ops, ref, lut, schemes, flush)
    phase_sync_free(ops, lut, schemes, codec)
    hist_par = phase_hist_parity(ops, ref, flush)
    phase_small(serve_mod, reduced, get_config)
    launches, main_shape, opened, cfg = phase_slice(qf, serve_mod, e4m3,
                                                    ref, flush)
    cfg, opened = depth_cut(cfg, opened, KV_LAYERS)
    kv_runs, kv_times = phase_kv(qf, qc, serve_mod, cfg, opened, ops, ref,
                                 flush)
    kvmon = phase_kv_monitor(qc, h6, serve_mod, cfg, opened,
                             next(n["K6"] for paging, n in kv_runs
                                  if paging == "sync"))
    del opened
    torch.cuda.empty_cache()

    # the roofline phase's dry runs count on the host's cores while the
    # train phases run on the card (the earlier phases time plain
    # versions on the CPU, which they would slow)
    roof = start_roofline_dryruns(roof_dir)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with data_parallel("cuda"):
        phase_train_small(reduced, get_config)
        phase_sync_free_train(reduced, get_config)
        phase_train_recipe()
        tr = phase_train(qf, h6, ops, ref, flush)
        torch.cuda.empty_cache()
        phase_roofline(roof, smi, out_dir=roof_dir)
        torch.cuda.empty_cache()
        tp = phase_tp(qf, h6, ops, ref, flush)
        torch.cuda.empty_cache()
        tps = phase_tp_serve(qf, qc, h6, ops, ref, serve_mod, flush)
        torch.cuda.empty_cache()
        dps = phase_dp_serve(qf, qc, h6, ops, ref, serve_mod, flush)
        torch.cuda.empty_cache()
        fsdp = phase_fsdp(qf, serve_mod)
        torch.cuda.empty_cache()
        resume = phase_ckpt_resume(qf, h6, reduced, get_config)
        auto = phase_autotune(qf, tr, flush)
        adapt = phase_adapt(qf, h6, ops, flush, tr, smi)
        torch.cuda.empty_cache()
        moe_res = phase_moe(qf, qc, h6, ops, ref, flush)
    torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    moe_serve = phase_moe_serve(qf, qc, h6, ops, ref, serve_mod, flush)
    ssm_res = phase_ssm(qf, qc, h6, ops, ref, serve_mod, flush)
    var = phase_variants(qf, qc, h6, ops, ref, serve_mod, flush)
    ck = phase_ckpt(qc, h6, ops, ref, flush)

    src = "src/repro_torch/kernels/csrc/"
    kernels = []
    for kname, fn, line, cu in (
            ("K1", "fused_encode", 169, "qlc_fused_encode.cu"),
            ("K2", "fused_decode", 294, "qlc_fused_decode.cu")):
        p = par[kname]
        entry = {"name": f"{kname} {fn}", "route": "cuda",
                 "source": src + cu,
                 "replaces": f"src/repro/kernels/qlc_fused.py:{line}",
                 "launches": launches[kname],
                 "max_abs_err": max(p["err"],
                                    main_shape[kname]["max_abs_err"],
                                    tr["fused"][kname]["max_abs_err"]),
                 "ms": p["ms"], "kernel_ms": p["kernel_ms"],
                 "plain_ms": p["plain_ms"],
                 "bound_ms": p["bound_ms"], "bound_by": "bytes",
                 "library_ms": None, "shape": [4096, 1024],
                 "main_path": main_shape[kname],
                 "train_launches": tr["launches"][kname],
                 "train_path": tr["fused"][kname],
                 "autotune_launches": auto["launches"][kname],
                 "autotune_probe": auto["probe"] if kname == "K2" else None,
                 "launcher_resume_launches": resume["launches"][kname],
                 "adapt_launches": adapt["launches"][kname],
                 "moe_launches": moe_res["launches"][kname],
                 "moe_path": moe_res["fused"][kname],
                 "moe_serve_launches": moe_serve["launches"][kname],
                 "moe_serve_path": moe_serve["fused"][kname],
                 "ssm_launches": ssm_res["launches"][kname],
                 "ssm_path": ssm_res["fused"][kname],
                 "variants_launches": var["launches"][kname],
                 "variants_path": var["fused"][kname],
                 "tp_launches": tp["launches"][kname],
                 "tp_moe_launches": tp["moe_launches"][kname],
                 "tp_path": tp["fused"][kname],
                 "tp_serve_launches": tps["launches"][kname],
                 "tp_serve_path": tps["fused"][kname],
                 "dp_serve_launches": dps["launches"][kname],
                 "fsdp_launches": fsdp["launches"][kname]}
        entry["max_abs_err"] = max(entry["max_abs_err"], auto["err"],
                                   tp["fused"][kname]["max_abs_err"],
                                   tps["fused"][kname]["max_abs_err"],
                                   adapt["err"],
                                   moe_res["fused"][kname]["max_abs_err"],
                                   moe_serve["fused"][kname]["max_abs_err"],
                                   ssm_res["fused"][kname]["max_abs_err"],
                                   var["fused"][kname]["max_abs_err"])
        if kname == "K1":
            entry["train_path_hist"] = adapt["k1_hist"]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       adapt["k1_hist"]["max_abs_err"])
        if "forms" in p:
            entry["forms"] = p["forms"]
        kernels.append(entry)
    kernels += codes_kernel_entries(src, codes_par, kv_runs, kv_times,
                                    k3_shapes)
    for entry in kernels[2:5]:
        kname = entry["name"].split()[0]
        entry["moe_launches"] = moe_res["launches"][kname]
        entry["moe_serve_launches"] = moe_serve["launches"][kname]
        entry["moe_serve_path"] = moe_serve["kv"][kname]
        entry["ssm_launches"] = ssm_res["launches"][kname]
        entry["ssm_path"] = ssm_res["kv"][kname]
        entry["variants_launches"] = var["launches"][kname]
        entry["variants_path"] = var["kv"][kname]
        entry["tp_serve_launches"] = tps["launches"][kname]
        entry["tp_serve_path"] = tps["kv"][kname]
        entry["dp_serve_launches"] = dps["launches"][kname]
        entry["dp_serve_path"] = dps["kv"][kname]
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   moe_serve["kv"][kname]["err"],
                                   ssm_res["kv"][kname]["err"],
                                   var["kv"][kname]["err"],
                                   tps["kv"][kname]["err"],
                                   dps["kv"][kname]["err"])
    for entry in kernels[2:4]:
        kname = entry["name"].split()[0]
        entry["kv_monitor_launches"] = kvmon["launches"][kname]
        entry["ckpt_path"] = ck["path"][kname]
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   ck["path"][kname]["err"])
    kernels.append({
        "name": "K6 histogram256", "route": "cuda",
        "source": src + "histogram256.cu",
        "replaces": "src/repro/kernels/histogram256.py:31",
        "launches": tr["launches"]["K6"],
        "launches_by_run": [["train", tr["launches"]["K6"]]]
        + [[paging, n["K6"]] for paging, n in kv_runs],
        "max_abs_err": max(hist_par["err"], tr["path"]["err"]),
        "ms": hist_par["ms"], "kernel_ms": hist_par["kernel_ms"],
        "plain_ms": hist_par["plain_ms"],
        "bound_ms": hist_par["bound_ms"], "bound_by": "bytes",
        "library_ms": hist_par["library_ms"], "shape": hist_par["shape"],
        "train_path": {k: tr["path"][k] for k in ("shape", "ms",
                                                    "kernel_ms",
                                                    "library_ms",
                                                    "bound_ms")},
        "ckpt_path": ck["path"]["K6"],
        "launcher_resume_launches": resume["launches"]["K6"],
        "kv_monitor_launches": kvmon["launches"]["K6"],
        "adapt_launches": adapt["launches"]["K6"],
        "moe_launches": moe_res["launches"]["K6"],
        "moe_serve_launches": moe_serve["launches"]["K6"],
        "kv_path": kv_times["K6"], "moe_serve_path": moe_serve["kv"]["K6"],
        "ssm_launches": ssm_res["launches"]["K6"],
        "ssm_path": ssm_res["kv"]["K6"],
        "variants_launches": var["launches"]["K6"],
        "variants_path": var["kv"]["K6"],
        "tp_launches": tp["launches"]["K6"],
        "tp_moe_launches": tp["moe_launches"]["K6"],
        "tp_serve_launches": tps["launches"]["K6"],
        "tp_serve_path": tps["kv"]["K6"],
        "dp_serve_launches": dps["launches"]["K6"],
        "dp_serve_path": dps["kv"]["K6"]})
    kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                     ck["path"]["K6"]["err"],
                                     tps["kv"]["K6"]["err"],
                                     dps["kv"]["K6"]["err"],
                                     kv_times["K6"]["err"],
                                     moe_serve["kv"]["K6"]["err"],
                                     ssm_res["kv"]["K6"]["err"],
                                     var["kv"]["K6"]["err"])
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
