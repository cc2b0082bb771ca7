"""The measured half of the roofline: a step profiled on the card.

:func:`profile_step` runs a step once to warm it, once alone for its
wall time and peak memory, and twice under ``torch.profiler`` (CPU and
CUDA activities, ``with_flops``), recording the second. It splits the
device's work (kernels and copies, :func:`device_events`; PyTorch's
annotation ranges on the device are not work) into classes by kernel
name (GEMM, K1–K6, NCCL, other), with each class's launches, and sets
each beside its bound from the step's counted work (``op_count.OpRecord``,
the dry run of the same step): a GEMM class's bound is its counted
product FLOPs over each dtype's peak, a kernel's its ``kernel_bytes``
over HBM, NCCL's the collective bytes over NVLink. The idle share is
one less the device's busy time (the union of its work's intervals)
over the profiled step's wall time; a negative share means work was
counted twice and the caller should fail. The step's ``mfu`` is its
model FLOPs over the wall time at the bf16 peak, a measured share (the
dry run's counted one is ``RooflineTerms.roofline_fraction``). Every
number here needs a card; without one the profile raises.
"""
from __future__ import annotations

import re
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.roofline import hw
from repro_torch.roofline.op_count import OpRecord

#: The CUDA kernels behind K1–K6 (``kernels/csrc``), by function name.
KERNEL_NAMES = {
    "fused_encode_kernel": "K1",
    "fused_decode_kernel": "K2",
    "encode_kernel": "K3",
    "decode_kernel": "K4",
    "prefetch_decode_kernel": "K5",
    "histogram256_kernel": "K6",
}
CLASSES = ("GEMM", "K1", "K2", "K3", "K4", "K5", "K6", "NCCL", "other")
_GEMM = re.compile(r"gemm|xmma|nvjet|cutlass|cublas|matmul|splitk",
                   re.IGNORECASE)
#: the profiler's events that carry product FLOPs (``with_flops``)
PRODUCT_EVENTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


#: each K1-K6 function name, not preceded by another identifier character
#: (so ``decode_kernel`` does not match ``fused_decode_kernel``); a
#: mangled name puts its length's digits before it
_KERNEL_RE = [(re.compile(rf"(?:^|[^A-Za-z_]){n}"), k) for n, k in
              sorted(KERNEL_NAMES.items(), key=lambda nk: -len(nk[0]))]


def kernel_class(name: str) -> str:
    """The class of a device kernel by its name, demangled or not."""
    for pat, k in _KERNEL_RE:
        if pat.search(name):
            return k
    if "nccl" in name.lower():
        return "NCCL"
    if _GEMM.search(name):
        return "GEMM"
    return "other"


#: PyTorch's own ranges on the device, work of no kernel of their own
_RANGES = ("ProfilerStep", "nccl:", "record_param_comms")


def device_events(prof):
    """``[(class, name, start_us, end_us)]``: each kernel, copy and set
    the card ran, by class. PyTorch's annotation ranges on the device
    (``nccl:<collective>``, ``ProfilerStep#n``) are not counted; where
    a collective runs as a copy or a kernel not named for NCCL (one
    rank), the work inside its ``nccl:`` range on its stream is NCCL's."""
    from torch.autograd import DeviceType
    acts, colls = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False) \
                or e.name.startswith(_RANGES):
            if e.name.startswith("nccl:"):
                colls.append(e)
        else:
            acts.append(e)
    out = []
    for e in acts:
        t0, t1 = e.time_range.start, e.time_range.end
        inside = any(r.device_resource_id == e.device_resource_id
                     and r.time_range.start <= t0 and t1 <= r.time_range.end
                     for r in colls)
        out.append(("NCCL" if inside else kernel_class(e.name), e.name, t0,
                    t1))
    return out


def busy_us(events) -> float:
    """The device's busy time: the union of the events' intervals (work
    on two streams at once counts once)."""
    busy, end = 0.0, float("-inf")
    for _, _, t0, t1 in sorted(events, key=lambda e: e[2]):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy


def count_kernels(fn: Callable) -> dict:
    """``fn()`` timed once without the profiler (its wall time), then
    once under torch.profiler: the kernels and copies it ran on the
    device and the device's busy time; ``None`` counts when the
    profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    if not events:
        return {"launches": None, "busy_ms": None, "wall_ms": wall_ms}
    return {"launches": len(events), "busy_ms": busy_us(events) / 1e3,
            "wall_ms": wall_ms}


def launch_profile(cfg, params, dev, seq_len: int = 64, batch: int = 4
                   ) -> dict:
    """Kernel launches of one decode step (batch 4, every slot live) and
    of one training forward and backward at ``batch x seq_len`` (a
    recurrence is a Python loop over the sequence: launches grow with
    it), on the card through torch.profiler."""
    from repro_torch.models import (decode_step, init_decode_states,
                                    next_token_loss)
    from repro_torch.models.transformer import (leaf_grads, pytree_leaves,
                                                pytree_unflatten)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    pos = torch.full((batch, 1), 16, dtype=torch.int32, device=dev)
    st = init_decode_states(cfg, batch, 64, dev)
    decode_step(params, cfg, tok, st, pos)              # warm-up
    dec = count_kernels(lambda: decode_step(params, cfg, tok, st, pos))
    toks = torch.randint(0, cfg.vocab_size, (batch, seq_len + 1),
                         generator=torch.Generator(device=dev).manual_seed(5),
                         device=dev)

    def fwd_bwd():
        live = [p.detach().requires_grad_(True)
                for p in pytree_leaves(params)]
        loss = next_token_loss(pytree_unflatten(params, live), cfg,
                               toks[:, :-1], toks[:, 1:])
        leaf_grads(loss, live)

    fwd_bwd()                                           # warm-up
    train = count_kernels(fwd_bwd)
    return {"decode": dec, "train": train, "train_shape": [batch, seq_len]}


def bounds_ms(record: OpRecord) -> Dict[str, float]:
    """Each class's bound from the counted step: GEMM the product FLOPs
    over each dtype's peak, K1–K6 their bytes over HBM, NCCL the
    collective bytes over NVLink."""
    out = {"GEMM": sum(f / hw.peak_flops(d) for d, f in
                       record.flops_by_dtype.items()) * 1e3,
           "NCCL": record.coll_total / hw.NVLINK_BW * 1e3}
    for k, nb in record.kernel_bytes().items():
        out[k] = hw.hbm_ms(nb)
    return out


def profile_step(step: Callable, *, record: Optional[OpRecord] = None,
                 model_flops: Optional[float] = None) -> dict:
    """Profile one steady step on the card (see the module docstring):
    ``{"wall_ms", "busy_ms", "idle_share", "peak_bytes", "classes":
    {class: {"launches", "ms", "bound_ms"}}, "profiler_flops", "mfu"}``.
    ``record``: the step's counted work, for the bounds; ``model_flops``:
    for the mfu."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile, schedule
    step()                                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    # One step under the profiler's warm-up, then the recorded one: the
    # first kernels after tracing starts can be lost (one K2 of 224 was).
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True, with_flops=True,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
        prof.step()
    devents = device_events(prof)
    if not devents:
        raise RuntimeError("torch.profiler recorded no device kernels")
    classes = {c: {"launches": 0, "ms": 0.0, "top": []} for c in CLASSES}
    per_name: Dict[tuple, list] = {}
    for c, name, t0, t1 in devents:
        v = per_name.setdefault((c, name), [0, 0.0])
        v[0] += 1
        v[1] += (t1 - t0) / 1e3
    for (c, name), (n, ms) in sorted(per_name.items(),
                                     key=lambda kv: -kv[1][1]):
        cls = classes[c]
        cls["launches"] += n
        cls["ms"] += ms
        if len(cls["top"]) < 4:
            cls["top"].append([name[:96], n, ms])
    bounds = bounds_ms(record) if record is not None else {}
    for c, v in classes.items():
        v["bound_ms"] = bounds.get(c)
    busy = busy_us(devents) / 1e3
    products = {e.key: [e.count, float(getattr(e, "flops", 0) or 0)]
                for e in prof.key_averages() if e.key in PRODUCT_EVENTS}
    flops = sum(f for _, f in products.values())
    return {
        "wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
        "busy_ms": busy, "idle_share": 1 - busy / prof_wall_ms,
        "peak_bytes": peak, "classes": classes,
        "profiler_flops": float(flops), "products": products,
        "mfu": (model_flops / (wall_ms * 1e-3 * hw.PEAK_FLOPS_BF16)
                if model_flops else None),
    }
