"""The roofline of one cell from its counted work (``op_count``), on the
H100's peaks (``roofline.hw``).

Three terms per (arch x shape x mesh) cell, in seconds, for one rank:

  compute    = sum over dtypes of product FLOPs / that dtype's peak
  memory     = counted bytes / HBM bandwidth
  collective = collective bytes landing on the rank / NVLink (one way)

The reference divides every FLOP by one bf16 peak. The port holds f32
parameters and computes in bf16, and a product left in f32 runs at 67
TFLOP/s, not 989, so each dtype's FLOPs go over their own peak. The
counts come from an eager step on fake tensors (``launch.dryrun``), so
they are computed from shapes, not measured.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.roofline import hw
from repro_torch.roofline.op_count import OpRecord


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops: float            # 6·N(active)·tokens
    peak_memory_per_device: float = 0.0
    coll_breakdown: Optional[Dict[str, float]] = None
    flops_by_dtype: Optional[Dict[str, float]] = None

    @property
    def compute_s(self) -> float:
        by = self.flops_by_dtype or {"bfloat16": self.flops_per_device}
        return sum(f / hw.peak_flops(d) for d, f in by.items())

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / hw.HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / hw.NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs over every chip: remat and
        redundancy waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time at the bf16 peak / bound time: the score
        of a cell, from counts. Not the ``mfu`` of ``roofline.trace``,
        which divides by a measured wall time."""
        useful_s = (self.model_flops / self.chips) / hw.PEAK_FLOPS_BF16
        return useful_s / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, dominant=self.dominant,
                 useful_flops_fraction=self.useful_flops_fraction,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops_for(cfg, shape, n_tokens: Optional[int] = None) -> float:
    """6·N_active·D for training; 2·N_active·D for inference steps."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def from_counts(arch: str, shape, mesh_name: str, chips: int,
                record: OpRecord, cfg) -> RooflineTerms:
    """Terms of one rank's counted step (``op_count.count``)."""
    return RooflineTerms(
        arch=arch,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        flops_per_device=record.flops,
        bytes_per_device=record.bytes,
        coll_bytes_per_device=record.coll_total,
        model_flops=model_flops_for(cfg, shape),
        peak_memory_per_device=float(record.peak_bytes),
        coll_breakdown=dict(record.coll),
        flops_by_dtype=dict(record.flops_by_dtype),
    )
