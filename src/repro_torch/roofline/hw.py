"""Target-hardware constants: one NVIDIA H100 SXM, for the roofline.

The port's counterpart of the reference's TPU constants. Every rate is
NVIDIA's published figure for the SXM part at its full power limit of
700 W (NVIDIA H100 Tensor Core GPU data sheet), dense, without
sparsity; a card set below 700 W (``nvidia-smi --query-gpu=power.limit``)
runs slower under load, so a share against these peaks names the card's
limit beside it.
"""
from __future__ import annotations

#: Tensor-core peaks by operand dtype (data sheet, dense): bf16 and fp16
#: 989.4 TFLOP/s, fp8 1,979 TFLOP/s, TF32 494.7 TFLOP/s.
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_FP16 = 989e12
PEAK_FLOPS_FP8 = 1979e12
PEAK_FLOPS_TF32 = 495e12
#: float32 outside the tensor cores (data sheet: 67 TFLOP/s). The port
#: turns TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``), so
#: an f32 product runs at this rate.
PEAK_FLOPS_F32 = 67e12
#: float64 outside the tensor cores (data sheet: 34 TFLOP/s).
PEAK_FLOPS_F64 = 34e12

#: HBM3: 3.35 TB/s and 80 GB (data sheet).
HBM_BW = 3.35e12
HBM_BYTES = 80e9

#: NVLink 4: 900 GB/s per GPU in both directions together, 450 GB/s
#: each way (data sheet). A collective's bytes landing on a rank arrive
#: at this rate at best.
NVLINK_BW = 450e9

#: On-chip memory (Hopper tuning guide): 50 MB of L2, 228 KiB of shared
#: memory per SM, 132 SMs on the SXM part.
L2_BYTES = 50e6
SMEM_PER_SM = 228 * 1024
NUM_SMS = 132

#: Between nodes: one 400 Gb/s NIC per GPU (the DGX H100 layout), 50e9
#: B/s. Nothing reads these until multi-node (ROADMAP queue 1, item 13).
INTER_NODE_BW = 50e9
NIC_BITS_PER_S = 400e9

#: Peak FLOP/s of a product by the dtype of its operands (torch's name).
#: A dtype not listed counts at the f32 rate.
PEAK_FLOPS_BY_DTYPE = {
    "bfloat16": PEAK_FLOPS_BF16,
    "float16": PEAK_FLOPS_FP16,
    "float8_e4m3fn": PEAK_FLOPS_FP8,
    "float8_e5m2": PEAK_FLOPS_FP8,
    "float32": PEAK_FLOPS_F32,
    "float64": PEAK_FLOPS_F64,
}


def peak_flops(dtype: str) -> float:
    """Peak FLOP/s of a product whose operands are ``dtype``."""
    return PEAK_FLOPS_BY_DTYPE.get(str(dtype).replace("torch.", ""),
                                   PEAK_FLOPS_F32)


def hbm_ms(nbytes: float) -> float:
    """The least time to move ``nbytes`` through HBM, in ms."""
    return nbytes / HBM_BW * 1e3
