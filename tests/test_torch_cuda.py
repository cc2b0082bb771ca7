"""The port's CUDA kernels against their plain PyTorch versions, bit for
bit, on the card. Imports no jax, so it also runs where only the port is
installed. Without a card every test skips.

On the H100, from the repo root (the suite's ``tests/conftest.py``
imports the JAX package, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import codec, lut, schemes
from repro_torch.kernels import ops, ref
from repro_torch.quant import e4m3


def _tables():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1 << 14) * 0.05).astype(np.float32)
    counts = np.bincount(e4m3.quantize_block32(torch.from_numpy(x))[0]
                         .numpy(), minlength=256).astype(np.float64) + 1
    return [lut.build_tables(counts, schemes.TABLE1),
            lut.build_tables(counts[::-1].copy(), schemes.TABLE2)]


def _x(rows: int, k: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, k)) * 2).astype(np.float32)
    x[0, :8] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-40, 480.0]
    x[1, :32] = 0.0
    return torch.from_numpy(x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_kernel_matches_plain(cuda, dtype):
    t1 = _tables()[0]
    x = _x(64, 1024, 8).to(cuda, getattr(torch, dtype))
    for cap in (codec.worst_case_words(1024), 20):
        got = ops.quantize_encode(x, t1, cap, emit_codes=True,
                                  emit_hist=True)
        want = ref.quantize_encode_ref(x, t1, cap, emit_codes=True,
                                       emit_hist=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["f32", "bf16", "accumulate"])
def test_k2_kernel_matches_plain(cuda, form):
    tl = _tables()
    k, rows = 1024, 40
    x = _x(rows, k, 6).to(cuda)
    cap = codec.worst_case_words(k)
    w1, _, s = ops.quantize_encode(x, tl[0], cap)
    w2, _, _ = ops.quantize_encode(x, tl[1], cap)
    sid = (torch.arange(rows, device=cuda) % 2).to(torch.int32)
    w = torch.where((sid == 1)[:, None], w2, w1)
    acc = torch.randn((rows, k), generator=torch.Generator().manual_seed(0)
                      ).to(cuda)
    if form == "accumulate":
        got = ops.decode_dequantize_accumulate(acc, w, s, tl, k,
                                               scheme_ids=sid)
        want = ref.decode_dequantize_ref(w, s, tl, sid, k, acc=acc)
    else:
        od = torch.float32 if form == "f32" else torch.bfloat16
        got = ops.decode_dequantize(w, s, tl, k, scheme_ids=sid,
                                    out_dtype=od)
        want = ref.decode_dequantize_ref(w, s, tl, sid, k, out_dtype=od)
    assert torch.equal(got, want)
