"""The K1/K2 wrappers refuse what their kernels cannot take before they
touch the card, so the refusals hold on the CPU, where nothing is built:
slots past K1's widest, chunk sizes that are no multiple of 32, and
prefixes whose codes pass 16 bits. The launch geometry itself is the C
launchers' and is exercised on the card (tests/test_torch_cuda.py)."""
import pytest
import torch

from repro_torch.kernels import qlc_fused as qf


def _encode(x, cap):
    lut = torch.zeros(256, dtype=torch.int32)
    return qf.fused_encode(x, lut, lut, cap)


def _decode(k, prefix_bits, cw=4):
    a = 1 << max(prefix_bits, 0)
    i32 = torch.int32
    return qf.fused_decode(
        torch.zeros((2, cw), dtype=i32), torch.ones((2, max(k, 32) // 32)),
        torch.zeros(2, dtype=i32), torch.zeros((1, 256), dtype=i32),
        torch.zeros((1, a), dtype=i32), torch.zeros((1, a), dtype=i32),
        torch.ones(256), k, prefix_bits=prefix_bits)


def test_widest_k1_slot_is_the_first_designs():
    # 48 KiB of shared memory less 4 KiB of tables, in words.
    assert qf.ENCODE_MAX_CAP == 11264
    assert qf.MAX_CODE_BITS == 16


@pytest.mark.parametrize("cap", [0, qf.ENCODE_MAX_CAP + 1])
def test_k1_refuses_slot(cap):
    with pytest.raises(ValueError, match="capacity_words"):
        _encode(torch.zeros((2, 64)), cap)


@pytest.mark.parametrize("shape", [(2, 48), (2, 0), (64,)])
def test_k1_refuses_chunk_shape(shape):
    with pytest.raises(ValueError, match="multiple of 32"):
        _encode(torch.zeros(shape), 4)


@pytest.mark.parametrize("k", [0, 48, -32])
def test_k2_refuses_chunk_size(k):
    with pytest.raises(ValueError, match="multiple of 32"):
        _decode(k, 3)


@pytest.mark.parametrize("prefix_bits", [-1, 9, 12])
def test_k2_refuses_codes_over_16_bits(prefix_bits):
    with pytest.raises(ValueError, match="at most 16 bits"):
        _decode(64, prefix_bits)


@pytest.mark.parametrize("call", [lambda: _encode(torch.zeros((2, 64)), 4),
                                  lambda: _decode(64, 3)])
def test_wrappers_take_cuda_tensors_only(call):
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
