"""The port's roofline (``repro_torch.roofline``) against the reference's
``repro.roofline``: ``model_flops_for`` on every assigned cell, the
three terms on the H100's peaks (a product in f32 at its own peak), and
``op_count.count``: products, a loop, a checkpointed block with its
recompute, one of each collective on a fake world of 4, the kernels'
bytes, and the refusal of a real tensor on the counted kernel path;
``roofline.trace``'s device events (kernels and copies, not PyTorch's
ranges). About 5 s serial."""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as j_get_config, shapes_for as j_shapes
from repro.roofline import analysis as j_analysis
from repro_torch.configs import ASSIGNED, get_config, shapes_for
from repro_torch.configs.base import DECODE_32K, PREFILL_32K, TRAIN_4K
from repro_torch.core import TABLE1, build_tables
from repro_torch.kernels import ops
from repro_torch.roofline import analysis, count, hw, kernel_bytes
from tests.torch_dist import one_cpu_thread

one_cpu_thread()


@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_for_matches_reference(arch):
    """6·N_active·D (train) and 2·N_active·D (prefill, decode) on every
    shape of the arch, equal to the reference's on its own config."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert [s.name for s in shapes_for(cfg)] == [s.name
                                                 for s in j_shapes(jcfg)]
    for s, js in zip(shapes_for(cfg), j_shapes(jcfg)):
        assert analysis.model_flops_for(cfg, s) == \
            j_analysis.model_flops_for(jcfg, js)


def _terms(**kw):
    cfg = get_config("phi3-mini-3.8b")
    base = dict(arch="phi3-mini-3.8b", shape="train_4k", mesh="m",
                chips=256, flops_per_device=hw.PEAK_FLOPS_BF16,
                bytes_per_device=hw.HBM_BW * 2,
                coll_bytes_per_device=hw.NVLINK_BW / 2,
                model_flops=6.0 * cfg.active_param_count() * 256 * 4096)
    base.update(kw)
    return analysis.RooflineTerms(**base)


class TestTerms:
    def test_term_math(self):
        """The reference's case on the H100: 1 s of compute, 2 s of HBM,
        0.5 s of NVLink."""
        t = _terms()
        assert t.compute_s == pytest.approx(1.0)
        assert t.memory_s == pytest.approx(2.0)
        assert t.collective_s == pytest.approx(0.5)
        assert t.dominant == "memory"
        assert 0 < t.roofline_fraction <= 1.5
        # ``mfu`` names only the measured share (``roofline.trace``)
        assert not hasattr(t, "mfu")

    def test_mixed_dtype_compute_term(self):
        """Each dtype's FLOPs over its own peak: a second of bf16 products
        and a second of f32 ones (67 TFLOP/s) are two seconds."""
        t = _terms(flops_per_device=hw.PEAK_FLOPS_BF16 + hw.PEAK_FLOPS_F32,
                   flops_by_dtype={"bfloat16": hw.PEAK_FLOPS_BF16,
                                   "float32": hw.PEAK_FLOPS_F32})
        assert t.compute_s == pytest.approx(2.0)
        assert t.dominant in ("compute", "memory")
        assert hw.peak_flops("float8_e4m3fn") == hw.PEAK_FLOPS_FP8

    def test_model_flops_kinds(self):
        cfg = get_config("mixtral-8x22b")
        f_train = analysis.model_flops_for(cfg, TRAIN_4K)
        f_prefill = analysis.model_flops_for(cfg, PREFILL_32K)
        f_decode = analysis.model_flops_for(cfg, DECODE_32K)
        assert f_train > f_prefill > f_decode
        assert f_train == 6.0 * cfg.active_param_count() * 256 * 4096

    def test_to_dict_has_the_reference_keys(self):
        j = j_analysis.RooflineTerms(
            arch="a", shape="s", mesh="m", chips=1, flops_per_device=1.0,
            bytes_per_device=1.0, coll_bytes_per_device=1.0,
            model_flops=1.0).to_dict()
        d = _terms().to_dict()
        assert set(j) <= set(d)
        assert "mfu" not in d


class TestOpCount:
    def test_product(self):
        with FakeTensorMode():
            a = torch.empty(64, 64, dtype=torch.bfloat16)
            b = torch.empty(64, 64, dtype=torch.bfloat16)
            with count() as r:
                a @ b
                a @ a                       # one input, read once
        assert r.flops_by_dtype == {"bfloat16": 2 * 2 * 64 ** 3}
        assert r.ops["aten.mm"]["bytes"] == (3 + 2) * 64 * 64 * 2

    def test_loop_counts_every_trip(self):
        """The reference's scan case: 12 products in a loop are 12."""
        with FakeTensorMode():
            a = torch.empty(64, 64)
            with count() as r:
                y = a
                for _ in range(12):
                    y = y @ a
        assert r.ops["aten.mm"]["calls"] == 12
        assert r.flops_by_dtype == {"float32": 12 * 2 * 64 ** 3}

    def test_checkpointed_block_counts_its_recompute(self):
        """Two products forward and three in the backward (both inputs of
        the second, the weight of the first); the recompute adds the
        first product, the one the backward's saved tensors need (the
        non-reentrant checkpoint stops recomputing there)."""
        def block(x, w):
            return torch.tanh(x @ w) @ w

        with FakeTensorMode():
            w = torch.empty(64, 64, requires_grad=True)
            x = torch.empty(64, 64)
            with count() as r:
                y = torch.utils.checkpoint.checkpoint(block, x, w,
                                                      use_reentrant=False)
                y.sum().backward()
            with count() as plain:
                block(x, w).sum().backward()
        assert plain.ops["aten.mm"]["calls"] == 5
        assert r.ops["aten.mm"]["calls"] == 6
        assert r.flops == 6 * 2 * 64 ** 3

    def test_peak_counts_live_storage(self):
        with FakeTensorMode():
            a = torch.empty(1024, dtype=torch.float32)
            with count(live=a) as r:
                b = a * 2
                del b
                c = a + 1
                d = c + 1
        assert r.arg_bytes == 4096
        assert r.peak_bytes == 3 * 4096
        del c, d


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=4,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collectives_on_a_fake_world(fake_world):
    """One of each collective over 4 ranks: its kind, one call, and the
    bytes of the result landing on the rank."""
    with FakeTensorMode():
        x = torch.empty(16, 8)                    # 512 B
        with count() as r:
            dist.all_reduce(x)
            dist.all_gather_into_tensor(torch.empty(64, 8), x)
            dist.reduce_scatter_tensor(torch.empty(4, 8), x)
            dist.all_to_all_single(torch.empty(16, 8), x)
            dist.broadcast(x, src=0)
    assert r.coll == {"all-reduce": 512, "all-gather": 2048,
                      "reduce-scatter": 128, "all-to-all": 512,
                      "broadcast": 512}
    assert r.coll_calls == {k: 1 for k in r.coll}
    assert r.coll_ranks == r.coll_calls
    assert r.coll_total == 512 + 2048 + 128 + 512 + 512


def _parity_tables():
    import numpy as np
    c = np.random.default_rng(0).integers(1, 1000, 256).astype(np.float64)
    return build_tables(c, TABLE1)


@dataclasses.dataclass
class _Shape:
    shape: tuple
    dtype: torch.dtype

    def numel(self):
        n = 1
        for s in self.shape:
            n *= s
        return n

    def stride(self):
        out, acc = [], 1
        for s in reversed(self.shape):
            out.append(acc)
            acc *= s
        return tuple(reversed(out))

    def element_size(self):
        return self.dtype.itemsize


def test_kernel_bytes_match_the_hand_counts():
    """Each entry's bytes as the card's parity and path checks counted
    them by hand before (inputs read once, outputs written once), and
    K1 at [4096, 1024], 353-word slots is 0.0069 ms of HBM."""
    t = _parity_tables()
    n, k, wc = 4096, 1024, 353
    x = _Shape((n, k), torch.float32)
    words, scales = _Shape((n, 89), torch.int32), _Shape((n, 32),
                                                         torch.float32)
    sid = _Shape((n,), torch.int32)
    k1 = kernel_bytes("quantize_encode", x, t, wc)
    assert k1 == n * k * 4 + n * wc * 4 + n * 4 + n * 32 * 4
    assert round(hw.hbm_ms(k1), 4) == 0.0069
    assert kernel_bytes("quantize_encode", x, t, wc, emit_codes=True,
                        emit_hist=True) == k1 + n * k + 256 * 4
    k2_in = n * 89 * 4 + n * 32 * 4 + n * 4
    for dt, out_b in ((torch.float32, 4), (torch.bfloat16, 2)):
        assert kernel_bytes("decode_dequantize", words, scales, [t], k,
                            scheme_ids=sid, out_dtype=dt) == \
            k2_in + n * k * out_b
    assert kernel_bytes("decode_dequantize_accumulate", x, words, scales,
                        [t], k, scheme_ids=sid) == k2_in + n * k * 8
    # bf16 scales: K2 reads them as f32, as its entry casts them
    assert kernel_bytes("decode_dequantize", words,
                        _Shape((n, 32), torch.bfloat16), t, k) == \
        k2_in + n * k * 4
    sym, cap = _Shape((n, 256), torch.uint8), 89
    assert kernel_bytes("encode", sym, t, cap) == \
        n * 256 + n * cap * 4 + n * 4
    for entry in ("decode", "decode_block_async"):
        assert kernel_bytes(entry, words, [t], 256, scheme_ids=sid) == \
            n * 89 * 4 + n * 4 + n * 256
    assert kernel_bytes("histogram", _Shape((n, k), torch.uint8)) == \
        n * k + 256 * 4


def test_counted_kernels_are_one_op_each_and_refuse_real_tensors():
    t = _parity_tables()
    with FakeTensorMode():
        x = torch.empty(64, 1024)
        with count() as r:
            words, nbits, scales, codes = ops.quantize_encode(
                x, t, 353, emit_codes=True)
            vals = ops.decode_dequantize(words, scales, t, 1024)
            ops.histogram(codes)
    assert (tuple(words.shape), words.dtype) == ((64, 353), torch.int32)
    assert (tuple(vals.shape), vals.dtype) == ((64, 1024), torch.float32)
    assert r.kernel_calls() == {"K1": 1, "K2": 1, "K3": 0, "K4": 0,
                                "K5": 0, "K6": 1}
    assert set(r.ops) == {"kernels.ops.quantize_encode",
                          "kernels.ops.decode_dequantize",
                          "kernels.ops.histogram"}
    assert r.kernel_bytes()["K1"] == kernel_bytes(
        "quantize_encode", x, t, 353, emit_codes=True)
    with pytest.raises(RuntimeError, match="real cpu tensor"):
        with count():
            ops.histogram(torch.zeros(8, dtype=torch.uint8))


class _Prof:
    """A profile's events as ``roofline.trace`` reads them."""

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _event(name, t0, t1, stream=7, device=True, annotation=False):
    import types
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation, device_resource_id=stream,
        time_range=types.SimpleNamespace(start=t0, end=t1))


def test_device_events_count_work_not_ranges():
    """Kernels and copies count, PyTorch's ranges on the device do not; a
    copy inside a ``nccl:`` range on its stream (a collective on one
    rank) is NCCL's, one beside it on another stream is not; the busy
    time is the union of the intervals."""
    from repro_torch.roofline import trace
    prof = _Prof([
        _event("ProfilerStep#2", 0, 100, annotation=True),
        _event("nccl:all_to_all", 10, 20, annotation=True),
        _event("Memcpy DtoD (Device -> Device)", 11, 19),
        _event("Memcpy DtoD (Device -> Device)", 12, 18, stream=9),
        _event("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage"
               "<4096ul>)", 30, 40),
        _event("void (anonymous namespace)::fused_decode_kernel<0>(unsigned"
               " int const*, long)", 35, 50),
        _event("nvjet_tst_192x128_64x5_1x2_h_bz_coopB_NNT", 60, 70),
        _event("aten::mm", 0, 90, device=False),
    ])
    ev = trace.device_events(prof)
    assert [c for c, *_ in ev] == ["NCCL", "other", "NCCL", "K2", "GEMM"]
    assert trace.busy_us(ev) == (19 - 11) + (50 - 30) + (70 - 60)
