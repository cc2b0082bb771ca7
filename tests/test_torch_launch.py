"""The kernel wrappers refuse what their kernels cannot take before they
touch the card, so the refusals hold on the CPU, where nothing is built:
slots past K1's widest, chunk sizes that are no multiple of 32 (K1/K2)
or of 4 (K4/K5), prefixes whose codes pass 16 bits, and stacked window
tables or K5 slots past a CTA's shared memory. K4's and K5's window
table is built on the host, so it is held against the plain decode
here. The launch geometry itself is the C launchers' and is exercised on
the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from repro_torch.core import codec, lut, schemes
from repro_torch.kernels import ops, qlc_codes as qc, qlc_fused as qf
from repro_torch.kernels import ref
from tests.torch_dist import one_cpu_thread

one_cpu_thread()


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


def _codes(k=256, prefix_bits=3, cw=4, n_schemes=1, n=2):
    """K4's wrapper on CPU operands of the given geometry."""
    i32 = torch.int32
    return qc.decode(torch.zeros((n, cw), dtype=i32), None,
                     torch.zeros((n_schemes, 1 << (prefix_bits + 8)),
                                 dtype=torch.int16), k,
                     prefix_bits=prefix_bits, max_code_bits=0)


def _prefetch(cw, n_schemes=1, prefix_bits=3):
    return qc.prefetch_decode(
        torch.zeros((2, cw), dtype=torch.int32), None,
        torch.zeros((n_schemes, 1 << (prefix_bits + 8)), dtype=torch.int16),
        256, prefix_bits=prefix_bits, max_code_bits=0)


@pytest.mark.parametrize("k", [0, 6, -4, 34])
def test_k4_k5_refuse_chunk_size(k):
    with pytest.raises(ValueError, match="multiple of 4"):
        _codes(k=k)


@pytest.mark.parametrize("prefix_bits", [-1, 9, 12])
def test_k4_k5_refuse_codes_over_16_bits(prefix_bits):
    with pytest.raises(ValueError, match="at most 16 bits"):
        _codes(prefix_bits=prefix_bits)
    dec = np.zeros((1, 256), np.int32)
    area = np.zeros((1, 1 << max(prefix_bits, 0)), np.int32)
    with pytest.raises(ValueError, match="at most 16 bits"):
        qc.window_table(dec, area, area, prefix_bits)


def test_window_table_refuses_payloads_over_8_bits():
    sb = np.full((1, 8), 9, np.int32)
    with pytest.raises(ValueError, match="payload widths"):
        qc.window_table(np.zeros((1, 256), np.int32), sb, sb * 0, 3)


@pytest.mark.parametrize("prefix_bits", [3, 8])
def test_k4_refuses_tables_past_shared_memory(prefix_bits):
    """The most schemes whose tables fit pass the domain checks (and meet
    the device check); one more is refused."""
    most = (qc.CTA_SMEM - qc.decode_smem(0, prefix_bits)) >> (
        prefix_bits + 9)
    assert most == {3: 52, 8: 1}[prefix_bits]
    with pytest.raises(ValueError, match="CUDA tensor"):
        _codes(prefix_bits=prefix_bits, n_schemes=most)
    with pytest.raises(ValueError, match="shared memory"):
        _codes(prefix_bits=prefix_bits, n_schemes=most + 1)


@pytest.mark.parametrize("prefix_bits,cw,rows", [
    (3, 45, 32), (3, 353, 32), (3, 1409, 16), (3, 20000, 1), (8, 513, 16)])
def test_k5_takes_smaller_tiles_for_wide_slots(prefix_bits, cw, rows):
    """K5's two slots hold 32 chunks' words while they fit beside the
    tables (353 words: 1024 symbols at worst case), fewer for wider slots
    (1409 words: 4096 symbols) or a wider table (the 128 KiB of an 8-bit
    prefix beside 513-word slots)."""
    assert qc.prefetch_tile_rows(1, prefix_bits, cw) == rows
    with pytest.raises(ValueError, match="CUDA tensor"):
        _prefetch(cw, prefix_bits=prefix_bits)


@pytest.mark.parametrize("n_schemes,cw", [(1, 60000), (57, 45), (54, 2000)])
def test_k5_refuses_what_no_tile_fits(n_schemes, cw):
    """No tile, even of one chunk, fits beside these tables and slots."""
    assert qc.prefetch_tile_rows(n_schemes, 3, cw) == 0
    with pytest.raises(ValueError, match="shared memory"):
        _prefetch(cw, n_schemes=n_schemes)


def test_k4_k5_refuse_misshapen_operands():
    with pytest.raises(ValueError, match="CW >= 1"):
        _codes(cw=0)
    with pytest.raises(ValueError, match="window table"):
        qc.decode(torch.zeros((2, 4), dtype=torch.int32), None,
                  torch.zeros((1, 1024), dtype=torch.int16), 256,
                  prefix_bits=3, max_code_bits=0)
    with pytest.raises(ValueError, match="max_code_bits"):
        qc.decode(torch.zeros((2, 4), dtype=torch.int32), None,
                  torch.zeros((1, 2048), dtype=torch.int16), 256,
                  prefix_bits=3, max_code_bits=12)


def _u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32).astype(np.int64)


def _window_decode(words, tab, sid, prefix_bits, k):
    """The cursor over the window table, step for step as the reference
    reads its window (first word past the slot all ones, second clamped
    to the last)."""
    w = _u32(words)
    n, cw = w.shape
    imask = (1 << (prefix_bits + 8)) - 1
    e = tab.view(np.uint16).astype(np.int64)
    out = np.zeros((n, k), np.uint8)
    pos = np.zeros(n, np.int64)
    rows = np.arange(n)
    for i in range(k):
        widx, shift = pos >> 5, pos & 31
        w0 = np.where(widx < cw, w[rows, np.minimum(widx, cw - 1)],
                      0xFFFFFFFF)
        w1 = w[rows, np.minimum(widx + 1, cw - 1)]
        win = (w0 >> shift) | np.where(shift == 0, 0,
                                       (w1 << (32 - shift)) & 0xFFFFFFFF)
        ent = e[sid, win & imask]
        out[:, i] = ent >> 8
        pos += ent & 31
    return out


@pytest.mark.parametrize("prefix_bits", [3, 5, 8])
def test_window_table_decodes_like_the_plain_version(prefix_bits):
    """K4's and K5's table, read as the kernels read it, gives the plain
    decode's symbols on slots that fit, slots the chunks overrun and
    random words, with schemes stacked by chunk."""
    rng = np.random.default_rng(prefix_bits)
    k, n = 64, 48
    a = 1 << prefix_bits
    scheme = (schemes.TABLE1 if prefix_bits == 3 else schemes.QLCScheme(
        areas=((1, 0),) * (a - 1) + ((257 - a, 8),),
        prefix_bits=prefix_bits))
    sym = np.minimum(rng.geometric(0.1, (n, k)), 255).astype(np.uint8)
    tl = [lut.build_tables(np.bincount(sym.reshape(-1), minlength=256)
                           + 1.0, scheme),
          lut.build_tables(rng.integers(1, 100, 256).astype(np.float64),
                           scheme)]
    tab, longest = qc.window_table(*codec.stack_decode_tables(tl))
    assert tab.dtype == np.int16 and tab.shape == (2, 1 << (prefix_bits + 8))
    assert longest == max(t.max_code_length for t in tl)
    sid = rng.integers(0, 2, n)
    for cw in (codec.worst_case_words(k, prefix_bits + 8), 3, 1):
        words = torch.stack([ref.encode_ref(torch.from_numpy(sym), t, cw)[0]
                             for t in tl])[torch.from_numpy(sid),
                                           torch.arange(n)]
        words[::5] = torch.from_numpy(rng.integers(
            0, 1 << 32, (len(words[::5]), cw), dtype=np.uint64
        ).astype(np.uint32).view(np.int32))
        want = ref.decode_ref(words, tl, torch.from_numpy(sid), k).numpy()
        np.testing.assert_array_equal(
            _window_decode(words, tab, sid, prefix_bits, k), want)


def test_decode_tables_are_made_once_per_table_set(monkeypatch):
    """The entries look stacked tables up by ``CodecTables.digest``: a
    second call stacks and hashes nothing."""
    counts = np.arange(256, dtype=np.float64) + 1
    tl = [lut.build_tables(counts, schemes.TABLE1),
          lut.build_tables(counts[::-1].copy(), schemes.TABLE2)]
    dev = torch.device("cpu")
    first = ops._window_luts(tl, dev), ops._area_luts(tl, dev)

    def stack(*args):
        raise AssertionError("stacked again")
    monkeypatch.setattr(codec, "stack_decode_tables", stack)
    again = [lut.build_tables(counts, schemes.TABLE1), tl[1]]
    for same in (tl, again):
        assert ops._window_luts(same, dev) is first[0]
        assert ops._area_luts(same, dev) is first[1]


def test_host_scheme_ids_are_checked_device_ids_are_not_read():
    """Host ids out of range raise before upload; the slots come back as
    int32 on the words' device (None when no ids are given)."""
    dev = torch.device("cpu")
    assert ops._scheme_slots(2, 3, None, dev) is None
    got = ops._scheme_slots(2, 3, np.array([1, 0, 1]), dev)
    assert got.dtype == torch.int32 and got.tolist() == [1, 0, 1]
    for bad in ([0, 2, 1], [-1, 0, 0], torch.tensor([0, 5, 0])):
        with pytest.raises(ValueError, match="scheme ids must lie"):
            ops._scheme_slots(2, 3, bad, dev)
    with pytest.raises(ValueError, match="2 scheme ids for 3 chunks"):
        ops._scheme_slots(2, 3, [0, 1], dev)
