"""The port's synthetic symbol streams (``repro_torch.core.distributions``)
against the reference's. The two draw with different generators, so they
agree in distribution: at n = 2^20 each stream's histogram lies within
total-variation distance 0.02 of the reference's, and the Table-1 QLC
compressibility of a codec built from each lies within 0.3 points.
About 12 s serial."""
import numpy as np
import pytest

from repro.core import distributions as jdist
from repro_torch.core import TABLE1, build_tables, distributions
from repro_torch.core.entropy import compressibility, normalize_counts
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

N = 1 << 20
TV = 0.02
POINTS = 0.3


def _pct(counts) -> float:
    """Compressibility, in percent, of the Table-1 QLC codec built from
    ``counts`` on the stream ``counts`` counts."""
    t = build_tables(counts, TABLE1)
    return 100 * compressibility(np.asarray(t.enc_len), normalize_counts(
        counts))


@pytest.mark.parametrize("stream", ["ffn1", "ffn2", "grad"])
def test_stream_matches_reference_in_distribution(stream):
    got = getattr(distributions, f"{stream}_counts")(N)
    want = getattr(jdist, f"{stream}_counts")(N)
    assert got.sum() == want.sum() == N
    tv = 0.5 * np.abs(got / N - want / N).sum()
    print(f"{stream}: total variation {tv:.5f}")
    assert tv < TV
    pg, pw = _pct(got), _pct(want)
    print(f"{stream}: Table-1 QLC {pg:.3f} % (reference {pw:.3f} %)")
    assert abs(pg - pw) < POINTS


def test_streams_are_seeded():
    a = distributions.grad_symbols(1 << 12, seed=5)
    assert np.array_equal(a, distributions.grad_symbols(1 << 12, seed=5))
    assert not np.array_equal(a, distributions.grad_symbols(1 << 12, seed=6))
    assert a.dtype == np.uint8 and a.shape == (1 << 12,)
