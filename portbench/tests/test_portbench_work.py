"""The work counts (portbench/work) against the algorithm's formulas,
and the roofline arithmetic over them."""

import pytest

import pb_support  # noqa: F401  (paths)
from harness import cells, readers

M = {2: 7, 32: 1057}


@pytest.mark.parametrize('n,d,k,c', [(10_000_000, 2, 50, 8),
                                     (1_000_000, 32, 256, 1)])
def test_b1_counts_two_passes(n, d, k, c):
    macs, nbytes = cells.work_count('b1').count(dict(n=n, d=d, k=k,
                                                      chains=c))
    assert macs == 2 * c * n * k * M[d]
    assert nbytes == 4 * (n * d + 2 * c * k * M[d] + c)


def test_b2_counts_one_pass_and_labels():
    macs, nbytes = cells.work_count('b2').count(
        dict(n=10_000_000, d=2, k=50, chains=8))
    assert macs == 8 * 10_000_000 * 50 * 7
    assert nbytes == 4 * (10_000_000 * 2 + 2 * 8 * 50 * 7 + 8 * 10_000_000)


def test_b3_counts_a_request():
    macs, nbytes = cells.work_count('b3').count(dict(n=1_000_000, d=32,
                                                      k=256))
    assert macs == 1_000_000 * 256 * 1057
    assert nbytes == 4 * (1_000_000 * 32 + 256 * 1057 + 1_000_000)


class Ctx:
    def __init__(self, macs, nbytes, kernel_s):
        self.peaks = cells.peaks()
        self.kind, self.traffic = 'fit', {'kernel': 'b1'}
        self._w, self.trace = (macs, nbytes), self

    def work(self):
        return self._w + (cells.work_count('b1'),)

    def kernel_s(self, _pattern):
        return self.kernel_time


def test_roofline_is_bound_over_time():
    peaks = cells.peaks()
    assert peaks['tf32_flop_per_s'] == 495e12
    assert peaks['hbm_byte_per_s'] == 3.35e12
    macs, nbytes = cells.work_count('b1').count(
        dict(n=10_000_000, d=2, k=50, chains=8))
    ctx = Ctx(macs, nbytes, None)
    bound = readers.bound_s(ctx, macs, nbytes)
    assert bound == pytest.approx(2 * macs / 495e12)      # TF32-bound
    ctx.kernel_time = bound
    assert readers.roofline(ctx, 'b1') == pytest.approx(100.0)
    ctx.kernel_time = 10.885e-3
    assert readers.roofline(ctx, 'b1') == pytest.approx(
        100 * 0.22626e-3 / 10.885e-3, rel=1e-3)
    assert readers.roofline(ctx, 'b2') is None


def test_kernel_patterns_pick_their_kernels():
    import re
    names = {'void estep_tc<2>(float const*)': 'b1',
             'void estep_st_logits<true>(float const*)': 'b1',
             'void gibbs_tc<3>(float const*)': 'b2',
             'void predict_kernel<0, 32>(float const*)': 'b3',
             'void predict_wide_kernel<0, 32>(float const*)': 'b3',
             'void diag_predict_kernel<2>(float const*)': None,
             'void ilr_predict_kernel<1>(float const*)': None}
    for name, owner in names.items():
        found = [k for k in ('b1', 'b2', 'b3')
                 if re.search(cells.work_count(k).KERNELS, name)]
        assert found == ([owner] if owner else []), name
