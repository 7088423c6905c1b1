"""The benchmark's frozen arithmetic equals the program's runtime/profiling
today (the test may import the port; the harness does not)."""

import random

import pytest

from rlnbench import yardstick as Y
from zerokit_tpu_torch.runtime import profiling as P


def test_constants_equal_the_programs():
    assert Y.MONT_MUL_IMADS == P.MONT_MUL_IMADS
    assert Y.EC_OP_MONT_MULS == P.EC_OP_MONT_MULS
    assert (Y.N_WINDOWS, Y.C_BITS) == (P.N_MSM_WINDOWS, P.MSM_C_BITS)
    assert Y.IMAD_PER_CLK_PER_SM == P.ChipSpec().imad_per_clk_per_sm


@pytest.mark.parametrize("n", [1, 3845, 5797, 8192, 1 << 20])
def test_msm_work_equals_the_programs(n):
    assert Y.msm_bucket_mont_muls(n) == P.msm_bucket_mont_muls(n)
    imads, _ = P.kernel_work("MSM", n=n, lanes=3)
    assert 3 * Y.msm_bucket_mont_muls(n) * Y.MONT_MUL_IMADS == imads


def test_peak_equals_the_programs():
    spec = P.ChipSpec(sm_count=132, sm_clock_hz=1.98e9)
    assert Y.imad_peak_per_s(132, 1980.0) == pytest.approx(spec.derived_imad_per_sec, rel=1e-12)


def test_busy_share_equals_the_programs():
    rng = random.Random(7)
    for _ in range(50):
        iv = [(a, a + rng.uniform(0, 5)) for a in (rng.uniform(0, 100) for _ in range(30))]
        window = (rng.uniform(0, 40), rng.uniform(60, 120))
        assert Y.busy_share(iv, window) == pytest.approx(P.busy_share(iv, window), abs=1e-12)
        merged = Y.union(iv)
        assert sum(e - s for s, e in merged) == pytest.approx(
            P.busy_share(iv, (0, 200)) * 200, abs=1e-9)
        spans = Y.union([(window[0], window[0] + 10), (window[1] - 10, window[1])])
        want = sum(P.busy_share(iv, sp) * (sp[1] - sp[0]) for sp in spans)
        assert Y.covered(merged, spans) == pytest.approx(want, abs=1e-9)
