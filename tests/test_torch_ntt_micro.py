"""The port's ntt_micro variants at n = 64, B = 2 on the CPU.

On CPU tensors every variant's kernel call takes its plain version; both
are held here against the host's big-int arithmetic: Montgomery products
(a * b / 2^256 mod r), sums and differences of adjacent pairs, DIT
butterflies at half-size m on the JAX tool's twiddles 5^j, and the DIF
tail's stages on the domain's own roots of unity.
"""

import numpy as np
import pytest
import torch

from zerokit_tpu_torch.constants import FR_TWO_ADIC_ROOT, FR_TWO_ADICITY, MONT_R, R
from zerokit_tpu_torch.ff.field import decode_canonical_fast
from zerokit_tpu_torch.tools import ntt_micro as nm

torch.set_num_threads(1)

N, B = 64, 2
R_INV = pow(MONT_R, -1, R)


def ints(t: torch.Tensor) -> np.ndarray:
    """Limb tensor (16, *shape) -> object array of its integers (*shape)."""
    return np.array(decode_canonical_fast(t), dtype=object).reshape(t.shape[1:])


def mont(a, b):
    return a * b * R_INV % R


def host_results(x: np.ndarray) -> dict:
    """Each variant's output from the integers x (B, n), on the host."""
    mont5 = [pow(5, j, R) * MONT_R % R for j in range(N // 2)]
    out = {"mul_flat": np.array([mont(v, v) for v in x.reshape(-1)], dtype=object)}
    pairs = x.reshape(B, N // 2, 2)
    lo, hi = pairs[..., 0], pairs[..., 1]
    out["addsub"] = np.stack([(lo + hi) % R, (lo - hi) % R], axis=-1).reshape(B, N)
    h = min(64, N // 2)
    his = x.reshape(B, N // (2 * h), 2, h)[:, :, 1]
    out["mul5d"] = np.array([[[mont(v, mont5[j]) for j, v in enumerate(row)] for row in blk]
                             for blk in his], dtype=object)
    for m in (1, 8, N // 2):
        t = x.reshape(B, N // (2 * m), 2, m)
        lo, hi = t[:, :, 0], t[:, :, 1]
        wh = np.array([[[mont(hi[b, q, j], mont5[j]) for j in range(m)]
                        for q in range(N // (2 * m))] for b in range(B)], dtype=object)
        out[f"stage m={m}"] = np.stack([(lo + wh) % R, (lo - wh) % R], axis=2).reshape(B, N)
    g = pow(FR_TWO_ADIC_ROOT, 1 << (FR_TWO_ADICITY - (N.bit_length() - 1)), R)
    y = x.copy()
    m = N // 2
    while m >= 1:  # DIF: (lo + hi, (lo - hi) * w_m^j), w_m = g^(n / 2m)
        t = y.reshape(B, N // (2 * m), 2, m)
        lo, hi = t[:, :, 0], t[:, :, 1]
        w = np.array([pow(g, j * (N // (2 * m)), R) for j in range(m)], dtype=object)
        y = np.stack([(lo + hi) % R, (lo - hi) * w % R], axis=2).reshape(B, N)
        m //= 2
    out[f"tail P={N}"] = y
    return out


def test_variants_are_the_jax_tools_and_the_tail():
    x = nm.make_input(8192, 1, "cpu")
    names = [v.name for v in nm.variants(x)]
    assert names == ["mul_flat", "addsub", "mul5d", "stage m=1", "stage m=8", "stage m=64",
                     "stage m=512", "stage m=4096", "tail P=1024"]
    mul5d = nm.variants(nm.make_input(256, 1, "cpu"))[2]
    assert tuple(mul5d.inputs[1].shape) == (16, 64)


@pytest.fixture(scope="module")
def small():
    x = nm.make_input(N, B, "cpu")
    return x, host_results(ints(x))


@pytest.mark.parametrize("name", ["mul_flat", "addsub", "mul5d", "stage m=1", "stage m=8",
                                  "stage m=32", f"tail P={N}"])
def test_variant_matches_plain_and_host_integers(small, name):
    x, want = small
    (v,) = [v for v in nm.variants(x) if v.name == name]
    got = v.kernel(*v.inputs)
    assert torch.equal(got, v.plain(*v.inputs))
    assert (ints(got).reshape(want[name].shape) == want[name]).all()


def test_bounds_name_the_kernels():
    from zerokit_tpu_torch.runtime.profiling import ChipSpec, kernel_bound

    chip = ChipSpec()
    x = nm.make_input(8192, 64, "cpu")
    by_name = {v.name: v for v in nm.variants(x)}
    ms, res = nm.bound_of(by_name["addsub"], chip)
    assert res == "hbm" and ms == pytest.approx(2 * 16 * 8192 * 64 * 4 / chip.hbm_bytes_per_sec * 1e3)
    assert nm.bound_of(by_name["stage m=1"], chip)[0] == pytest.approx(
        kernel_bound("K4", chip, rows=64, n=8192, m=1)[0] * 1e3)
    assert by_name["tail P=1024"].bound == ("K5", {"rows": 64, "n": 8192, "p": 1024})
