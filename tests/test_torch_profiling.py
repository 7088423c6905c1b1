"""The port's profiling module against the JAX package's, and its new parts.

The G1 add's product count (EC_ADD_MONT_MULS) must be the JAX package's;
kernel_work / kernel_bound are held against hand-computed shapes,
busy_share against synthetic intervals, and trace() / span() are rehearsed
on a CPU-only profile of a small witness map and MSM. The entry points
default to the card: on a host without one they raise unless the caller
names the CPU.
"""

import inspect
import os
import random

import numpy as np
import pytest
import torch

from zerokit_tpu_torch.groth16.setup import groth16_setup
from zerokit_tpu.runtime import profiling as jprof
from zerokit_tpu_torch.circuit.zkey import ConstraintMatrices
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.ff import field as tfield
from zerokit_tpu_torch.ff.field import FrField, encode_canonical_fast
from zerokit_tpu_torch.ff.fq2 import FqAdapter
from zerokit_tpu_torch.groth16 import msm as msm_mod
from zerokit_tpu_torch.groth16.msm import MSM
from zerokit_tpu_torch.groth16.prover import Groth16Prover
from zerokit_tpu_torch.groth16.qap import SparseMatrix, WitnessMapper
from zerokit_tpu_torch.hostmath import bn254
from zerokit_tpu_torch.runtime import profiling as prof

torch.set_num_threads(1)

# public x; witness w1, w2; constraints w1*w1 = w2, w2*w1 = x
MATRICES = ConstraintMatrices(
    num_instance_variables=2, num_witness_variables=2, num_constraints=2,
    a_num_non_zero=2, b_num_non_zero=2, c_num_non_zero=2,
    a=[[(1, 2)], [(1, 3)]], b=[[(1, 2)], [(1, 2)]], c=[[(1, 3)], [(1, 1)]],
)
H100 = prof.ChipSpec(sm_count=132, sm_clock_hz=1.98e9)


def test_cost_model_equals_jax():
    assert prof.EC_ADD_MONT_MULS == jprof.EC_ADD_MONT_MULS


def test_mont_mul_imads_counted_from_the_cios_loop():
    # per outer step: 8 a*b and 8 m*p 32x32->64 products (lo and hi) + m
    assert prof.MONT_MUL_IMADS == 8 * (8 * 2 + 1 + 8 * 2) == 264
    src = open(os.path.join(os.path.dirname(prof.__file__), "..", "csrc", "bn254.cuh")).read()

    def body(name):
        return src[src.index(f"void {name}("):src.index("\n}\n", src.index(f"void {name}("))]

    # a row i >= 1: the 8 products a_j * b_i, lo and hi halves, on PTX chains
    row = body("mad_row")
    assert row.count("mad.lo.cc.u32") + row.count("madc.lo.cc.u32") == 8
    assert row.count("madc.hi.cc.u32") + row.count("madc.hi.u32") == 8
    # its reduction: m = t0 * n0' and the 8 products m * p_j
    redc = body("redc_row")
    assert redc.count("mul.lo.u32 m,") == 1
    assert redc.count("mad.lo.cc.u32") + redc.count("madc.lo.cc.u32") == 8
    assert redc.count("madc.hi.cc.u32") + redc.count("madc.hi.u32") == 8
    # row 0's products a_j * b_0 in C, then 7 rows and 8 reductions
    mul = src[src.index("Elem<F> mul(const Elem<F>& a"):src.index("merge_row(ev, od);")]
    assert mul.count("* b.v[0]") == 2 and mul.count("__umulhi(") == 2  # in a 4-step loop
    assert mul.count("redc_row(") == 3 and mul.count("mad_row(") == 2  # in a 7-row loop


def test_kernel_work_hand_computed():
    assert prof.kernel_work("K1", lanes=131072) == (131072 * 264, 3 * 16 * 4 * 131072)
    # G1 add: p, q and out of 16*3 words each
    assert prof.kernel_work("K2", op="add", comps=1, lanes=1000) == (
        1000 * 12 * 264, 1000 * 3 * 48 * 4)
    # G2 mixed add with one sentinel lane: 39 products for each other lane
    assert prof.kernel_work("K2", op="add_mixed", comps=2, lanes=10, skipped=1) == (
        9 * 39 * 264, 10 * (96 + 64 + 96) * 4)
    # the Q_d add through indices: 2 empty lanes of 10; two int32 indices and
    # a flag byte a lane, 7 distinct rows read, 10 points written
    assert prof.kernel_work("K2", op="add_gather", comps=2, lanes=10, skipped=2,
                            rows_read=7) == (8 * 42 * 264, (7 + 10) * 96 * 4 + 10 * 9)
    # the fine scan: affine in (32 words), projective out (48) per lane-step
    assert prof.kernel_work("K3", kind="mixed", comps=1, k=32, lanes=100, skipped=32) == (
        (32 * 100 - 32) * 11 * 264, 32 * 100 * 80 * 4)
    # ... through an index: the index, the 700 table rows it reaches once
    # each, the prefixes written
    assert prof.kernel_work("K3", kind="mixed", comps=2, k=32, lanes=100, skipped=32,
                            table_rows=700) == (
        (32 * 100 - 32) * 39 * 264, (32 * 100 + 700 * 64 + 32 * 100 * 96) * 4)
    # the coarse scan: projective in and out (96 words each for G2); the
    # multiplies of the sequential scan's k*lanes adds, whatever the chunks
    assert prof.kernel_work("K3", kind="excl", comps=2, k=192, lanes=512) == (
        192 * 512 * 42 * 264, 192 * 512 * 192 * 4)
    assert prof.kernel_work("K4", rows=48, n=8192, m=4096) == (
        48 * 4096 * 264, (2 * 48 * 8192 + 4096) * 64)
    # a run of r stages: r products a butterfly, x in and out once, the one
    # top table (m = s * 2^(r-1)): the main path's run s = 1024, r = 3, and
    # the 2^20 fft's upper run s = 2^15, r = 5
    assert prof.kernel_work("K4", rows=48, n=8192, m=4096, r=3) == (
        3 * 48 * 4096 * 264, (2 * 48 * 8192 + 4096) * 64)
    assert prof.kernel_work("K4", rows=1, n=1 << 20, m=1 << 19, r=5) == (
        5 * (1 << 19) * 264, (2 * (1 << 20) + (1 << 19)) * 64)
    assert prof.kernel_work("K6", lanes=1 << 17) == ((1 << 17) * 128, 3 * 64 * (1 << 17) + 3072)
    # a squaring reads its one input once
    assert prof.kernel_work("K1", lanes=8, square=True) == (8 * 264, 2 * 64 * 8)
    # the G1 MSM of bench_components, a lane: each window's 1024 mixed adds
    # (11 products), 2 * 255 bucket-reduction adds (12) and 8 doublings (8),
    # then 31 adds joining the 32 windows; the scalars, the 32 windows'
    # affine rows and the projective results
    assert prof.kernel_work("MSM", n=1024, lanes=4) == (
        4 * (32 * (1024 * 11 + 510 * 12 + 8 * 8) + 31 * 12) * 264,
        (1024 * 4 + 32 * 1024 * 2 + 3 * 4) * 64)
    assert (prof.N_MSM_WINDOWS, prof.MSM_C_BITS) == (msm_mod.N_WINDOWS, msm_mod.C_BITS)
    # fft at n = 8: 12 butterflies, 7 of them by a twiddle of 1; ifft's
    # scale adds 8 products and its table
    assert prof.kernel_work("NTT", rows=2, n=8) == (2 * 5 * 264, (2 * 2 * 8 + 7) * 64)
    assert prof.kernel_work("NTT", rows=1, n=8, scale=True) == (13 * 264, (2 * 8 + 7 + 8) * 64)
    assert prof.tensor_ops("K6", lanes=4) == 4 * 2 * 32 * 96
    assert prof.tensor_ops("K1", lanes=4) == 0
    with pytest.raises(ValueError):
        prof.kernel_work("K7", lanes=1)


# K5's first radix-4 group skips its multiplies by 1: stage m = 1 at
# P = 512 (256 butterflies a chunk), m = 1, 2 at 1024 (512 + 256), m = 1 at
# 2048 (1024)
@pytest.mark.parametrize("p,skipped", [(512, 256), (1024, 768), (2048, 1024)])
def test_kernel_work_tail(p, skipped):
    stages = p.bit_length() - 1
    assert prof.tail_skipped(p) == skipped
    assert prof.kernel_work("K5", rows=48, n=8192, p=p, table=True) == (
        48 * (8192 // p) * (stages * p // 2 - skipped + p) * 264,
        (2 * 48 * 8192 + p + 8192) * 64)
    assert prof.kernel_work("K5", rows=48, n=8192, p=p)[0] == (
        48 * (8192 // p) * (stages * p // 2 - skipped) * 264)
    # the lift: 13 stages each way and the table, less both tails' skips
    assert prof.kernel_work("K4+K5", rows=48, n=8192, p=p) == (
        48 * (8192 * 13 + 8192 - 2 * (8192 // p) * skipped) * 264,
        (2 * 48 * 8192 + 3 * 8192) * 64)


def test_kernel_bound_hand_computed():
    assert H100.derived_imad_per_sec == pytest.approx(132 * 1.98e9 * 64)
    sec, res = prof.kernel_bound("K1", H100, lanes=131072)
    assert res == "hbm" and sec == pytest.approx(3 * 64 * 131072 / 3.35e12)
    sec, res = prof.kernel_bound("K3", H100, kind="mixed", comps=1, k=32, lanes=147456,
                                 skipped=32)
    assert res == "imad"
    assert sec == pytest.approx((32 * 147456 - 32) * 11 * 264 / (132 * 1.98e9 * 64))
    chip = prof.ChipSpec(sm_count=132, sm_clock_hz=1.98e9, measured_imad_per_sec=2e13)
    sec, res = prof.kernel_bound("K6", chip, lanes=1 << 20)
    assert chip.imad_per_sec == 2e13  # a measured rate above the derived one is the peak
    imads, nbytes = prof.kernel_work("K6", lanes=1 << 20)
    assert res == "hbm" and sec == pytest.approx(nbytes / 3.35e12) and imads / 2e13 < sec


def test_busy_share_synthetic_intervals():
    intervals = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12), (-3, -1)]
    assert prof.busy_share(intervals, (0, 10)) == pytest.approx(0.5)
    assert prof.busy_share([], (0, 10)) == 0.0
    assert prof.busy_share([(0, 10), (2, 3)], (0, 10)) == 1.0
    with pytest.raises(ValueError):
        prof.busy_share(intervals, (4, 4))


class _Ev:
    def __init__(self, name, device, start, end, annotation=False):
        self.name = name
        self.device_type = getattr(torch.autograd.DeviceType, device)
        self.is_user_annotation = annotation
        self.time_range = type("TR", (), {"start": start, "end": end})()


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_device_helpers_on_synthetic_events():
    events = [
        _Ev(prof.WINDOW, "CPU", 0, 100, annotation=True),
        _Ev("aten::sort", "CPU", 60, 70),
        _Ev("scan", "CUDA", 10, 30), _Ev("scan", "CUDA", 20, 40),
        _Ev("add", "CUDA", 80, 85),
        _Ev("msm.fine", "CUDA", 5, 45, annotation=True),  # a range on the GPU timeline
        _Ev("msm.fine", "CPU", 1, 9, annotation=True),
    ]
    p = _Prof(events)
    # device intervals 10-40 and 80-85 in the window 0-100; annotations left out
    assert prof.device_busy_share(p) == pytest.approx(0.35)
    assert prof.kernel_times(p) == [("scan", 40.0, 2), ("add", 5.0, 1)]
    assert prof.range_times(p) == {"msm.fine": pytest.approx(30.0)}
    assert prof.device_busy_share(_Prof(events[:2])) is None
    # without trace()'s window range the window is the first to the last event
    assert prof.device_busy_share(_Prof(events[1:5])) == pytest.approx(35 / 75)


def test_chipspec_from_device():
    if torch.cuda.is_available():
        chip = prof.ChipSpec.from_device()
        assert chip.sm_count > 0 and chip.sm_clock_hz > 0
    else:
        with pytest.raises(RuntimeError):
            prof.ChipSpec.from_device()


def _g1_points(n: int):
    step = bn254.G1.mul(bn254.G1_GENERATOR, 987654321)
    pts, acc = [], step
    for _ in range(n):
        pts.append(acc)
        acc = bn254.G1.add(acc, step)
    return pts


def test_entry_points_default_to_the_card():
    zkey = groth16_setup(MATRICES, random.Random(3))
    rows = [[(1, 2)], [(1, 3)]]
    entry_points = {
        "Groth16Prover": (Groth16Prover.__init__, lambda **kw: Groth16Prover(zkey, None, **kw)),
        "MSM": (MSM.__init__, lambda **kw: MSM(_g1_points(4), FqAdapter, **kw)),
        "SparseMatrix": (SparseMatrix.__init__, lambda **kw: SparseMatrix(rows, 4, **kw)),
        "WitnessMapper": (WitnessMapper.__init__, lambda **kw: WitnessMapper(MATRICES, **kw)),
        "from_numpy_limbs": (tfield.from_numpy_limbs,
                             lambda **kw: tfield.from_numpy_limbs(np.zeros((16, 2), np.uint32),
                                                                  **kw)),
    }
    for name, (fn, make) in entry_points.items():
        assert inspect.signature(fn).parameters["device"].default == "cuda", name
        if torch.cuda.is_available():
            made = make()
            dev = made.device if hasattr(made, "device") else made.perm.device
            assert dev.type == "cuda", name
        else:
            with pytest.raises(RuntimeError):
                make()
        made_cpu = make(device="cpu")
        dev = made_cpu.device if hasattr(made_cpu, "device") else made_cpu.perm.device
        assert dev.type == "cpu", name


def test_trace_and_spans_on_a_cpu_profile(tmp_path):
    assert not torch.autograd._profiler_enabled()
    assert type(prof.span("msm.sort")).__name__ == "nullcontext"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            with prof.trace(str(tmp_path)):
                pass
    rng = random.Random(5)
    ws = [rng.randrange(R) for _ in range(2)]
    assignment = FrField.to_mont(encode_canonical_fast(
        [v for row in ([1] * 2, [w * w * w % R for w in ws], ws, [w * w % R for w in ws])
         for v in row]).reshape(16, 4, 2))
    mapper = WitnessMapper(MATRICES, "cpu")
    msm = MSM(_g1_points(8), FqAdapter, "cpu", n_windows=2, c_bits=4)
    scalars = encode_canonical_fast([rng.randrange(1 << 8) for _ in range(16)]).reshape(16, 8, 2)
    msm.tables()
    with prof.trace(str(tmp_path), device="cpu") as p:
        mapper.witness_map(assignment)
        msm(scalars)
    names = {ev.name for ev in p.events()}
    assert {"qap.matvec", "qap.coset_lift", "msm.digits", "msm.sort", "msm.fine", "msm.coarse",
            "msm.qgather", "msm.sumq"} <= names
    assert "msm.gather" not in names  # the fine scan reads the table rows itself
    assert os.path.exists(p.trace_path) and os.path.dirname(p.trace_path) == str(tmp_path)
    share = prof.device_busy_share(p, "cpu")
    assert 0.0 < share <= 1.0
    kernels = prof.kernel_times(p, "cpu")
    assert kernels and all(us > 0 and count > 0 for _, us, count in kernels)
    ranges = prof.range_times(p, "cpu")
    assert set(ranges) >= {"msm.sort", "qap.matvec"} and all(us > 0 for us in ranges.values())


def _py_step(op, x, y):
    if op == "imad":
        return x * y & 0xFFFFFFFF
    if op == "imad_hi":
        return x * y >> 32
    if op == "add":
        return (x + y) & 0xFFFFFFFF
    return (x >> 7) ^ y


@pytest.mark.parametrize("op", ["imad", "imad_hi", "add", "shift_xor"])
def test_chain_plain_equals_python_words(op):
    from zerokit_tpu_torch.tools import microbench as mb

    a, b = mb.chain_inputs(op, 16, "cpu")
    got = mb.chain(op, a, b, 5)  # a CPU tensor: the wrapper takes the plain version
    assert torch.equal(got, mb.chain_plain(op, a, b, 5))
    for i in range(16):
        y, r = int(b[i]) & 0xFFFFFFFF, 0
        for k in range(mb.ACC):
            x = (int(a[i]) + k) & 0xFFFFFFFF
            for _ in range(5):
                x = _py_step(op, x, y)
            r ^= x
        assert int(got[i]) & 0xFFFFFFFF == r
    with pytest.raises(ValueError):
        mb.chain(op, a.to(torch.int64), b, 1)


def test_ffma_chain_plain_is_exact_at_the_timed_length():
    """With chain_inputs' ranges every x * y + 1 of a 256-step chain is
    exact in float64, so the plain version rounds once, as fma.rn does."""
    from fractions import Fraction

    from zerokit_tpu_torch.tools import microbench as mb

    a, b = mb.chain_inputs("ffma", 4, "cpu")
    got = mb.chain_plain("ffma", a, b, 256)
    for i in range(4):
        y = float(np.int32(b[i]).view(np.float32))
        assert 0.5 <= y < 1.0
        r = 0
        for k in range(mb.ACC):
            x = float(np.int32(int(a[i]) + k).view(np.float32))
            for _ in range(256):
                exact = Fraction(x) * Fraction(y) + 1
                assert Fraction(x * y + 1.0) == exact
                x = float(np.float32(x * y + 1.0))
                assert 1.0 <= x < 512.0
            r ^= int(np.float32(x).view(np.uint32))
        assert int(got[i]) & 0xFFFFFFFF == r


def test_launch_counters_cover_every_wrapper():
    from zerokit_tpu_torch.tools import microbench as mb

    prof.reset_launches()
    counts = prof.launch_counts()
    assert set(counts) == {"mont_mul", "ec_op", "ec_add_gather", "ec_scan_gather",
                           "ec_scan_excl", "ntt_cross", "ntt_tail", "witness_steps",
                           "witness_div", "poseidon", "mont_mul_tc", "chain", "latency",
                           "roundtrip"}
    assert all(v == 0 for v in counts.values())
    a, b = mb.chain_inputs("add", 4, "cpu")
    mb.chain("add", a, b, 1)  # the plain version on the CPU launches nothing
    x, y = mb.latency_inputs(2, "cpu")
    mb.latency(x, y, 2)
    mb.roundtrip("shared", torch.zeros((1, 2, 4, 8), dtype=torch.int32), 2)
    from zerokit_tpu_torch.hash import poseidon_kernels as pk

    pk.poseidon_perm([torch.zeros((16, 2), dtype=torch.int32)])
    assert all(v == 0 for v in prof.launch_counts().values())


# P1's work model: the least form of a t = 3 hash is 8 * (3 * 3 + 9) +
# 57 * (3 + 5) products less the first round's constant lane (3 + 3) and the
# last mix's rows 1..2 (6), the form P1 runs; its plain version runs the
# dense form, 8 * (3 * 3 + 9) + 57 * (3 + 9). t = 2 and t = 4 likewise with
# their RP (56)
@pytest.mark.parametrize("t,least,plain", [(2, 409, 472), (3, 588, 828), (4, 765, 1288),
                                           (9, 2040, 6156)])
def test_p1_products_per_hash(t, least, plain, monkeypatch):
    """The model's count is the least form's; the plain version makes the
    dense form's lane-products (its products are mont_mul_sos calls; one
    lane in, so each call's lanes are its products)."""
    from zerokit_tpu_torch.hash import poseidon_kernels as pk

    assert prof.poseidon_mont_muls(t) == least
    seen = []
    orig = tfield.mont_mul_sos

    def counting(spec, a, b):
        seen.append(a.numel() // 16)
        return orig(spec, a, b)

    monkeypatch.setattr(tfield, "mont_mul_sos", counting)
    pk.poseidon_perm_plain([torch.zeros((16, 1), dtype=torch.int32)] * (t - 1))
    assert sum(seen) == plain


def _least_form_hash(inputs, products, squares=None):
    """One Poseidon hash in the form poseidon_mont_muls counts, on Python
    ints, from the package's builder (hash/poseidon_kernels.sparse_form,
    the form P1's table holds); `products` gets one entry a product that
    depends on the inputs, `squares` (if given) one a squaring. Each partial round is lane 0's constant and
    x^5, then its sparse factor: row 0 dotted with the state, column 0
    times the new lane 0 added to lanes 1..; round 0's lane 0 (a constant)
    is folded into round 1's constants; the last round's mix is row 0."""
    from zerokit_tpu_torch.hash.poseidon_kernels import sparse_form

    t = len(inputs) + 1
    form = sparse_form(t)
    half = form.rf // 2

    def mul(x, y):
        products.append(1)
        return x * y % R

    def sqr(x):
        if squares is not None:
            squares.append(1)
        return mul(x, x)

    def pow5(x):
        return mul(sqr(sqr(x)), x)

    s = [0] + [v % R for v in inputs]
    for r in range(form.rf):
        if r == half:
            for c, (row0, col0) in zip(form.part_ark, form.sparse):
                x = pow5((s[0] + c) % R)
                s = ([(mul(row0[0], x) + sum(mul(row0[j], s[j]) for j in range(1, t))) % R]
                     + [(mul(col0[i - 1], x) + s[i]) % R for i in range(1, t)])
        k0 = 1 if r == 0 else 0
        s = s[:k0] + [pow5((x + c) % R) for x, c in zip(s[k0:], form.full_ark[r][k0:])]
        m = form.first if r == half - 1 else form.mds
        rows = range(1) if r == form.rf - 1 else range(t)
        s = [sum(mul(m[i][j], s[j]) for j in range(k0, t)) % R for i in rows]
    return s[0]


@pytest.mark.parametrize("t", [2, 3, 4, 9])
def test_p1_least_form_is_the_hash(t):
    """The form the model counts gives the hash, in poseidon_mont_muls(t)
    products."""
    from zerokit_tpu_torch.hash.poseidon import poseidon_hash

    rnd = random.Random(t)
    inputs = [rnd.randrange(R) for _ in range(t - 1)]
    products = []
    assert _least_form_hash(inputs, products) == poseidon_hash(inputs)
    assert len(products) == prof.poseidon_mont_muls(t)


def test_p1_work_and_bound_pin_the_prediction():
    """PERF.md's P1 bound: 125,192 IMADs a t = 3 hash, the least form's 588
    products with each mix row of two or more reduced once (bn254.cuh
    mul_sum) and x^5's squarings counted as squarings: 80 x^5's (24 in the
    full rounds but round 0's lane 0, 57 partial) of two squarings at
    36 * 2 + 136 and one product at 264, the partial rounds' 114 column-0
    products at 264, round 0's 3 rows of 2 at 2 * 128 + 136, and 76 rows of
    3 (18 in rounds 1-6, the last round's row 0, 57 partial rounds') at
    3 * 128 + 136. The leaf level of a depth-20 tree (2^19 pairs) 3.92 ms,
    IMAD-bound, its 100 MB 0.03 ms; the whole rebuild 7.85 ms, ~134 M
    hashes/s (16.727 Top/s, 3.35 TB/s)."""
    assert prof.ROW_PRODUCT_IMADS + prof.ROW_REDC_IMADS == prof.MONT_MUL_IMADS
    assert prof.SQR_IMADS == 8 * 9 // 2 * 2 + 136 == 208
    assert prof.poseidon_imads(3) == (160 * 208 + (80 + 114) * 264 + 3 * (2 * 128 + 136)
                                      + 76 * (3 * 128 + 136))
    assert prof.poseidon_imads(3) == 125192
    n = 1 << 19
    imads, nbytes = prof.kernel_work("P1", t=3, lanes=n)
    assert imads == n * 125192 and nbytes == n * 3 * 64
    sec, res = prof.kernel_bound("P1", H100, t=3, lanes=n)
    assert res == "imad" and round(sec * 1e3, 2) == 3.92
    assert round(nbytes / H100.hbm_bytes_per_sec * 1e3, 2) == 0.03
    rebuild = sum(prof.kernel_bound("P1", H100, t=3, lanes=1 << lv)[0] for lv in range(20))
    assert round(rebuild * 1e3, 2) == 7.85
    assert round(((1 << 20) - 1) / rebuild / 1e6) == 134
    assert prof.kernel_work("P1", t=2, lanes=10) == (10 * 90640, 10 * 2 * 64)


def test_w2_work_is_the_walks_tally():
    """W2's work a Div: the walk of the kernel's safegcd inverse
    (tests/test_torch_witness_div.py) tallies 22,265 integer operations,
    the same on every input, and the product by a adds one CIOS product."""
    from test_torch_witness_div import safegcd_inv

    for b in (0, 1, R - 1, (R + 1) // 2):
        tally = safegcd_inv(b)[3]
        assert sum(tally.values()) == prof.SAFEGCD_OPS == 22265
    assert prof.WITNESS_DIV_OPS == 22265 + prof.MONT_MUL_IMADS == 22529
    imads, nbytes = prof.kernel_work("W2", divs=6, lanes=16)
    assert imads == 6 * 16 * 22529 and nbytes == 6 * 12 + 6 * 16 * 96


@pytest.mark.parametrize("divs,bound_us", [(1, 0.0215), (6, 0.1293), (441, 9.5035)])
def test_w2_bound_pins_the_prediction(divs, bound_us):
    """PERF.md's W2 bounds at 16 lanes: the multi-message-id graph's groups
    of 1 and 6 Divs, the edge graph's 441 (phase 3b's direct batch too),
    each IMAD-bound (16.727 Top/s); Fermat's 382 products (100,848
    multiplies) charged 4.48x more a Div."""
    sec, res = prof.kernel_bound("W2", H100, divs=divs, lanes=16)
    assert res == "imad" and round(sec * 1e6, 4) == bound_us
    assert round(382 * prof.MONT_MUL_IMADS / prof.WITNESS_DIV_OPS, 2) == 4.48


@pytest.mark.parametrize("t", [2, 3, 4, 9])
def test_p1_squarings_are_the_x5s(t):
    """poseidon_imads charges two squarings an x^5, 2 (RF t - 1 + RP) a
    hash: the squarings the least form's walk makes. Its rows hold the
    walk's other products but x^5's last and the column-0 products."""
    from zerokit_tpu_torch.hash.poseidon import params_for_t

    rf, rp, _, _ = params_for_t(t)
    rnd = random.Random(100 + t)
    products, squares = [], []
    _least_form_hash([rnd.randrange(R) for _ in range(t - 1)], products, squares)
    assert len(squares) == 2 * (rf * t - 1 + rp)
    n_rows = t + (rf - 2) * t + 1 + rp
    row_products = t * (t - 1) + (n_rows - t) * t
    alone = len(squares) // 2 + rp * (t - 1)  # x^5's last product, column 0's
    assert len(products) == len(squares) + row_products + alone
    assert prof.poseidon_imads(t) == (alone * prof.MONT_MUL_IMADS
                                      + len(squares) * prof.SQR_IMADS
                                      + row_products * prof.ROW_PRODUCT_IMADS
                                      + n_rows * prof.ROW_REDC_IMADS)


@pytest.mark.parametrize("iters", [0, 1, 3, 64])
def test_latency_plain_is_the_chain_of_products(iters):
    from zerokit_tpu_torch.constants import R
    from zerokit_tpu_torch.tools import microbench as mb

    x, y = mb.latency_inputs(3, "cpu")
    got = mb.latency_plain(x, y, iters)
    for xv, yv, gv in zip(mb._ints(x), mb._ints(y), mb._ints(got)):
        assert xv < R and yv < R
        for _ in range(iters):  # one Montgomery product a step
            xv = xv * yv * pow(2 ** 256, -1, R) % R
        assert gv == xv


def test_roundtrip_plain_rotates_the_values():
    from zerokit_tpu_torch.tools import microbench as mb

    g = torch.arange(2 * 2 * 4 * 8, dtype=torch.int32).reshape(2, 2, 4, 8)
    got = mb.roundtrip_plain(g, 5)
    # after 5 rounds buffer 1 holds value j - 5 (mod 4) of buffer 0, first word + 5
    want = torch.roll(g[:, 0], 5, dims=1)
    want[:, :, 0] += 5
    assert torch.equal(got[:, 1], want)


def test_w1_chain_model():
    spec = prof.ChipSpec(sm_clock_hz=2e9)
    lat = {"roundtrip_shared_4warps": 130.0, "mul": 800.0}
    sec = prof.w1_chain_model(spec, lat, steps=10, var_steps=4, const_steps=3)
    # W1 multiplies by constants with the CIOS product too
    assert sec == (10 * 130 + 4 * 800 + 3 * 800) / 2e9


def test_random_batch_inputs_are_seeded_rln_inputs():
    from zerokit_tpu_torch.groth16.prover import random_batch_inputs

    named, rs, ss = random_batch_inputs(np.random.default_rng(20), 3, 4)
    again = random_batch_inputs(np.random.default_rng(20), 3, 4)
    assert (named, rs, ss) == again
    assert len(named["pathElements"]) == 4 and all(len(slot) == 3 for slot in named["pathElements"])
    assert named["userMessageLimit"] == [[100] * 3] and named["messageId"] == [[1] * 3]
    assert all(0 <= v < R for v in rs + ss)
    assert all(v in (0, 1) for slot in named["identityPathIndex"] for v in slot)


def test_l2_cold_fills_its_rotation_before_it_returns(monkeypatch):
    # 16 B of inputs against a 64 B rotation: 4 copies, each called once
    # (its output allocated) before the caller times anything
    monkeypatch.setattr(prof, "L2_ROTATION_BYTES", 64)
    calls = []
    x = torch.arange(4, dtype=torch.int32)
    cold = prof.l2_cold(lambda t: calls.append(t.data_ptr()) or t + 1, x)
    assert len(calls) == 4 and len(set(calls)) == 4 and x.data_ptr() not in calls
    assert torch.equal(cold(), x + 1)
    assert calls[4] == calls[0]  # the fifth call reads the first copy again
