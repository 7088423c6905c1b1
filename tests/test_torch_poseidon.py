"""The port's Poseidon (host hash, P1's plain version, native wrappers) against the JAX package.

Seeded inputs go through the JAX function and its counterpart in the port;
field values compare as integers, exactly. P1 itself (csrc/poseidon.cu) runs
only on the card: chip_smoke.py holds it against poseidon_perm_plain there.
Here CPU tensors take the plain version, which is held against the JAX
package's batched permutation (a jitted lax.scan on XLA:CPU) at t = 2, 3, 4
and against the host hash at t = 9; P1's constant table is walked on Python
integers in the kernel's order, and its launch-shape rule run as the pure
function it is.
"""

import random

import numpy as np
import pytest
import torch

from zerokit_tpu.ff.field import FR as JFR
from zerokit_tpu.hash import poseidon as jpos
from zerokit_tpu.runtime import native as jnative
from zerokit_tpu_torch.constants import R
from zerokit_tpu_torch.ff.field import FR, from_numpy_limbs, to_numpy_limbs
from zerokit_tpu_torch.hash import poseidon as pos
from zerokit_tpu_torch.hash import poseidon_kernels as pk
from zerokit_tpu_torch.hash.grain import find_poseidon_ark_and_mds
from zerokit_tpu_torch.runtime import native

torch.set_num_threads(1)

# utils/tests/poseidon_hash_test.rs, as in tests/test_poseidon.py:24-39
ARITY1_VECTORS = {
    0: 19014214495641488759237505126948346942972912379615652741039992445865937985820,
    1: 18586133768512220936620570745912940619677854269274689475585506675881198879027,
    255: 20026131459732984724454933360292530547665726761019872861025481903072111625788,
    65535: 12358868638722666642632413418981275677998688723398440898957566982787708451243,
    2**64 - 1: 17449307747295017006142981453320720946812828330895590310359634430146721583189,
}
PAIR_VECTORS = [
    ((0, 1), 12583541437132735734108669866114103169564651237895298778035846191048104863326),
    ((2, 3), 17197790661637433027297685226742709599380837544520340689137581733613433332983),
    ((4, 5), 756592041685769348226045093946546956867261766023639881791475046640232555043),
    ((6, 7), 5558359459771725727593826278265342308584225092343962757289948761260561575479),
]
TREE_ROOT_8 = 11780650233517635876913804110234352847867393797952240856403268682492028497284


def edge_lanes() -> list:
    """Raw Montgomery limb values of P1's edge lanes (chip_smoke.py phase 10):
    0, 1, r - 1, the Montgomery images of r - 1 and of values near 2^253."""
    return [0, 1, R - 1, FR.to_mont_int(R - 1), FR.to_mont_int((1 << 253) + 1),
            FR.to_mont_int((1 << 253) - 3), (1 << 253) + 1, R - 2]


def mont_inputs(seed: int, t: int, lanes: int) -> list:
    """t - 1 (16, lanes) uint32 Montgomery limb arrays: edge lanes first,
    then seeded values < r."""
    rnd = random.Random(seed)
    cols = []
    for _ in range(t - 1):
        vals = (edge_lanes() + [rnd.randrange(R) for _ in range(lanes)])[:lanes]
        cols.append(np.asarray(FR.encode(vals, mont=False).numpy(), dtype=np.uint32))
    return cols


@pytest.fixture
def no_native(monkeypatch):
    """The port's pure-Python paths: its native library reads as absent."""
    monkeypatch.setattr(native, "_load", lambda: None)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_golden_vectors(use_native, monkeypatch):
    if not use_native:
        monkeypatch.setattr(native, "_load", lambda: None)
    for inp, expected in ARITY1_VECTORS.items():
        assert pos.poseidon_hash([inp]) == expected
    for (a, b), expected in PAIR_VECTORS:
        assert pos.poseidon_hash_pair(a, b) == expected
    h = [v for _, v in PAIR_VECTORS]
    top = pos.poseidon_hash_pair(pos.poseidon_hash_pair(h[0], h[1]),
                                 pos.poseidon_hash_pair(h[2], h[3]))
    assert top == TREE_ROOT_8


@pytest.mark.parametrize("t", range(2, 10))
def test_host_hash_equals_jax(t, no_native):
    rnd = random.Random(100 + t)
    for _ in range(3):
        inputs = [rnd.randrange(R) for _ in range(t - 1)]
        assert pos.poseidon_hash(inputs) == jpos.poseidon_hash(inputs)


@pytest.mark.parametrize("t", range(2, 10))
def test_params_for_t_equal_jax(t):
    assert pos.params_for_t(t) == jpos.params_for_t(t)
    rf, rp, ark, mds = pos.params_for_t(t)
    assert (rf, rp) == tuple(jpos.ROUND_PARAMS[t - 2][1:3])
    assert find_poseidon_ark_and_mds(pos.PRIME_BITS, t, rf, rp, 0) == (ark, mds)


def test_unsupported_arity():
    with pytest.raises(pos.PoseidonError):
        pos.poseidon_hash([])
    with pytest.raises(pos.PoseidonError):
        pos.poseidon_hash(list(range(9)))
    x = FR.encode([1, 2])
    with pytest.raises(pos.PoseidonError):
        pos.poseidon_hash_mont([x] * 9)
    with pytest.raises(pos.PoseidonError):
        pos.poseidon_hash_mont([])


# lanes a width: the shapes of tests/test_poseidon.py where it has one (t = 3
# at 16 lanes, t = 4 at 8), so XLA's persistent cache serves both files
JAX_LANES = {2: 16, 3: 16, 4: 8}


@pytest.mark.parametrize("t", [2, 3, 4])
def test_plain_permutation_equals_jax(t):
    cols = mont_inputs(t, t, JAX_LANES[t])
    want = np.asarray(jpos.poseidon_hash_mont(cols))
    got = pk.poseidon_perm_plain([from_numpy_limbs(c, "cpu") for c in cols])
    np.testing.assert_array_equal(to_numpy_limbs(got), want)


def test_plain_permutation_t9_equals_host_hash():
    cols = mont_inputs(9, 9, 4)
    got = JFR.decode(to_numpy_limbs(pk.poseidon_perm_plain([from_numpy_limbs(c, "cpu")
                                                             for c in cols])))
    ints = [JFR.decode(c) for c in cols]
    assert list(got) == [jpos.poseidon_hash([int(col[j]) for col in ints]) for j in range(4)]


def test_wrapper_on_cpu_takes_the_plain_version_and_checks_shapes():
    cols = [from_numpy_limbs(c, "cpu") for c in mont_inputs(3, 3, 8)]
    pk.reset_launches()
    out = pos.poseidon_hash_mont(cols)
    assert pk.launches["poseidon"] == 0
    assert torch.equal(out, pk.poseidon_perm_plain(cols))
    # (16, *batch) inputs keep their batch shape
    batched = pos.poseidon_hash_pair_mont(cols[0].reshape(16, 2, 4), cols[1].reshape(16, 2, 4))
    assert torch.equal(batched, out.reshape(16, 2, 4))
    with pytest.raises(pos.PoseidonError):
        pos.poseidon_hash_pair_mont(cols[0], cols[1][:, :4])
    with pytest.raises(ValueError):
        pk.poseidon_perm([cols[0][:8]])


@pytest.mark.parametrize("form", ["tree level", "expanded column"])
def test_strided_level_form_equals_copied_form(form):
    """Views read in place against their copies, and against the JAX
    package's pair hash of the copies: a tree level as its own lefts and
    rights (the form DeviceMerkleTree uses), and the rate commitment's
    H(id, limit) with the limit one column expanded to every lane (lane
    stride 0)."""
    if form == "tree level":
        level = from_numpy_limbs(mont_inputs(11, 2, 32)[0], "cpu")
        lefts, rights = level[:, 0::2], level[:, 1::2]
        assert lefts.stride(1) == 2 and rights.storage_offset() == 1
    else:
        lefts = from_numpy_limbs(mont_inputs(12, 2, 16)[0], "cpu")
        rights = FR.encode([100]).expand(16, 16)
        assert rights.stride(1) == 0
    strided = pk.poseidon_perm([lefts, rights])
    copied = pk.poseidon_perm([lefts.contiguous(), rights.contiguous()])
    assert torch.equal(strided, copied)
    want = np.asarray(jpos.poseidon_hash_pair_mont(to_numpy_limbs(lefts), to_numpy_limbs(rights)))
    np.testing.assert_array_equal(to_numpy_limbs(strided), want)


def _table_ints(t: int) -> list:
    words = pk._table(t, "cpu").numpy().view(np.uint32).reshape(-1, 8)
    return [int.from_bytes(w.astype("<u4").tobytes(), "little") for w in words]


def test_kernel_table_is_the_montgomery_constants():
    """P1's constant table: RF x t full-round constants, RP lane-0
    constants, M, B, then RP x (2t - 1) sparse entries, each the Montgomery
    form of sparse_form's value; M is params_for_t's MDS matrix, and the
    full rounds whose constants nothing folds into keep params_for_t's."""
    for t in (2, 3, 9):
        rf, rp, ark, mds = pos.params_for_t(t)
        form = pk.sparse_form(t)
        vals = _table_ints(t)
        assert len(vals) == rf * t + rp + 2 * t * t + rp * (2 * t - 1)
        assert vals == pk.table_values(t)
        mont = [FR.from_mont_int(v) for v in vals]
        full = [mont[r * t:(r + 1) * t] for r in range(rf)]
        m_at = rf * t + rp
        assert [mont[m_at + i * t:m_at + (i + 1) * t] for i in range(t)] == [list(r) for r in mds]
        assert full == form.full_ark and mont[rf * t:m_at] == form.part_ark
        half = rf // 2
        for r in [0] + list(range(2, half)) + list(range(half + 1, rf)):
            assert full[r] == list(ark[(r if r < half else r + rp) * t:][:t])


def test_kernel_layout_is_the_table_order():
    """The kernel's one layout helper (csrc/poseidon.cu `layout`, the
    offsets both kernels and the launch's shared-memory size read) puts
    each part where table_values puts it, 8 words a value."""
    import pathlib
    import re

    src = (pathlib.Path(pk.__file__).parent.parent / "csrc" / "poseidon.cu").read_text()
    body = re.search(r"constexpr Layout layout\(int t, int rf, int rp\) \{\s*return \{(.*?)\};",
                     src, re.S).group(1)
    fields = [f.strip() for f in body.split(",")]
    assert len(fields) == 6
    for t in range(2, 10):
        rf, rp, _, _ = pos.params_for_t(t)
        form = pk.sparse_form(t)
        got = [eval(f, {}, {"t": t, "rf": rf, "rp": rp}) for f in fields]
        sizes = [rf * t, len(form.part_ark), t * t, t * t,
                 sum(len(a) + len(b) for a, b in form.sparse)]
        want = [8 * sum(sizes[:k]) for k in range(6)]
        assert got == want and got[-1] == 8 * len(pk.table_values(t))


def walk_table(t: int, state: list, products: list) -> int:
    """P1's permutation on Python ints in the kernel's exact order, from
    the table's Montgomery words: state is [0, inputs...] in Montgomery
    form, each Montgomery product appends to `products`; returns state[0]
    in Montgomery form."""
    rf, rp = pk.sparse_form(t).rf, pk.sparse_form(t).rp
    vals, at = _table_ints(t), 0

    def take(k):
        nonlocal at
        at += k
        return vals[at - k:at]

    ark = [take(t) for _ in range(rf)]
    part = take(rp)
    mds, first = [take(t) for _ in range(t)], [take(t) for _ in range(t)]
    sparse = [(take(t), take(t - 1)) for _ in range(rp)]
    assert at == len(vals)
    rinv = pow(2 ** 256, -1, R)

    def mul(a, b):
        products.append(1)
        return a * b * rinv % R

    def pow5(x):
        x2 = mul(x, x)
        return mul(mul(x2, x2), x)

    def full(s, r, m, k0, rows):
        s = s[:k0] + [pow5((x + c) % R) for x, c in zip(s[k0:], ark[r][k0:])]
        return [sum(mul(m[i][j], s[j]) for j in range(k0, t)) % R for i in range(rows)]

    half, s = rf // 2, list(state)
    s = full(s, 0, mds, 1, t)
    for r in range(1, half):
        s = full(s, r, first if r == half - 1 else mds, 0, t)
    for k in range(rp):
        row0, col0 = sparse[k]
        acc = sum(mul(row0[j], s[j]) for j in range(1, t))
        x = pow5((s[0] + part[k]) % R)
        s = [(acc + mul(row0[0], x)) % R] + [(s[i] + mul(col0[i - 1], x)) % R
                                              for i in range(1, t)]
    for r in range(half, rf):
        s = full(s, r, mds, 0, 1 if r == rf - 1 else t)
    return s[0]


@pytest.mark.parametrize("t", range(2, 10))
def test_kernel_table_walk_is_the_hash(t, no_native):
    """The table P1 reads, walked in the kernel's order, gives the host
    poseidon_hash on the edge lanes (every input at the same edge value)
    and on seeded inputs, in exactly poseidon_mont_muls(t) products."""
    from zerokit_tpu_torch.runtime.profiling import poseidon_mont_muls

    rnd = random.Random(200 + t)
    lanes = [[v] * (t - 1) for v in edge_lanes()]
    lanes += [[rnd.randrange(R) for _ in range(t - 1)] for _ in range(2)]
    for mont in lanes:
        products = []
        got = walk_table(t, [0] + mont, products)
        assert len(products) == poseidon_mont_muls(t)
        want = pos.poseidon_hash([FR.from_mont_int(v) for v in mont])
        assert FR.from_mont_int(got) == want


def walk_group(t: int, state: list) -> tuple:
    """P1's group form (poseidon_group_kernel) on Python ints: group_of(t)
    threads, thread k holding state lane k (threads from t on shadow lane
    t - 1), a shuffle reading another thread's value. Returns (thread 0's
    state[0], the product steps a thread runs in turn)."""
    rf, rp = pk.sparse_form(t).rf, pk.sparse_form(t).rp
    g = pk.group_of(t)
    vals, at = _table_ints(t), 0

    def take(k):
        nonlocal at
        at += k
        return vals[at - k:at]

    ark, part = [take(t) for _ in range(rf)], take(rp)
    mds, first = [take(t) for _ in range(t)], [take(t) for _ in range(t)]
    sparse = [take(2 * t - 1) for _ in range(rp)]
    rinv = pow(2 ** 256, -1, R)
    steps = 0

    def mul(a, b):  # one product step on every thread
        nonlocal steps
        steps += 1
        return [x * y * rinv % R for x, y in zip(a, b)]

    def pow5(x):
        x2 = mul(x, x)
        return mul(mul(x2, x2), x)

    kk = [min(k, t - 1) for k in range(g)]
    s = [state[k] for k in kk]
    s[t:] = [0] * (g - t)

    def full(s, r, m, j0):
        x = pow5([(v + ark[r][kk[k]]) % R for k, v in enumerate(s)])
        acc = [0] * g
        for j in range(j0, t):
            prod = mul([m[kk[k]][j] for k in range(g)], [x[j]] * g)
            acc = [(a + p) % R for a, p in zip(acc, prod)]
        return acc

    s = full(s, 0, mds, 1)
    for r in range(1, rf):
        if r == rf // 2:
            for c, sp in zip(part, sparse):
                x = (s[0] + c) % R
                a = [x] + [sp[kk[k]] for k in range(1, g)]
                p = mul(a, [x] + s[1:])
                x5 = mul(mul(p, p), [x] * g)[0]  # thread 0 alone
                q = mul([sp[0]] + [sp[t + kk[k] - 1] for k in range(1, g)], [x5] * g)
                row = (q[0] + sum(p[1:t])) % R
                s = [row] + [(v + w) % R for v, w in zip(s[1:], q[1:])]
        s = full(s, r, first if r == rf // 2 - 1 else mds, 0)
    return s[0], steps


@pytest.mark.parametrize("t", range(2, 10))
def test_group_form_is_the_hash(t, no_native):
    """The group form gives the host poseidon_hash on edge and seeded
    inputs, its threads running RF (3 + t) - 1 + 4 RP product steps in turn
    (275 at t = 3, where one thread a hash runs 588)."""
    rnd = random.Random(300 + t)
    lanes = [[v] * (t - 1) for v in edge_lanes()[:4]]
    lanes += [[rnd.randrange(R) for _ in range(t - 1)]]
    rf, rp = pk.sparse_form(t).rf, pk.sparse_form(t).rp
    for mont in lanes:
        got, steps = walk_group(t, [0] + mont)
        assert steps == rf * (3 + t) - 1 + 4 * rp
        assert FR.from_mont_int(got) == pos.poseidon_hash([FR.from_mont_int(v) for v in mont])


SHAPE_LANES = [1, 2, 255, 256, 4096, 1 << 15, 1 << 19]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("t", [2, 3, 9])
def test_launch_shape_covers_every_lane_and_spreads_first(t, sms):
    """launch_shape over the sizes a tree's levels and the commitment calls
    give: every hash's threads in one warp and every thread of the call in
    one block's range exactly once, whole warps up to 8 a block; with
    blocks placed one an SM in turn, no SM holds more than 4 warps (one a
    scheduler) while another SM is idle; a hash takes group_of(t) threads
    exactly where that leaves every scheduler at most two warps."""
    for n in SHAPE_LANES:
        blocks, threads, g = pk.launch_shape(n, sms, t)
        assert g in (1, pk.group_of(t)) and pk.WARP % g == 0
        assert threads % pk.WARP == 0 and threads // pk.WARP in (1, 2, 4, 8)
        assert (blocks - 1) * threads < n * g <= blocks * threads
        assert (g > 1) == (-(-n * pk.group_of(t) // pk.WARP) <= 8 * sms)
        per_sm = [0] * sms
        for b in range(blocks):
            per_sm[b % sms] += threads // pk.WARP
        if max(per_sm) > 4:
            assert min(per_sm) > 0, (n, sms)


def test_launch_shape_at_the_tree_levels():
    """The depth-20 tree's levels (t = 3) on 132 SMs: a thread a hash in
    8-warp blocks from 2^16 hashes, 4 at 2^15, 2 at 2^14; 4 threads a hash
    from 2^13 down."""
    assert [pk.group_of(t) for t in range(2, 10)] == [2, 4, 4, 8, 8, 8, 8, 16]
    assert pk.launch_shape(1 << 19, 132, 3) == (2048, 256, 1)
    assert pk.launch_shape(1 << 16, 132, 3) == (256, 256, 1)
    assert pk.launch_shape(1 << 15, 132, 3) == (256, 128, 1)
    assert pk.launch_shape(1 << 14, 132, 3) == (256, 64, 1)
    assert pk.launch_shape(1 << 13, 132, 3) == (256, 128, 4)
    assert pk.launch_shape(1 << 12, 132, 3) == (256, 64, 4)
    assert pk.launch_shape(1 << 10, 132, 3) == (128, 32, 4)
    assert pk.launch_shape(1, 132, 3) == (1, 32, 4)
    assert pk.launch_shape(4096, 132, 9) == (128, 32, 1)
    assert pk.launch_shape(4096, 132, 8) == (256, 128, 8)
    assert pk.launch_shape(4096, 1, 3) == (16, 256, 1)


@pytest.mark.parametrize("fn", ["poseidon_hash_native", "poseidon_hash_pairs_native",
                                "merkle_compute_root_native"])
def test_restored_native_wrappers_equal_jax(fn):
    rnd = random.Random(7)
    v = [rnd.randrange(R) for _ in range(20)]
    args = {
        "poseidon_hash_native": [(v[:1],), (v[:2],), (v[:8],)],
        "poseidon_hash_pairs_native": [(v[:5], v[5:10])],
        "merkle_compute_root_native": [(v[0], v[1:11], [k & 1 for k in range(10)])],
    }[fn]
    for a in args:
        got = getattr(native, fn)(*a)
        assert got is not None and got == getattr(jnative, fn)(*a)
