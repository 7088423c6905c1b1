"""The port's Poseidon (host hash, P1's plain version, native wrappers) against the JAX package.

Seeded inputs go through the JAX function and its counterpart in the port;
field values compare as integers, exactly. P1 itself (csrc/poseidon.cu) runs
only on the card: chip_smoke.py holds it against poseidon_perm_plain there.
Here CPU tensors take the plain version, which is held against the JAX
package's batched permutation (a jitted lax.scan on XLA:CPU) at t = 2, 3, 4
and against the host hash at t = 9.
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


def test_kernel_table_is_the_montgomery_constants():
    """P1's constant table: (RF + RP) x t round constants, then t x t MDS,
    each the Montgomery form of params_for_t's value."""
    for t in (2, 3, 9):
        rf, rp, ark, mds = pos.params_for_t(t)
        words = pk._table(t, "cpu").numpy().view(np.uint32).reshape(-1, 8)
        assert words.shape[0] == (rf + rp) * t + t * t
        vals = [int.from_bytes(w.astype("<u4").tobytes(), "little") for w in words]
        assert vals == [FR.to_mont_int(v) for v in list(ark) + [x for row in mds for x in row]]


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
