"""Groth16 verifier (host-side pairing check).

Mirrors ark-groth16 `verify_proof` as used by the reference
(rln/src/protocol/proof.rs:856-894, rln/src/protocol/zk.rs:101-128):

    e(A, B) == e(alpha, beta) * e(sum_i pub_i * gamma_abc_i, gamma) * e(C, delta)

Verification is not on the TPU hot path (proving is); like the reference,
which verifies on CPU through arkworks, we verify with the host pairing.
The prepared key caches the public-input bases (analog of
ark `prepare_verifying_key`, cached by ArkGroth16Backend —
rln/src/circuit/mod.rs:314-320).
"""

from __future__ import annotations

from typing import List, Sequence

from ..circuit.zkey import VerifyingKey
from ..hostmath import bn254


class PreparedVerifyingKey:
    def __init__(self, vk: VerifyingKey):
        self.vk = vk
        # e(alpha, beta) Miller value could be cached; with a shared final
        # exponentiation the win is small, so keep it simple and explicit.

    def num_public_inputs(self) -> int:
        return len(self.vk.gamma_abc_g1) - 1


def prepare_verifying_key(vk: VerifyingKey) -> PreparedVerifyingKey:
    return PreparedVerifyingKey(vk)


def proof_points_valid(proof) -> bool:
    """Validation of UNTRUSTED proof points before any pairing math — the
    analog of ark CanonicalDeserialize's checked deserialization (the
    reference gets this for free when decoding proof bytes): canonical
    coordinate range, on-curve, and r-torsion subgroup membership for the
    G2 element (proof malleability / undefined pairing semantics otherwise).
    Native check (~60 us) when the library is built; Python fallback."""
    from ..runtime import native

    a, b, c = proof
    got_a = native.g1_is_valid_native(a)
    got_c = native.g1_is_valid_native(c)
    got_b = native.g2_is_valid_native(b)
    if got_a is not None and got_b is not None and got_c is not None:
        return got_a and got_b and got_c
    for p in (a, c):
        if p is not None and not (
            0 <= p[0] < bn254.Q and 0 <= p[1] < bn254.Q and bn254.G1.is_on_curve(p)
        ):
            return False
    if b is not None:
        if not all(0 <= v < bn254.Q for xy in b for v in xy):
            return False
        if not bn254.G2.is_on_curve(b):
            return False
        # subgroup: [r]Q == inf (raw ladder — Group.mul reduces k mod r,
        # which would make this check vacuous)
        acc, base, k = None, b, bn254.R
        while k:
            if k & 1:
                acc = bn254.G2.add(acc, base)
            base = bn254.G2.double(base)
            k >>= 1
        if acc is not None:
            return False
    return True


def verify_proof(pvk: PreparedVerifyingKey, proof, public_inputs: Sequence[int]) -> bool:
    """proof = (a: G1, b: G2, c: G1) affine tuples; public_inputs: Fr ints.

    Uses the native tower pairing (native/pairing.cpp, ~2-3 ms) when the
    library is built; falls back to the pure-Python oracle (~170 ms)."""
    vk = pvk.vk
    if len(public_inputs) != len(vk.gamma_abc_g1) - 1:
        raise ValueError(
            f"expected {len(vk.gamma_abc_g1) - 1} public inputs, got {len(public_inputs)}"
        )
    if not proof_points_valid(proof):
        return False
    a, b, c = proof
    from ..runtime import native

    if native.pairing_available():
        acc = native.g1_msm_native(
            vk.gamma_abc_g1, [1] + [s % bn254.R for s in public_inputs]
        )
        pairs = [
            (bn254.G1.neg(a), b),
            (vk.alpha_g1, vk.beta_g2),
            (acc, vk.gamma_g2),
            (c, vk.delta_g2),
        ]
        return native.multi_pairing_is_one_native(pairs)
    acc = vk.gamma_abc_g1[0]
    for s, base in zip(public_inputs, vk.gamma_abc_g1[1:]):
        acc = bn254.G1.add(acc, bn254.G1.mul(base, s))
    return bn254.multi_pairing_is_one(
        [
            (bn254.G1.neg(a), b),
            (vk.alpha_g1, vk.beta_g2),
            (acc, vk.gamma_g2),
            (c, vk.delta_g2),
        ]
    )


def verify_batch(
    pvk: PreparedVerifyingKey,
    proofs: Sequence,
    public_inputs_list: Sequence[Sequence[int]],
    rng=None,
) -> bool:
    """Batched Groth16 verification via a random linear combination.

    For random nonzero r_i (r_0 = 1), every proof verifies iff

        prod_i e(r_i * (-A_i), B_i) * e((sum r_i) alpha, beta)
             * e(sum_i r_i IC_i, gamma) * e(sum_i r_i C_i, delta) == 1

    except with probability ~2^-126 over the r_i. Cost: B+3 Miller loops and
    ONE final exponentiation versus 4B loops and B exponentiations for
    one-at-a-time verification. The reference has no batch verifier
    (rln/src/protocol/proof.rs:856-894 verifies one proof per call); this is
    the serving-path analog of the batch-first prover.
    """
    import secrets

    if len(proofs) != len(public_inputs_list):
        raise ValueError("proofs and public input lists differ in length")
    if not proofs:
        return True
    vk = pvk.vk
    n_pub = len(vk.gamma_abc_g1) - 1
    for pubs in public_inputs_list:
        if len(pubs) != n_pub:
            raise ValueError(f"expected {n_pub} public inputs, got {len(pubs)}")
    if len(proofs) == 1:
        return verify_proof(pvk, proofs[0], public_inputs_list[0])
    if not all(proof_points_valid(p) for p in proofs):
        return False
    rand = (lambda: rng.randrange(1, 1 << 126)) if rng is not None else (
        lambda: 1 + secrets.randbits(126)
    )
    rs = [1] + [rand() for _ in range(len(proofs) - 1)]

    from ..runtime import native

    use_native = native.pairing_available()

    def g1_msm(points, scalars):
        if use_native:
            # native raises NativeCallError on failure; None means infinity
            return native.g1_msm_native(points, [s % bn254.R for s in scalars])
        return bn254.G1.msm(points, scalars)

    # sum_i r_i IC_i = (sum r_i) abc_0 + sum_j (sum_i r_i pub_ij) base_j
    r_total = sum(rs)
    combined = [r_total] + [
        sum(r * (pubs[j] % bn254.R) for r, pubs in zip(rs, public_inputs_list))
        for j in range(n_pub)
    ]
    ic = g1_msm(vk.gamma_abc_g1, combined)
    c_comb = g1_msm([p[2] for p in proofs], rs)
    alpha_r = g1_msm([vk.alpha_g1], [r_total])
    pairs = [
        (g1_msm([bn254.G1.neg(p[0])], [r]), p[1]) for p, r in zip(proofs, rs)
    ]
    pairs += [(alpha_r, vk.beta_g2), (ic, vk.gamma_g2), (c_comb, vk.delta_g2)]
    if use_native:
        return native.multi_pairing_is_one_native(pairs)
    return bn254.multi_pairing_is_one(pairs)


def rln_public_inputs(values) -> List[int]:
    """Order proof values into circuit public inputs.

    Single: [y, root, nullifier, x, external_nullifier]
    Multi:  [ys..., root, nullifiers..., x, external_nullifier, selectors...]
    (reference: rln/src/protocol/proof.rs:861-886, zk.rs:106-123)
    """
    from ..protocol.proof import RLNProofValues  # local import to avoid cycle

    assert isinstance(values, RLNProofValues)
    if values.is_single:
        return [values.y, values.root, values.nullifier, values.x, values.external_nullifier]
    inputs: List[int] = list(values.ys)
    inputs.append(values.root)
    inputs.extend(values.nullifiers)
    inputs.append(values.x)
    inputs.append(values.external_nullifier)
    inputs.extend(1 if u else 0 for u in values.selector_used)
    return inputs
