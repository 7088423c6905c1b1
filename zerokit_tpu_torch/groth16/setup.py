"""Groth16 trusted setup (circuit-specific CRS generation), host-side.

Generates a proving/verifying key pair from constraint matrices with the same
structure ark-groth16's generator produces for CircomReduction circuits (the
reference consumes such keys from pre-built arkzkey files; having our own
setup lets the framework prove arbitrary R1CS, and powers small-circuit
end-to-end tests of the TPU prover).

h_query follows CircomReduction::h_query_scalars (rln/src/circuit/qap.rs:
100-117): the Lagrange-style bases over the 2N domain read off the odd
coefficients, so the prover's witness-map output pairs with it directly.
"""

from __future__ import annotations

import random
from typing import List

from ..circuit.zkey import ConstraintMatrices, ProvingKey, VerifyingKey, Zkey
from ..constants import R
from ..hostmath import bn254
from .ntt import domain_generator, domain_size_for


def _ifft_host(values: List[int], n: int) -> List[int]:
    """Recursive radix-2 inverse NTT over Fr (host ints, test-scale sizes)."""
    g = pow(domain_generator(n), -1, R)

    def rec(vals, root):
        m = len(vals)
        if m == 1:
            return vals
        even = rec(vals[0::2], root * root % R)
        odd = rec(vals[1::2], root * root % R)
        out = [0] * m
        w = 1
        for k in range(m // 2):
            t = w * odd[k] % R
            out[k] = (even[k] + t) % R
            out[k + m // 2] = (even[k] - t) % R
            w = w * root % R
        return out

    n_inv = pow(n, -1, R)
    return [v * n_inv % R for v in rec(list(values), g)]


def _lagrange_coeffs_at(t: int, n: int) -> List[int]:
    """L_r(t) for the size-n radix-2 domain: L_r(t) = Z(t) g^r / (n (t - g^r))."""
    g = domain_generator(n)
    z_t = (pow(t, n, R) - 1) % R
    n_inv = pow(n, -1, R)
    out = []
    gr = 1
    for _ in range(n):
        out.append(z_t * gr % R * pow((t - gr) % R, -1, R) % R * n_inv % R)
        gr = gr * g % R
    return out


def groth16_setup(matrices: ConstraintMatrices, rng: random.Random | None = None) -> Zkey:
    rng = rng or random.Random()
    num_inputs = matrices.num_instance_variables
    num_aux = matrices.num_witness_variables
    n_wires = num_inputs + num_aux
    nc = matrices.num_constraints
    domain = domain_size_for(nc + num_inputs)

    alpha = rng.randrange(1, R)
    beta = rng.randrange(1, R)
    gamma = rng.randrange(1, R)
    delta = rng.randrange(1, R)
    t = rng.randrange(1, R)
    while pow(t, domain, R) == 1:  # t must avoid the domain (Z(t) != 0)
        t = rng.randrange(1, R)

    lag = _lagrange_coeffs_at(t, domain)

    a_t = [0] * n_wires
    b_t = [0] * n_wires
    c_t = [0] * n_wires
    for row_idx in range(nc):
        for coeff, wire in matrices.a[row_idx]:
            a_t[wire] = (a_t[wire] + coeff * lag[row_idx]) % R
        for coeff, wire in matrices.b[row_idx]:
            b_t[wire] = (b_t[wire] + coeff * lag[row_idx]) % R
        for coeff, wire in matrices.c[row_idx]:
            c_t[wire] = (c_t[wire] + coeff * lag[row_idx]) % R
    # instance rows appended after the constraints (witness_map does the same)
    for j in range(num_inputs):
        a_t[j] = (a_t[j] + lag[nc + j]) % R

    g1 = bn254.G1_GENERATOR
    g2 = bn254.G2_GENERATOR
    gamma_inv = pow(gamma, -1, R)
    delta_inv = pow(delta, -1, R)

    def g1mul(k):
        return bn254.G1.mul(g1, k % R)

    def g2mul(k):
        return bn254.G2.mul(g2, k % R)

    a_query = [g1mul(a_t[i]) for i in range(n_wires)]
    b_g1_query = [g1mul(b_t[i]) for i in range(n_wires)]
    b_g2_query = [g2mul(b_t[i]) for i in range(n_wires)]
    gamma_abc = [
        g1mul((beta * a_t[i] + alpha * b_t[i] + c_t[i]) * gamma_inv) for i in range(num_inputs)
    ]
    l_query = [
        g1mul((beta * a_t[i] + alpha * b_t[i] + c_t[i]) * delta_inv)
        for i in range(num_inputs, n_wires)
    ]
    # CircomReduction h_query (qap.rs:100-117): ifft over the 2N domain of
    # delta_inv * t^i, odd coefficients
    max_power = domain - 1
    scalars = [delta_inv * pow(t, i, R) % R for i in range(2 * max_power + 1)]
    big = domain_size_for(2 * max_power + 1)
    scalars += [0] * (big - len(scalars))
    coeffs = _ifft_host(scalars, big)
    h_query = [g1mul(coeffs[i]) for i in range(1, len(coeffs), 2)]

    vk = VerifyingKey(
        alpha_g1=g1mul(alpha),
        beta_g2=g2mul(beta),
        gamma_g2=g2mul(gamma),
        delta_g2=g2mul(delta),
        gamma_abc_g1=gamma_abc,
    )
    pk = ProvingKey(
        vk=vk,
        beta_g1=g1mul(beta),
        delta_g1=g1mul(delta),
        a_query=a_query,
        b_g1_query=b_g1_query,
        b_g2_query=b_g2_query,
        h_query=h_query,
        l_query=l_query,
    )
    return Zkey(pk=pk, matrices=matrices)
