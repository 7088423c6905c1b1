"""The reference's work for one sampled answer, run in worker processes.

Each worker loads the circuit once (init) and then, for a sampled
witness, computes its assignment and either the whole proof at the given
blinding (prove_job) or judges a proof whose blinding it does not know by
the Groth16 verification equation (verify_job):

    e(-A, B) e(alpha, beta) e(sum_i x_i IC_i, gamma) e(C, delta) == 1

with the public inputs x the reference's own assignment gives. Nothing
here imports the program under test.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import bn254
from . import prover as ref
from .msm import msm

_circuit: Optional[ref.Circuit] = None


def init(zkey_path: str, graph_path: str, tree_depth: int, max_out: Optional[int]) -> None:
    global _circuit
    _circuit = ref.load_circuit(zkey_path, graph_path, tree_depth, max_out)


def prove_job(job: Dict) -> Dict:
    """job: named (the graph's inputs), r, s and scalar_mask (None, or the
    control's). Returns the reference's proof and public inputs."""
    z = ref.assignment(_circuit, job["named"])
    proof = ref.prove(_circuit, z, job["r"], job["s"], job.get("scalar_mask"))
    return {"proof": proof, "public": ref.public_inputs(_circuit, z)}


def verify_job(job: Dict) -> Dict:
    """job: named and proof (a, b, c) affine as decoded from the program's
    reply. Returns the reference's public inputs and whether the proof
    satisfies the verification equation for them."""
    z = ref.assignment(_circuit, job["named"])
    public = ref.public_inputs(_circuit, z)
    return {"public": public, "valid": verify(_circuit.zkey.pk.vk, job["proof"], public)}


def verify(vk, proof, public) -> bool:
    a, b, c = proof
    for p in (a, c):
        if p is not None and not bn254.G1.is_on_curve(p):
            return False
    if b is not None and not bn254.G2.is_on_curve(b):
        return False
    acc = bn254.G1.add(vk.gamma_abc_g1[0], msm(vk.gamma_abc_g1[1:], public))
    return bn254.multi_pairing_is_one([
        (bn254.G1.neg(a), b),
        (vk.alpha_g1, vk.beta_g2),
        (acc, vk.gamma_g2),
        (c, vk.delta_g2),
    ])
