"""The comparison that decides `correct`, run once the window has closed.

Closed loop: a sample of the window's proofs, drawn from the seed with the
first call's first lane and the last call's last lane always in it, is
proved again by the plain reference (reference/prover.py) from the same
witness and blinding; each sampled proof has to equal the reference's
point for point, and its public values the reference's public inputs.

Open loop: the service draws each proof's blinding itself, so the
reference cannot recompute the proof. A sample of the replies (the last
request due always in it) is judged by the Groth16 verification equation
for the public inputs of the reference's own witness, and the reply's
public values have to equal those inputs.

Every number compared has the limit 0: an answer is exact or it is wrong.
The reference runs in worker processes (spawned, at most one a core).
"""

from __future__ import annotations

import multiprocessing
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import traffic as gen
from .manifest import ROOT
from .reference import jobs
from .reference.wire import proof_from_wire, public_inputs

BATCH_SAMPLE = 8
SERVE_SAMPLE = 16
MAX_WORKERS = 8


def pool_map(config: dict, fn: Callable, work: Sequence) -> List:
    """fn over work in spawned workers that each load the config's circuit."""
    n = max(1, min(len(work), os.cpu_count() or 1, MAX_WORKERS))
    args = (os.path.join(ROOT, config["zkey"]), os.path.join(ROOT, config["graph"]),
            config["tree_depth"], config["max_out"])
    pool = multiprocessing.get_context("spawn").Pool(n, initializer=jobs.init, initargs=args)
    try:
        return pool.map(fn, work, chunksize=1)
    finally:
        pool.close()
        pool.join()


def sample(seed: int, sizes: Sequence[int], k: int) -> List[Tuple[int, int]]:
    """k distinct (call, lane) positions over calls of these sizes, drawn
    from the seed: the first call's lane 0 and the last call's last lane,
    then uniformly."""
    flat = [(c, lane) for c, n in enumerate(sizes) for lane in range(n)]
    if not flat:
        return []
    picked = [flat[0], flat[-1]]
    rest = flat[1:-1]
    g = gen.rng(seed, "sample")
    if rest and k > 2:
        idx = g.choice(len(rest), size=min(k - 2, len(rest)), replace=False)
        picked += [rest[i] for i in sorted(idx)]
    return sorted(set(picked))


def _norm(x):
    """Points as nested tuples of ints, however the program nests them."""
    if isinstance(x, (list, tuple)):
        return tuple(_norm(v) for v in x)
    return x if x is None else int(x)


def numbers(**values: int) -> Dict[str, Dict[str, int]]:
    return {name: {"value": int(v), "limit": 0} for name, v in values.items()}


def closed_loop(config: dict, traffic: dict, seed: int, calls: List[Optional[list]],
                failed: int, answer_fn: Optional[Callable] = None) -> Dict:
    """calls: each window call's returned [(proof, values dict)], None for a
    call that raised; failed: proofs attempted in calls that raised.
    answer_fn(call, lane, witness) replaces the lookup in calls (the
    control). Returns the numbers compared."""
    batch = int(traffic["batch"])
    positions = sample(seed, [batch] * len(calls), BATCH_SAMPLE)
    work, answers = [], []
    for call, lane in positions:
        w = gen.witnesses(config, traffic, seed, "window", call, batch)[lane]
        work.append({"named": gen.named_inputs(w), "r": w["r"], "s": w["s"]})
        if answer_fn is not None:
            answers.append(answer_fn(call, lane, w))
        else:
            answers.append(None if calls[call] is None else calls[call][lane])
    refs = pool_map(config, jobs.prove_job, work)
    bad_proofs = bad_values = 0
    for got, ref in zip(answers, refs):
        if got is None:
            bad_proofs += 1
            bad_values += 1
            continue
        proof, values = got
        bad_proofs += _norm(proof) != _norm(ref["proof"])
        bad_values += public_inputs(values, config["public_inputs"]) != ref["public"]
    print(f"check: {len(positions)} proofs sampled of {sum(c is not None for c in calls)} "
          f"calls, proved again by the reference", file=sys.stderr)
    return numbers(failed_proofs=failed, mismatched_proofs=bad_proofs,
                   mismatched_values=bad_values)


def open_loop(config: dict, traffic: dict, seed: int, requests: List[Dict],
              replies: List[Optional[bytes]]) -> Dict:
    """requests: the window's raw witnesses in order of their due times;
    replies: each one's proof bytes, None where none came."""
    positions = sample(seed, [len(requests)], SERVE_SAMPLE)
    work, values = [], []
    invalid = 0
    for _, i in positions:
        try:
            proof, vals = proof_from_wire(replies[i]) if replies[i] is not None else (None, None)
        except ValueError:
            proof, vals = None, None
        if proof is None:
            invalid += 1
            continue
        work.append({"named": gen.named_inputs(requests[i]), "proof": proof})
        values.append(vals)
    refs = pool_map(config, jobs.verify_job, work) if work else []
    bad_values = len(positions) - len(work)
    for vals, ref in zip(values, refs):
        invalid += not ref["valid"]
        bad_values += public_inputs(vals, config["public_inputs"]) != ref["public"]
    print(f"check: {len(positions)} replies sampled of {len(requests)} requests, "
          f"verified for the reference's public inputs", file=sys.stderr)
    return numbers(failed_requests=sum(r is None for r in replies), invalid_proofs=invalid,
                   mismatched_values=bad_values)


def report(checked: Dict[str, Dict[str, int]]) -> bool:
    """Prints each number beside its limit, as the last lines on standard
    error; True if none passes its limit."""
    ok = True
    for name, v in checked.items():
        ok &= v["value"] <= v["limit"]
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    return ok
