"""The one generator of the benchmark's traffic, driven by a traffic file.

A traffic file (traffic/<name>.json) holds only parameters:

    loop          "closed": one caller, each call a batch of `batch`
                  witnesses through RLN.generate_proofs, the next call
                  when the last returns; "open": single-witness
                  POST /prove requests to the prover service at
                  `rate_per_s`, Poisson arrivals
    batch         witnesses a call (closed loop)
    rate_per_s    offered requests a second (open loop)
    trace_calls / trace_seconds   the traced segment of a --trace 1 run
    members       optional: M, a standing pool of members that every
                  message comes from (a prover that proves for many
                  members, each for many messages)
    root_every    with `members`, required: N, the messages of a stream
                  after which the tree's root changes (new members join a
                  live RLN tree all the time), and with it every member's
                  path

Without `members` every witness is fresh and drawn from the seed: an
identity secret, a depth-long path of random siblings and index bits,
message ids below the user message limit (on a multi-message-id circuit
every slot in use, with distinct ids), x and the external nullifier. The
blinding scalars (r, s) of a call come from the same stream. A stream is
keyed by (seed, name, index), so the check can draw any call's inputs
again.

With `members`, message n = c * lanes + i of a stream (lane i of call c)
comes from member n mod M and falls in root epoch n // N. A member's
identity secret, user message limit and index bits (its leaf keeps its
place) are drawn once from the stream "members"; its path is drawn anew
for each epoch from that stream's index 1 + epoch * M + member, the whole
path where a real registration changes one sibling and the hashes above
it: either way the path wires change, and with them any work done for the
member's old path. Only the message's own fields (message id(s) and
selectors, x, external nullifier, r and s) come from the call's stream.
Each such witness names its "member" and "epoch". No traffic keeps paths
fixed: a pool whose root never changed would let a prover do all of its
per-member work in set-up, which no live deployment allows.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import numpy as np

from .reference.constants import R

STREAMS = {"warm": 1, "window": 2, "trace": 3, "sample": 4, "arrivals": 5, "members": 6}


def rng(seed: int, stream: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), STREAMS[stream], index])


def _fr(raw: bytes, count: int) -> List[int]:
    return [int.from_bytes(raw[32 * i: 32 * i + 32], "little") % R for i in range(count)]


def members(config: dict, traffic: dict, seed: int) -> List[Dict]:
    """The traffic's pool of `members` members as it stands in root epoch 0
    (the same for the same seed): each an identity secret, the user message
    limit, a path and its index bits."""
    count = int(traffic["members"])
    return [_member(config, seed, count, k, 0) for k in range(count)]


@functools.lru_cache(maxsize=4)
def _pool(seed: int, count: int, depth: int) -> Tuple[tuple, ...]:
    """Each member's identity secret and index bits, drawn once a process."""
    g = rng(seed, "members")
    secrets = _fr(g.bytes(32 * count), count)
    bits = g.integers(0, 2, size=(count, depth))
    return tuple((secrets[k], tuple(int(b) for b in bits[k])) for k in range(count))


def _member(config: dict, seed: int, count: int, k: int, epoch: int) -> Dict:
    """Member k of a pool of `count`, with its path in root epoch `epoch`."""
    depth = config["tree_depth"]
    secret, bits = _pool(seed, count, depth)[k]
    path = rng(seed, "members", 1 + epoch * count + k).bytes(32 * depth)
    return {"identity_secret": secret,
            "user_message_limit": config["assumed"]["user_message_limit"],
            "path_elements": _fr(path, depth), "identity_path_index": list(bits)}


def witnesses(config: dict, traffic: dict, seed: int, stream: str, index: int,
              lanes: int) -> List[Dict]:
    """The raw fields of `lanes` witnesses (the same for the same seed,
    stream and index), each with its blinding r and s: fresh ones, or with
    the traffic's `members` the pool's members with fresh messages."""
    if traffic.get("members"):
        return _pooled(config, traffic, seed, stream, index, lanes)
    g = rng(seed, stream, index)
    depth = config["tree_depth"]
    max_out = config["max_out"]
    limit = config["assumed"]["user_message_limit"]
    per = depth + 5
    vals = _fr(g.bytes(32 * per * lanes), per * lanes)
    bits = g.integers(0, 2, size=(lanes, depth))
    out = []
    for i in range(lanes):
        v = vals[i * per:(i + 1) * per]
        w = {
            "identity_secret": v[0],
            "user_message_limit": limit,
            "path_elements": v[5:],
            "identity_path_index": [int(b) for b in bits[i]],
            "x": v[1],
            "external_nullifier": v[2],
            "r": v[3],
            "s": v[4],
        }
        out.append(_with_message_ids(w, g, max_out, limit))
    return out


def _pooled(config: dict, traffic: dict, seed: int, stream: str, index: int,
             lanes: int) -> List[Dict]:
    g = rng(seed, stream, index)
    count, every = int(traffic["members"]), int(traffic["root_every"])
    vals = _fr(g.bytes(32 * 4 * lanes), 4 * lanes)
    out = []
    for i in range(lanes):
        n = index * lanes + i
        k, epoch = n % count, n // every
        x, ext, r, s = vals[4 * i:4 * i + 4]
        w = {**_member(config, seed, count, k, epoch), "x": x, "external_nullifier": ext,
             "r": r, "s": s, "member": k, "epoch": epoch}
        out.append(_with_message_ids(w, g, config["max_out"],
                                     config["assumed"]["user_message_limit"]))
    return out


def _with_message_ids(w: Dict, g: np.random.Generator, max_out, limit: int) -> Dict:
    """w with its message id below the limit, or on a multi-message-id
    circuit max_out distinct ids, every slot in use."""
    if max_out is None:
        w["message_id"] = int(g.integers(0, limit))
    else:
        w["message_ids"] = [int(m) for m in g.choice(limit, size=max_out, replace=False)]
        w["selector_used"] = [True] * max_out
    return w


def named_inputs(w: Dict) -> Dict[str, List[int]]:
    """The witness graph's inputs for one witness's raw fields."""
    named = {
        "identitySecret": [w["identity_secret"]],
        "userMessageLimit": [w["user_message_limit"]],
    }
    if "message_id" in w:
        named["messageId"] = [w["message_id"]]
    else:
        named["messageId"] = list(w["message_ids"])
        named["selectorUsed"] = [1 if u else 0 for u in w["selector_used"]]
    named["pathElements"] = list(w["path_elements"])
    named["identityPathIndex"] = list(w["identity_path_index"])
    named["x"] = [w["x"]]
    named["externalNullifier"] = [w["external_nullifier"]]
    return named


def arrivals(traffic: dict, seed: int, seconds: float) -> List[float]:
    """Due times, in seconds from the window's start, of an open loop: N =
    rate x seconds requests whose gaps are the N quantiles of the
    exponential law of that rate, scaled to sum to N / rate, in an order
    drawn from the seed. Every seed gets the same gaps."""
    rate = float(traffic["rate_per_s"])
    n = max(1, round(rate * seconds))
    gaps = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    gaps *= (n / rate) / gaps.sum()
    rng(seed, "arrivals").shuffle(gaps)
    return [float(t) for t in np.cumsum(gaps)]
