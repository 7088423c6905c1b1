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

Every witness is fresh and drawn from the seed: an identity secret, a
depth-long path of random siblings and index bits, message ids below the
user message limit (on a multi-message-id circuit every slot in use, with
distinct ids), x and the external nullifier. The blinding scalars
(r, s) of a call come from the same stream. A stream is keyed by
(seed, name, index), so the check can draw any call's inputs again.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from .reference.constants import R

STREAMS = {"warm": 1, "window": 2, "trace": 3, "sample": 4, "arrivals": 5}


def rng(seed: int, stream: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), STREAMS[stream], index])


def _fr(raw: bytes, count: int) -> List[int]:
    return [int.from_bytes(raw[32 * i: 32 * i + 32], "little") % R for i in range(count)]


def witnesses(config: dict, traffic: dict, seed: int, stream: str, index: int,
              lanes: int) -> List[Dict]:
    """The raw fields of `lanes` fresh witnesses (the same for the same
    seed, stream and index), each with its blinding r and s."""
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
        if max_out is None:
            w["message_id"] = int(g.integers(0, limit))
        else:
            w["message_ids"] = [int(m) for m in g.choice(limit, size=max_out, replace=False)]
            w["selector_used"] = [True] * max_out
        out.append(w)
    return out


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
