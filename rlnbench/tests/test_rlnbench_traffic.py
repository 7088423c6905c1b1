"""The generator: without `members` its witnesses are those the benchmark
has always drawn (digests taken before the pool existed), and with
`members` every lane takes a member of one standing pool, round robin over
calls and streams, with a fresh message, and each member's path changes
with the root every `root_every` messages."""

import hashlib
import json

import pytest

from rlnbench import traffic as gen
from rlnbench.manifest import Manifest

CELLS = {"rln-v2-depth20": "closed-b256", "rln-multi-msg-depth20-maxout4": "closed-b16"}

# sha256 (first 16 hex digits) of witnesses(config, traffic, seed, stream,
# index, lanes) at (index, lanes) = (0, 1), (1, 4), (7, 3), as JSON with
# sorted keys, one after the other
DIGESTS = {
    ("rln-v2-depth20", "warm", 0): "4a092c6a096112ff",
    ("rln-v2-depth20", "warm", 6000000001): "12090a4c008d158b",
    ("rln-v2-depth20", "warm", 4294967311): "8b1bb2dbe8e34339",
    ("rln-v2-depth20", "window", 0): "49a15056553ae784",
    ("rln-v2-depth20", "window", 6000000001): "4d3d064f3d16eba2",
    ("rln-v2-depth20", "window", 4294967311): "8bb67d1a84dbb501",
    ("rln-v2-depth20", "trace", 0): "ceb033c989575c86",
    ("rln-v2-depth20", "trace", 6000000001): "4fc01a8b5babbc9a",
    ("rln-v2-depth20", "trace", 4294967311): "b46fe7c235c25d16",
    ("rln-v2-depth20", "sample", 0): "724e5aaa271ac739",
    ("rln-v2-depth20", "sample", 6000000001): "933024a871463ecc",
    ("rln-v2-depth20", "sample", 4294967311): "116bfd0d10890653",
    ("rln-v2-depth20", "arrivals", 0): "f36c472d1085f910",
    ("rln-v2-depth20", "arrivals", 6000000001): "e52b8dad7d1dec2d",
    ("rln-v2-depth20", "arrivals", 4294967311): "61345008e892ed29",
    ("rln-multi-msg-depth20-maxout4", "warm", 0): "a0635fe6da091e8a",
    ("rln-multi-msg-depth20-maxout4", "warm", 6000000001): "b9d99d7777ede53b",
    ("rln-multi-msg-depth20-maxout4", "warm", 4294967311): "6c8c9fd9bf512421",
    ("rln-multi-msg-depth20-maxout4", "window", 0): "cd1810d755f1ad83",
    ("rln-multi-msg-depth20-maxout4", "window", 6000000001): "278b400cb09a91ee",
    ("rln-multi-msg-depth20-maxout4", "window", 4294967311): "7f88ba5c6998315f",
    ("rln-multi-msg-depth20-maxout4", "trace", 0): "5a6cb98d427f80e2",
    ("rln-multi-msg-depth20-maxout4", "trace", 6000000001): "78f9cfbcc49b8b9e",
    ("rln-multi-msg-depth20-maxout4", "trace", 4294967311): "b5e535eb64f995c4",
    ("rln-multi-msg-depth20-maxout4", "sample", 0): "26c67b144d9d0967",
    ("rln-multi-msg-depth20-maxout4", "sample", 6000000001): "230ab514d9b04f65",
    ("rln-multi-msg-depth20-maxout4", "sample", 4294967311): "117713aaed230ef4",
    ("rln-multi-msg-depth20-maxout4", "arrivals", 0): "61ccb83d51f028ec",
    ("rln-multi-msg-depth20-maxout4", "arrivals", 6000000001): "e5eed825589de815",
    ("rln-multi-msg-depth20-maxout4", "arrivals", 4294967311): "095e613cb312728f",
}

MEMBER = ("identity_secret", "user_message_limit", "identity_path_index")
MESSAGE = ("x", "external_nullifier", "r", "s")


@pytest.mark.parametrize("config, stream, seed", sorted(DIGESTS))
def test_witnesses_without_members_are_unchanged(config, stream, seed):
    man = Manifest.load()
    cfg, traffic = man.config(config), man.traffic(CELLS[config])
    assert "members" not in traffic
    h = hashlib.sha256()
    for index, lanes in ((0, 1), (1, 4), (7, 3)):
        ws = gen.witnesses(cfg, traffic, seed, stream, index, lanes)
        assert len(ws) == lanes and all("member" not in w for w in ws)
        h.update(json.dumps(ws, sort_keys=True).encode())
    assert h.hexdigest()[:16] == DIGESTS[(config, stream, seed)]


@pytest.mark.parametrize("config", sorted(CELLS))
def test_lanes_take_members_round_robin(config):
    cfg = Manifest.load().config(config)
    traffic = {"loop": "closed", "batch": 4, "members": 3, "root_every": 6}
    seed = 5000000077
    pool = gen.members(cfg, traffic, seed)
    assert len(pool) == 3 and len({m["identity_secret"] for m in pool}) == 3
    assert all(set(m) == set(MEMBER) | {"path_elements"} and
               len(m["path_elements"]) == cfg["tree_depth"] for m in pool)
    seen, paths = {}, {}
    for stream in ("warm", "window", "trace"):
        for call in range(3):
            ws = gen.witnesses(cfg, traffic, seed, stream, call, 4)
            assert ws == gen.witnesses(cfg, traffic, seed, stream, call, 4)
            for lane, w in enumerate(ws):
                n = call * 4 + lane
                assert (w["member"], w["epoch"]) == (n % 3, n // 6)
                assert {f: w[f] for f in MEMBER} == {f: pool[w["member"]][f] for f in MEMBER}
                paths.setdefault((w["member"], w["epoch"]), set()).add(
                    tuple(w["path_elements"]))
                seen.setdefault(w["member"], []).append(w)
    # a path for each member and root epoch: the pool's in epoch 0, a new
    # one in each later epoch, the same in every stream
    assert sorted(paths) == [(k, e) for k in range(3) for e in range(2)]
    assert all(len(p) == 1 for p in paths.values())
    assert all(paths[(k, 0)] == {tuple(pool[k]["path_elements"])} for k in range(3))
    assert len(set.union(*paths.values())) == len(paths)
    for ws in seen.values():  # one member, many messages: each its own
        for f in MESSAGE:
            assert len({w[f] for w in ws}) == len(ws)
        ids = [json.dumps(w.get("message_id", w.get("message_ids"))) for w in ws]
        assert len(set(ids)) > 1
    assert gen.members(cfg, traffic, seed) == pool
    assert gen.members(cfg, traffic, seed + 1) != pool
    # a lane's fields are its own copy: changing one leaves the pool as drawn
    gen.witnesses(cfg, traffic, seed, "window", 0, 4)[0]["path_elements"][0] += 1
    assert gen.members(cfg, traffic, seed) == pool
