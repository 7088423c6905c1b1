"""Per-component benchmark suites on the card, each checked against a host oracle.

Counterpart of tools/bench_components.py (BASELINE.md's measurement
configs), with the same suites in the same order, the same configs, seeds
and units: batched Poseidon pair hashing (P1), the device tree's bulk
insert of 2^20 leaves (K1, P1), the standalone G1 MSM at 2^16..2^22 points
(K1-K3), and the NTT at 2^20..2^22 (fft / ifft: K4, K5). Each config emits
one JSON line:

    {"suite": "msm", "config": "g1_2e16_b4", "value": ..., "unit": "points/s",
     "sec_per_msm": ..., "device_ms": ..., "bound_ms": ..., "cold_sec": ...,
     "checked": true, "device": "cuda", "card": "<name>, <power limit>"}

value is the best of 3 timed calls after one warm-up, by the host clock
ending in torch.cuda.synchronize(); device_ms is one call's card time
(runtime/profiling.device_ms); bound_ms the least time the card could take
(runtime/profiling.kernel_bound: msm_mont_muls for the MSM, the
butterflies' products or bytes for the NTT, poseidon_imads for P1);
cold_sec the host preparation (points, encodings, window tables, twiddle
tables) and the warm-up call, outside the timed region; an MSM line's
ranges_ms the card ms of one traced call inside each stage of the
pass (msm.digits, msm.sort, msm.fine, msm.coarse, msm.qgather,
msm.sumq); card the line that `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives (null on the CPU, where device_ms, bound_ms
and ranges_ms are null too).

Every suite checks its own result at full size, exactly, against the
native host library (runtime/native), and says so as "checked": true:

  * msm: the bases repeat with period 256, so each lane's MSM equals
    sum_j (sum_{i = j mod 256} s_i mod r) * P_j, a 256-point MSM that
    native.g1_msm_native computes; affine points compared, every lane;
  * ntt: ifft(fft(x)) == x on the timed input at every size; on an input
    that repeats nowhere, fft and ifft against natural_ntt_plain on the
    same device and ifft(fft(x)) == x at every size, and fft against
    native.fr_ntt_native at the first size (2^20);
  * poseidon: every lane against native.poseidon_hash_pairs_native up to
    2^16 pairs, a seeded sample of 4096 lanes above (the host hashes
    ~60 us a pair);
  * tree: the root against native.merkle_compute_root_native, from leaf 0
    and its path, all hashed natively (the leaves repeat with period 4096,
    so every node above that block's subtree root is a hash of two equal
    nodes).

A suite that raises, or whose check fails, is logged; the later suites
still run and the tool exits 1.

Usage:  python -m zerokit_tpu_torch.tools.bench_components [suite ...] [--log]
            [--device cuda]
        suites: poseidon tree msm ntt (default: all, in that order)
        --log appends each line to build/zerokit_tpu_torch/BENCHLOG.jsonl
Env:    BC_MAX_LOG2 caps the largest MSM / NTT / Poseidon / tree size
        (default 20; 22 runs every config).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..constants import R
from ..ff.field import FR, FrField, encode_canonical_fast, resolve_device
from ..runtime import native
from ..runtime.profiling import (REPO_DIR, ChipSpec, device_ms, kernel_bound, range_times,
                                 trace)

T0 = time.time()
ROUNDS = 3  # timed calls after the warm-up; the best is the line's value
MSM_LOG2 = (16, 18, 20, 22)
MSM_BATCH = 4
BASE_BLOCK = 256  # the MSM's bases repeat with this period
NTT_LOG2 = (20, 21, 22)
PAIRS = (1 << 10, 1 << 16, 1 << 20)
TREE_DEPTH = 20
VALUE_BLOCK = 4096  # the NTT's values and the tree's leaves repeat with this period
PAIRS_CHECKED_WHOLE = 1 << 16  # above, a seeded sample of the lanes is checked
PAIRS_SAMPLE = 4096
LOG_PATH = os.path.join(REPO_DIR, "build", "zerokit_tpu_torch", "BENCHLOG.jsonl")


def max_log2() -> int:
    return int(os.environ.get("BC_MAX_LOG2", "20"))


def log(msg: str) -> None:
    print(f"[components +{time.time() - T0:6.1f}s] {msg}", file=sys.stderr, flush=True)


class Bench:
    """A run's device, card and lines. On the card it reads the card's name,
    power limit and peak rates; on the CPU (tests) nothing is measured on a
    card and those fields stay null."""

    def __init__(self, device="cuda", log_path=None):
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.chip = ChipSpec.from_device(torch.cuda.current_device()) if self.cuda else None
        self.card = self.chip.label() if self.cuda else None  # nvidia-smi's name, power.limit
        self.log_path = log_path
        self.lines = []

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def timeit(self, fn):
        """(best seconds of ROUNDS calls, the last output, the warm-up
        call's seconds), each call ending in a synchronize."""
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        first = time.perf_counter() - t0
        best = float("inf")
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            out = fn()
            self.sync()
            best = min(best, time.perf_counter() - t0)
        return best, out, first

    def device_ms(self, fn, reps: int = 3):
        return device_ms(fn, reps) if self.cuda else None

    def ranges_ms(self, fn):
        """Card ms inside each span() range (msm.sort, msm.fine, ...) of one
        fn() call under torch.profiler (runtime/profiling.range_times);
        None on the CPU."""
        if not self.cuda:
            return None
        with trace() as prof:
            fn()
        return {name: us / 1e3 for name, us in range_times(prof).items()}

    def bound_ms(self, parts) -> float:
        """Sum of kernel_bound over (key, shape) parts, in ms; None on the CPU."""
        if not self.cuda:
            return None
        return sum(kernel_bound(key, self.chip, **shape)[0] for key, shape in parts) * 1e3

    def emit(self, suite: str, config: str, value: float, unit: str, extra: dict,
             checked: bool) -> dict:
        line = {"suite": suite, "config": config, "value": value, "unit": unit}
        line.update(extra)
        line.update({"checked": checked, "device": str(self.device), "card": self.card})
        print(json.dumps(line), flush=True)
        if self.log_path:
            os.makedirs(os.path.dirname(self.log_path), exist_ok=True)
            with open(self.log_path, "a") as f:
                f.write(json.dumps(line) + "\n")
        self.lines.append(line)
        if not checked:
            raise AssertionError(f"{suite} {config}: the result differs from the host oracle")
        return line


def _require_native() -> None:
    if not native.available():
        raise RuntimeError("the native host library is not built: no oracle to check against")


def _limbs(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).to(device)


# ---------------------------------------------------------------------------
# poseidon
# ---------------------------------------------------------------------------


def check_pairs(left: np.ndarray, right: np.ndarray, out: torch.Tensor) -> int:
    """Lanes of P1's hashes (Montgomery) that equal the native host hash of
    the same pairs: every lane up to PAIRS_CHECKED_WHOLE, else a seeded
    sample of PAIRS_SAMPLE; raises on a difference. Returns the lanes
    checked."""
    _require_native()
    n = left.shape[1]
    idx = np.arange(n)
    if n > PAIRS_CHECKED_WHOLE:
        idx = np.sort(np.random.default_rng(n).choice(n, PAIRS_SAMPLE, replace=False))
    lefts = [int(v) for v in FR.decode(left[:, idx])]
    rights = [int(v) for v in FR.decode(right[:, idx])]
    want = native.poseidon_hash_pairs_native(lefts, rights)
    got = [int(v) for v in FR.decode(out[:, torch.from_numpy(idx).to(out.device)])]
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        raise AssertionError(f"pairs_{n}: lane {int(idx[bad])} differs from the native hash")
    return len(idx)


def bench_poseidon(b: Bench, limit: int, sizes=PAIRS) -> None:
    """Batched Poseidon pair hashes on the card (P1, t = 3)."""
    from ..hash.poseidon import poseidon_hash_pair_mont

    rnd = np.random.default_rng(11)
    for n in sizes:
        if n > (1 << limit):
            continue
        # random Montgomery-domain limb arrays (any residue is a valid input)
        left = rnd.integers(0, 1 << 16, size=(16, n), dtype=np.uint64).astype("uint32")
        right = rnd.integers(0, 1 << 16, size=(16, n), dtype=np.uint64).astype("uint32")
        left[15] &= 0x0FFF
        right[15] &= 0x0FFF
        la, ra = _limbs(left, b.device), _limbs(right, b.device)
        call = lambda: poseidon_hash_pair_mont(la, ra)  # noqa: E731
        sec, out, first = b.timeit(call)
        lanes = check_pairs(left, right, out)
        b.emit("poseidon", f"pairs_{n}", n / sec, "hashes/s",
               {"sec": sec, "device_ms": b.device_ms(call),
                "bound_ms": b.bound_ms([("P1", {"t": 3, "lanes": n})]),
                "cold_sec": first, "checked_lanes": lanes}, True)


# ---------------------------------------------------------------------------
# tree
# ---------------------------------------------------------------------------


def native_root(block, depth: int) -> int:
    """The root of the depth-`depth` tree whose leaves repeat `block` (a
    power of two of them), hashed by the native library: the block's
    levels, then one hash of two equal nodes a level above it; the root is
    merkle_compute_root_native's from leaf 0 and that path."""
    _require_native()
    level, path = list(block), []
    while len(level) > 1:
        path.append(level[1])
        level = native.poseidon_hash_pairs_native(level[0::2], level[1::2])
    node = level[0]
    while len(path) < depth:
        path.append(node)
        node = native.poseidon_hash_pairs_native([node], [node])[0]
    root = native.merkle_compute_root_native(block[0], path, [0] * depth)
    if root != node:
        raise AssertionError("the native path's root differs from the native levels' root")
    return root


def bench_tree(b: Bench, limit: int, depth: int = TREE_DEPTH) -> None:
    """Bulk insert of 2^depth leaves into a new DeviceMerkleTree and its root:
    K1 (to Montgomery form), then one P1 launch a level."""
    from ..tree.batched import DeviceMerkleTree

    depth = min(depth, limit)
    n = 1 << depth
    rnd = np.random.default_rng(13)
    block = [int(x) for x in rnd.integers(1, 1 << 62, size=min(n, VALUE_BLOCK))]
    leaves = (block * (n // len(block) + 1))[:n]
    t0 = time.perf_counter()
    canon = encode_canonical_fast(leaves).to(b.device)
    encode_sec = time.perf_counter() - t0

    def run():
        tree = DeviceMerkleTree(depth, device=b.device)
        tree.set_leaves_mont(0, FrField.to_mont(canon))
        return tree.root()

    sec, root, first = b.timeit(run)
    want = native_root(block, depth)
    levels = [("P1", {"t": 3, "lanes": 1 << lv}) for lv in range(depth)]
    b.emit("tree", f"bulk_insert_2e{depth}", n / sec, "leaves/s",
           {"warm_sec": sec, "device_ms": b.device_ms(run),
            "bound_ms": b.bound_ms([("K1", {"lanes": n})] + levels),
            "cold_sec": encode_sec + first}, root == want)


# ---------------------------------------------------------------------------
# msm
# ---------------------------------------------------------------------------


def reduced_scalars(scal: np.ndarray, period: int, lane: int) -> list:
    """sum_{i = j mod period} s_i mod r for j < period, from the canonical
    limbs (16, n, B) of lane `lane`: per-limb sums (each < 2^16 * n / period)
    carried into integers."""
    n = scal.shape[1]
    sums = scal[:, :, lane].astype(np.int64).reshape(16, n // period, period).sum(axis=1)
    return [sum(int(sums[k, j]) << (16 * k) for k in range(16)) % R for j in range(period)]


def bench_msm(b: Bench, limit: int, sizes=MSM_LOG2, batch: int = MSM_BATCH) -> None:
    """Standalone G1 MSM throughput, random points / scalars, batch 4."""
    from ..ff.fq2 import FqAdapter
    from ..groth16.msm import MSM
    from ..hostmath import bn254

    rnd = np.random.default_rng(7)
    for log2n in sizes:
        if log2n > limit:
            log(f"msm 2^{log2n} skipped (BC_MAX_LOG2={limit})")
            continue
        n = 1 << log2n
        t0 = time.perf_counter()
        # distinct pseudo-random affine points without n host scalar-muls:
        # repeat a block of 256 random multiples of G cyclically (MSM cost
        # is independent of point values)
        base = [bn254.G1.mul(bn254.G1_GENERATOR, int(rnd.integers(1, 1 << 62)))
                for _ in range(BASE_BLOCK)]
        points = [base[i % BASE_BLOCK] for i in range(n)]
        msm = MSM(points, FqAdapter, device=b.device)
        msm.tables()
        b.sync()
        prep = time.perf_counter() - t0
        log(f"msm 2^{log2n}: points, encoding and window tables in {prep:.1f} s")
        # random canonical scalars: 16x16-bit limbs, top limb < 2^12 so the
        # value stays < 2^252 < R
        scal = rnd.integers(0, 1 << 16, size=(16, n, batch), dtype=np.uint64).astype("uint32")
        scal[15] &= 0x0FFF
        s_dev = _limbs(scal, b.device)
        call = lambda: msm(s_dev)  # noqa: E731
        sec, acc, first = b.timeit(call)
        got = msm.to_affine_ints(acc)
        _require_native()
        period = min(n, BASE_BLOCK)
        want = [native.g1_msm_native(base[:period], reduced_scalars(scal, period, lane))
                for lane in range(batch)]
        b.emit("msm", f"g1_2e{log2n}_b{batch}", n * batch / sec, "points/s",
               {"sec_per_msm": sec / batch, "device_ms": b.device_ms(call),
                "bound_ms": b.bound_ms([("MSM", {"n": n, "lanes": batch})]),
                "ranges_ms": b.ranges_ms(call), "cold_sec": prep + first}, got == want)
        del msm, acc, s_dev, call  # the next size's tables and passes reuse the memory
        if b.cuda:
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# ntt
# ---------------------------------------------------------------------------


def check_ntt(n: int, device, with_native: bool) -> bool:
    """fft and ifft at n on an input that repeats nowhere, limbs drawn from
    a seeded rng: fft and ifft each equal to groth16/ntt.natural_ntt_plain
    on the same tensors, ifft(fft(x)) == x, and with_native fft equal to
    native.fr_ntt_native. (The timed input repeats with period
    VALUE_BLOCK, so every forward stage with m >= VALUE_BLOCK sees a == b
    and multiplies 0 by its twiddles: a wrong twiddle there is invisible.)"""
    from ..groth16 import ntt
    from .ntt_micro import make_input

    x = make_input(n, 1, device, seed=n)
    y = ntt.fft(x)
    inv = pow(n, -1, R)
    ok = (torch.equal(y, ntt.natural_ntt_plain(x, False))
          and torch.equal(ntt.ifft(y), x)
          and torch.equal(ntt.ifft(x), ntt.natural_ntt_plain(x, True, inv)))
    if ok and with_native:
        _require_native()
        want = native.fr_ntt_native([int(v) for v in FR.decode(x.reshape(16, n))])
        ok = torch.equal(y.reshape(16, n).cpu(), FR.encode(want))
    return ok


def bench_ntt(b: Bench, limit: int, sizes=NTT_LOG2) -> None:
    """Natural-order fft / ifft of one column on the (16, B, n) layout (K4
    stages m >= 1024, one K5 tail, the bit-reversal gather), timed on the
    JAX tool's periodic input and checked on that and on one that repeats
    nowhere (check_ntt)."""
    from ..groth16 import ntt

    rnd = np.random.default_rng(3)
    native_at = min(sizes)
    for log2n in sizes:
        if log2n > limit:
            log(f"ntt 2^{log2n} skipped (BC_MAX_LOG2={limit})")
            continue
        n = 1 << log2n
        vals = [int(x) for x in rnd.integers(0, 1 << 62, size=min(n, VALUE_BLOCK))]
        reps = n // len(vals)
        x = FR.encode(vals).to(b.device).repeat(1, reps).reshape(16, 1, n)
        bound = [("NTT", {"rows": 1, "n": n})]
        sec_f, y, cold_f = b.timeit(lambda: ntt.fft(x))
        sec_i, z, cold_i = b.timeit(lambda: ntt.ifft(y))
        checked = torch.equal(z, x) and check_ntt(n, b.device, log2n == native_at)
        b.emit("ntt", f"fft_2e{log2n}", n / sec_f, "elements/s",
               {"sec": sec_f, "device_ms": b.device_ms(lambda: ntt.fft(x)),
                "bound_ms": b.bound_ms(bound), "cold_sec": cold_f,
                "native_checked": log2n == native_at}, checked)
        b.emit("ntt", f"ifft_2e{log2n}", n / sec_i, "elements/s",
               {"sec": sec_i, "device_ms": b.device_ms(lambda: ntt.ifft(y)),
                "bound_ms": b.bound_ms([("NTT", {"rows": 1, "n": n, "scale": True})]),
                "cold_sec": cold_i}, checked)
        del x, y, z


SUITES = {
    "poseidon": bench_poseidon,
    "tree": bench_tree,
    "msm": bench_msm,
    "ntt": bench_ntt,
}


def run(chosen, device="cuda", limit=None, log_path=None):
    """Runs the chosen suites in SUITES' order; returns (the Bench with its
    lines, the names of the suites that failed)."""
    limit = max_log2() if limit is None else limit
    b = Bench(device, log_path)
    log(f"device {b.device} ({b.card or 'no card'}); suites {list(chosen)}; "
        f"BC_MAX_LOG2={limit}")
    native.ensure_loaded(log)  # the oracles; built with g++ where no copy loads
    failed = []
    for name in SUITES:
        if name not in chosen:
            continue
        try:
            SUITES[name](b, limit)
        except Exception as e:  # the later suites still run; the tool exits 1
            log(f"suite {name} FAILED: {type(e).__name__}: {e}")
            failed.append(name)
    return b, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("suites", nargs="*", help=f"of {', '.join(SUITES)} (default: all)")
    ap.add_argument("--log", action="store_true", help=f"append the lines to {LOG_PATH}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.suites) - set(SUITES))
    if unknown:
        ap.error(f"unknown suites {unknown}")
    _, failed = run(args.suites or list(SUITES), args.device,
                    log_path=LOG_PATH if args.log else None)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
