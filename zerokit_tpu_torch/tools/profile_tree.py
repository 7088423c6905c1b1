"""Where the time of a device tree's rebuild goes, level by level.

A warm DeviceMerkleTree(depth).set_leaves_mont(0, leaves) is timed by CUDA
events; then each level's own P1 call, on the tree's levels in place (the
level below read as its own lefts and rights), is timed by device_ms
beside its bound (runtime/profiling.kernel_bound) and its share of it.
chip_smoke.py phase 10 runs the same on its member tree.

Run on the card: python -m zerokit_tpu_torch.tools.profile_tree [--depth 20]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..constants import R
from ..hash import poseidon_kernels as pk
from ..runtime.profiling import ChipSpec, device_ms, host_call, kernel_bound
from ..tree.batched import DeviceMerkleTree


def rebuild_ms(tree: DeviceMerkleTree, leaves: torch.Tensor, runs: int = 3) -> list:
    """Card ms of each of `runs` warm set_leaves_mont(0, leaves), by CUDA
    events around the whole rebuild."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(runs):
        start.record()
        tree.set_leaves_mont(0, leaves)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def level_times(tree: DeviceMerkleTree, chip: ChipSpec, reps: int = 10) -> list:
    """One row a level, leaf level's parents first: the level the call
    writes, its hashes, the call's card ms (device_ms over reps calls back
    to back), its bound in ms and the share of it."""
    rows = []
    for lv in range(tree.depth, 0, -1):
        level = tree._levels[lv]
        lefts, rights = level[:, 0::2], level[:, 1::2]
        call = lambda: pk.poseidon_perm([lefts, rights])  # noqa: E731
        _, enqueue_s = host_call(call)
        ms = device_ms(call, reps, enqueue_s)
        sec, _ = kernel_bound("P1", chip, t=3, lanes=lefts.shape[1])
        rows.append({"level": lv - 1, "lanes": lefts.shape[1], "ms": ms,
                     "bound_ms": sec * 1e3, "share": sec * 1e3 / ms})
    return rows


def print_levels(rows: list, label: str) -> None:
    for r in rows:
        print(f"  level {r['level']:2d}: {r['lanes']:7d} hashes, P1 {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms, share {r['share']:.1%}", flush=True)
    ms = sum(r["ms"] for r in rows)
    bound = sum(r["bound_ms"] for r in rows)
    print(f"  the {len(rows)} levels' calls: {ms:.4f} ms against {bound:.4f} ms of bound "
          f"({bound / ms:.1%}); {label}", flush=True)


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, default=20)
    ap.add_argument("--seed", type=int, default=20)
    args = ap.parse_args()
    chip = ChipSpec.from_device(torch.cuda.current_device())
    limbs = np.random.default_rng(args.seed).integers(0, 1 << 16, size=(16, 1 << args.depth),
                                                      dtype=np.uint32)
    limbs[15] %= R >> 240  # every value below r
    leaves = torch.from_numpy(limbs.astype(np.int32)).cuda()
    tree = DeviceMerkleTree(args.depth, device="cuda")
    tree.set_leaves_mont(0, leaves)  # builds the kernels
    runs = rebuild_ms(tree, leaves)
    hashes = (1 << args.depth) - 1
    print(f"warm rebuild of 2^{args.depth} leaves ({args.depth} P1 launches): "
          + ", ".join(f"{ms:.4f}" for ms in runs)
          + f" ms; {hashes / (min(runs) * 1e-3) / 1e6:.3f} M hashes/s; {chip.label()}",
          flush=True)
    rows = level_times(tree, chip)
    print_levels(rows, chip.label())
    return {"rebuild_ms": runs, "levels": rows}


if __name__ == "__main__":
    main()
