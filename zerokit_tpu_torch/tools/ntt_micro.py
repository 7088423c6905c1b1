"""Microbenchmark: the cost of one NTT butterfly stage on the card.

Counterpart of tools/ntt_micro.py, on the port's (16, B, n) layout (domain
minor) with the same defaults, n = 8192 and B = 64 (32 MB an array). The
variants:

  mul_flat   K1 (FrField.mul) on (16, n*B)                   (the product floor)
  addsub     FrField.add / sub of adjacent pairs             (no product; torch ops)
  mul5d      K1 on the hi half of the (16, B, n/128, 2, 64) view, by 64 twiddles
             (n/2 of them below n = 128)
  stage m    K4 (ff/ntt_kernels.ntt_stage: ntt_cross's r = 1 call), one DIT
             stage at half-size m, for m = 1, 8, 64, 512 and n/2, on
             twiddles 5^j as the JAX tool's
  tail       K5 (ntt_tail), the DIF stages m < P in P = 1024-point chunks:
             on the card the stages below m = 1024 run there, not in K4

Each variant's kernel call is held against its plain version on the same
tensors (max_abs_err, integers), then timed L2-cold (runtime/profiling.
l2_cold: rotating copies of its inputs, the rotation's outputs allocated
before the timing; the same tensors back to back beside) by device_ms,
beside its plain version's time (one call) and its bound (runtime/
profiling.kernel_bound; mul_flat's a squaring's, one array read; addsub's
its bytes) and the share of it.

Run on the card: python -m zerokit_tpu_torch.tools.ntt_micro [n] [B]
"""

from __future__ import annotations

import sys
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..constants import R
from ..ff import ntt_kernels as nk
from ..ff.field import FR, FrField, FrPlain

STAGE_MS = (1, 8, 64, 512)  # and n/2
TAIL_P = nk.TAIL


class Variant(NamedTuple):
    name: str
    kernel: Callable  # kernel(*inputs) -> tensor; the kernels on CUDA tensors
    plain: Callable  # plain(*inputs): the plain versions on any device
    inputs: tuple
    bound: Optional[tuple]  # (kernel_work key, shape), None for addsub


def make_input(n: int, batch: int, device, seed: int = 0) -> torch.Tensor:
    """Seeded (16, B, n) limbs, every value < 2^252 < r."""
    x = np.random.default_rng(seed).integers(0, 1 << 16, size=(16, batch, n), dtype=np.uint64)
    x[15] &= 0xFFF
    return torch.from_numpy(x.astype(np.int32)).to(device)


def powers_of_5(count: int) -> torch.Tensor:
    """(16, count) Montgomery limbs of 5^j, the JAX tool's twiddles."""
    return FR.encode([pow(5, j, R) for j in range(count)])


def _pairs(x: torch.Tensor):
    t = x.reshape(16, x.shape[1], -1, 2)
    return t[..., 0], t[..., 1]


def _addsub(field, x):
    lo, hi = _pairs(x)
    return torch.stack([field.add(lo, hi), field.sub(lo, hi)], dim=3).reshape(x.shape)


def _mul5d(field, x, tw):
    h = tw.shape[1]
    t = x.reshape(16, x.shape[1], -1, 2, h)
    hi = t[:, :, :, 1].contiguous()
    return field.mul(hi, tw.reshape(16, 1, 1, h).expand(hi.shape).contiguous())


def variants(x: torch.Tensor) -> List[Variant]:
    """The variants on x (16, B, n), n a power of two >= 2."""
    _, batch, n = x.shape
    dev = x.device
    tw = powers_of_5(n // 2).to(dev)
    flat = x.reshape(16, -1)
    out = [
        Variant("mul_flat", lambda f: FrField.mul(f, f), lambda f: FrPlain.mul(f, f), (flat,),
                ("K1", {"lanes": n * batch, "square": True})),
        Variant("addsub", lambda a: _addsub(FrField, a), lambda a: _addsub(FrPlain, a), (x,),
                None),
        Variant("mul5d", lambda a, w: _mul5d(FrField, a, w), lambda a, w: _mul5d(FrPlain, a, w),
                (x, tw[:, :min(64, n // 2)].contiguous()), ("K1", {"lanes": n * batch // 2})),
    ]
    for m in sorted({m for m in STAGE_MS + (n // 2,) if 2 * m <= n}):
        out.append(Variant(
            f"stage m={m}",
            lambda a, w, m=m: nk.ntt_stage(a, w, m, "dit"),
            lambda a, w, m=m: nk.ntt_stage_plain(a, w, m, "dit"),
            (x, tw[:, :m].contiguous()), ("K4", {"rows": batch, "n": n, "m": m})))
    tail_tw = nk._tail_tw(n, False, str(dev), TAIL_P)
    out.append(Variant(
        f"tail P={nk.tail_size(n, TAIL_P)}",
        lambda a, t: nk.ntt_tail(a, t, None, "dif", TAIL_P),
        lambda a, t: nk.ntt_tail_plain(a, t, None, "dif", TAIL_P),
        (x, tail_tw), ("K5", {"rows": batch, "n": n, "p": TAIL_P})))
    return out


def bound_of(v: Variant, chip) -> tuple:
    """(ms, resource) of the variant's bound on the card `chip`."""
    from ..runtime.profiling import kernel_bound

    if v.bound is None:  # addsub: x read, the result written
        nbytes = 2 * v.inputs[0].numel() * v.inputs[0].element_size()
        return nbytes / chip.hbm_bytes_per_sec * 1e3, "hbm"
    sec, res = kernel_bound(v.bound[0], chip, **v.bound[1])
    return sec * 1e3, res


def run(n: int = 8192, batch: int = 64, device="cuda", chip=None, log=print) -> List[dict]:
    """Every variant on the card: its kernel call against its plain version
    on the same tensors (max_abs_err), then its L2-cold and L2-warm times
    and its bound. Returns one dict a variant."""
    from ..runtime.profiling import ChipSpec, device_ms, host_call, l2_cold

    chip = chip or ChipSpec.from_device(torch.cuda.current_device())
    x = make_input(n, batch, device)
    log(f"n={n} B={batch}  ({x.numel() * 4 / 1e6:.0f} MB/array); {chip.label()}")
    rows = []
    for v in variants(x):
        got, enqueue_s = host_call(lambda: v.kernel(*v.inputs))
        want, plain_s = host_call(lambda: v.plain(*v.inputs))
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        warm = device_ms(lambda: v.kernel(*v.inputs), 10, enqueue_s)
        cold = device_ms(l2_cold(v.kernel, *v.inputs), 10)
        plain = device_ms(lambda: v.plain(*v.inputs), 1, plain_s)
        bound, res = bound_of(v, chip)
        rows.append({"name": v.name, "max_abs_err": err, "ms": cold, "warm_ms": warm,
                     "plain_ms": plain, "bound_ms": bound, "bound_by": res,
                     "share": bound / cold})
        log(f"{v.name:12s}: {cold:8.4f} ms L2-cold ({warm:.4f} L2-warm), bound {bound:.4f} ms "
            f"({res}), share {bound / cold:.1%}; plain {plain:.2f} ms; max_abs_err {err}")
    return rows


def main(argv=None) -> List[dict]:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 8192
    batch = int(argv[1]) if len(argv) > 1 else 64
    rows = run(n, batch)
    bad = [r["name"] for r in rows if r["max_abs_err"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    return rows


if __name__ == "__main__":
    main()
