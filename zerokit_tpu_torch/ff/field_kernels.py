"""Wrappers of the field and curve kernels (K1-K3), with their plain versions.

Counterpart of zerokit_tpu/ff/pallas_field.py; same signatures and layouts:

  * mont_mul / mont_from (K1, csrc/field_kernels.cu `mont_mul<Field>`):
    elementwise Montgomery product on (16, *batch); from_mont is a * 1.
  * ec_op (K2, `ec_op<Curve,Op>`): RCB15 complete add (Alg 7), mixed add
    with the (0, 0) affine-infinity select (Alg 8) and doubling (Alg 9), on
    points (16, C, coords, *batch), C = 1 (G1) or 2 (G2).
  * ec_scan_rows (K3, `ec_scan<Curve,Kind>`): prefix sums over the leading
    k axis of (k, 16*C*coords, N) limb-major rows (row (i*C + m)*coords + c
    holds 16-bit limb i of component m of coordinate c). "mixed": inclusive
    prefixes of affine rows from the identity; "excl": exclusive prefixes of
    projective rows.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
`*_plain` version beside each wrapper. The plain versions run on any device
and never launch a kernel (their products are ff/field.mont_mul_sos), so
they can also be held against the kernels on the card. `launches` counts
kernel launches per wrapper and nothing else.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..constants import NUM_LIMBS
from . import _cuda
from .field import SPECS, mont_mul_sos
from .fq2 import Fq2PlainAdapter, FqPlainAdapter

L = NUM_LIMBS
launches = {"mont_mul": 0, "ec_op": 0, "ec_scan_rows": 0}

_FIELD_IDS = {"fr": 0, "fq": 1}
_OP_IDS = {"add": 0, "add_mixed": 1, "double": 2}
_KIND_IDS = {"mixed": 0, "excl": 1}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def plain_adapter(components: int):
    return FqPlainAdapter if components == 1 else Fq2PlainAdapter


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"tensors must all lie on the CPU or on one CUDA device, got {kinds}")


def check_limbs(t: torch.Tensor, name: str) -> None:
    """What a kernel reads: contiguous int32 limbs (shapes are checked by
    each wrapper)."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


# ---------------------------------------------------------------------------
# K1: Montgomery multiply
# ---------------------------------------------------------------------------


def mont_mul(spec_name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery multiply on (16, *batch) int32 limbs (< p)."""
    if a.shape != b.shape or a.shape[0] != L:
        raise ValueError(f"mont_mul: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if not on_cuda(a, b):
        return mont_mul_plain(spec_name, a, b)
    check_limbs(a, "a")
    check_limbs(b, "b")
    out = torch.empty_like(a)
    n = a.numel() // L
    if n:
        _cuda.launch("zk_mont_mul", _FIELD_IDS[spec_name], a, b, out, n)
        launches["mont_mul"] += 1
    return out


def mont_mul_plain(spec_name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of mont_mul."""
    return mont_mul_sos(SPECS[spec_name], a, b)


def _one_canon(a: torch.Tensor) -> torch.Tensor:
    one = torch.zeros_like(a)
    one[0] = 1
    return one


def mont_from(spec_name: str, a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> canonical on (16, *batch): a * 1 * R^-1 through K1."""
    return mont_mul(spec_name, a, _one_canon(a))


def mont_from_plain(spec_name: str, a: torch.Tensor) -> torch.Tensor:
    return mont_mul_plain(spec_name, a, _one_canon(a))


# ---------------------------------------------------------------------------
# RCB15 group laws, plain (a = 0; points (16, C, 3, *b), affine (16, C, 2, *b))
# ---------------------------------------------------------------------------


def rcb_add(fq, p, q):
    """Complete projective add (Alg 7)."""
    x1, y1, z1 = p[:, :, 0], p[:, :, 1], p[:, :, 2]
    x2, y2, z2 = q[:, :, 0], q[:, :, 1], q[:, :, 2]
    t0 = fq.mul(x1, x2)
    t1 = fq.mul(y1, y2)
    t2 = fq.mul(z1, z2)
    t3 = fq.sub(fq.mul(fq.add(x1, y1), fq.add(x2, y2)), fq.add(t0, t1))
    t4 = fq.sub(fq.mul(fq.add(y1, z1), fq.add(y2, z2)), fq.add(t1, t2))
    ty = fq.sub(fq.mul(fq.add(x1, z1), fq.add(x2, z2)), fq.add(t0, t2))
    t0 = fq.add(fq.add(t0, t0), t0)
    t2 = fq.b3_mul(t2)
    z3 = fq.add(t1, t2)
    t1 = fq.sub(t1, t2)
    ty = fq.b3_mul(ty)
    x3 = fq.sub(fq.mul(t3, t1), fq.mul(t4, ty))
    y3 = fq.add(fq.mul(t1, z3), fq.mul(ty, t0))
    z3 = fq.add(fq.mul(z3, t4), fq.mul(t0, t3))
    return torch.stack([x3, y3, z3], dim=2)


def rcb_add_mixed(fq, p, q_aff):
    """Mixed add (Alg 8) + select for the affine (0, 0) infinity, on
    (16, C, coords, N). Lanes whose q is the sentinel return p unchanged, so
    only the other lanes are computed."""
    q_inf = fq.is_zero(q_aff[:, :, 0]) & fq.is_zero(q_aff[:, :, 1])
    if bool(q_inf.any()):
        out = p.clone()
        live = (~q_inf).nonzero().squeeze(1)
        if live.numel():
            out[..., live] = _rcb_add_mixed_full(fq, p[..., live], q_aff[..., live])
        return out
    return _rcb_add_mixed_full(fq, p, q_aff)


def _rcb_add_mixed_full(fq, p, q_aff):
    x1, y1, z1 = p[:, :, 0], p[:, :, 1], p[:, :, 2]
    x2, y2 = q_aff[:, :, 0], q_aff[:, :, 1]
    t0 = fq.mul(x1, x2)
    t1 = fq.mul(y1, y2)
    t3 = fq.sub(fq.mul(fq.add(x1, y1), fq.add(x2, y2)), fq.add(t0, t1))
    t4 = fq.add(fq.mul(x2, z1), x1)
    t5 = fq.add(fq.mul(y2, z1), y1)
    t0 = fq.add(fq.add(t0, t0), t0)
    t2 = fq.b3_mul(z1)
    z3 = fq.add(t1, t2)
    t1 = fq.sub(t1, t2)
    ty = fq.b3_mul(t4)
    x3 = fq.sub(fq.mul(t3, t1), fq.mul(t5, ty))
    y3 = fq.add(fq.mul(t1, z3), fq.mul(ty, t0))
    z3 = fq.add(fq.mul(z3, t5), fq.mul(t0, t3))
    return torch.stack([x3, y3, z3], dim=2)


def rcb_double(fq, p):
    """Doubling (Alg 9)."""
    x, y, z = p[:, :, 0], p[:, :, 1], p[:, :, 2]
    t0 = fq.sqr(y)
    z3 = fq.add(t0, t0)
    z3 = fq.add(z3, z3)
    z3 = fq.add(z3, z3)
    t1 = fq.mul(y, z)
    t2 = fq.b3_mul(fq.sqr(z))
    x3 = fq.mul(t2, z3)
    y3 = fq.add(t0, t2)
    z3 = fq.mul(t1, z3)
    t1 = fq.add(t2, t2)
    t2 = fq.add(t1, t2)
    t0 = fq.sub(t0, t2)
    y3 = fq.add(fq.mul(t0, y3), x3)
    t1 = fq.mul(x, y)
    x3 = fq.mul(t0, t1)
    x3 = fq.add(x3, x3)
    return torch.stack([x3, y3, z3], dim=2)


def identity_points(components: int, n: int, device) -> torch.Tensor:
    """(16, C, 3, n) copies of the identity (0, 1, 0), one in Montgomery form."""
    out = torch.zeros((L, components, 3, n), dtype=torch.int32, device=device)
    one = torch.tensor(SPECS["fq"].one_mont.astype("int32"), device=device)
    out[:, 0, 1, :] = one[:, None]
    return out


# ---------------------------------------------------------------------------
# K2: EC group-law kernels
# ---------------------------------------------------------------------------


def ec_op(
    op: str, components: int, p: torch.Tensor, q: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """EC kernel on (16, C, coords, *batch) int32 points.

    op in {add, add_mixed, double}; q is (16, C, 3 or 2, *batch), None for
    double. Returns (16, C, 3, *batch)."""
    if op not in _OP_IDS:
        raise ValueError(f"unknown EC op {op!r}")
    batch = tuple(p.shape[3:])
    if tuple(p.shape[:3]) != (L, components, 3):
        raise ValueError(f"ec_op: p has shape {tuple(p.shape)}")
    if op != "double":
        coords = 3 if op == "add" else 2
        if q is None or tuple(q.shape) != (L, components, coords) + batch:
            raise ValueError(f"ec_op {op}: q must be (16, {components}, {coords}) + {batch}")
    tensors = (p,) if op == "double" else (p, q)
    if not on_cuda(*tensors):
        return ec_op_plain(op, components, p, q)
    for t, name in zip(tensors, ("p", "q")):
        check_limbs(t, name)
    out = torch.empty_like(p)
    n = p.numel() // (L * components * 3)
    if n:
        _cuda.launch(
            "zk_ec_op", components - 1, _OP_IDS[op], p, p if q is None else q, out, n
        )
        launches["ec_op"] += 1
    return out


def ec_op_plain(op: str, components: int, p: torch.Tensor, q=None) -> torch.Tensor:
    """Plain version of ec_op."""
    fq = plain_adapter(components)
    batch = tuple(p.shape[3:])
    p2 = p.reshape(L, components, 3, -1)
    if op == "add":
        out = rcb_add(fq, p2, q.reshape(L, components, 3, -1))
    elif op == "add_mixed":
        out = rcb_add_mixed(fq, p2, q.reshape(L, components, 2, -1))
    else:
        out = rcb_double(fq, p2)
    return out.reshape((L, components, 3) + batch)


# ---------------------------------------------------------------------------
# K3: EC prefix scans
# ---------------------------------------------------------------------------


def _scan_rows(components: int, kind: str):
    in_rows = L * components * (2 if kind == "mixed" else 3)
    return in_rows, L * components * 3


def ec_scan_rows(components: int, x_rows: torch.Tensor, kind: str) -> torch.Tensor:
    """EC prefix scan over the leading k axis of x_rows (k, in_rows, N)
    limb-major rows: in_rows = 16*C*2 for kind "mixed" (affine inputs,
    inclusive prefixes) and 16*C*3 for "excl" (projective inputs, exclusive
    prefixes). Returns (k, 16*C*3, N) projective prefix points."""
    if kind not in _KIND_IDS:
        raise ValueError(f"unknown scan kind {kind!r}")
    in_rows, out_rows = _scan_rows(components, kind)
    if x_rows.ndim != 3 or x_rows.shape[1] != in_rows:
        raise ValueError(f"ec_scan_rows: expected (k, {in_rows}, N), got {tuple(x_rows.shape)}")
    if not on_cuda(x_rows):
        return ec_scan_rows_plain(components, x_rows, kind)
    check_limbs(x_rows, "x_rows")
    k, _, n = x_rows.shape
    out = torch.empty((k, out_rows, n), dtype=torch.int32, device=x_rows.device)
    if k and n:
        _cuda.launch("zk_ec_scan", components - 1, _KIND_IDS[kind], x_rows, out, k, n)
        launches["ec_scan_rows"] += 1
    return out


def ec_scan_rows_plain(components: int, x_rows: torch.Tensor, kind: str) -> torch.Tensor:
    """Plain version of ec_scan_rows: a loop of group-law steps."""
    fq = plain_adapter(components)
    k, _, n = x_rows.shape
    coords = 2 if kind == "mixed" else 3
    out = torch.empty((k, L * components * 3, n), dtype=torch.int32, device=x_rows.device)
    carry = identity_points(components, n, x_rows.device)
    for j in range(k):
        x = x_rows[j].reshape(L, components, coords, n)
        if kind == "mixed":
            carry = rcb_add_mixed(fq, carry, x)
            out[j] = carry.reshape(-1, n)
        else:
            out[j] = carry.reshape(-1, n)
            carry = rcb_add(fq, carry, x)
    return out
