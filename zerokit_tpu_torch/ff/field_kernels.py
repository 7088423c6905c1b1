"""Wrappers of the field and curve kernels (K1-K3), with their plain versions.

Counterpart of zerokit_tpu/ff/pallas_field.py; same signatures and layouts:

  * mont_mul / mont_from (K1, csrc/field_kernels.cu `mont_mul<Field>`):
    elementwise Montgomery product on (16, *batch); from_mont is a * 1.
  * ec_op (K2, `ec_op<Curve,Op>`): RCB15 complete add (Alg 7), mixed add
    with the (0, 0) affine-infinity select (Alg 8) and doubling (Alg 9), on
    points (16, C, coords, *batch), C = 1 (G1) or 2 (G2).
  * ec_add_gather (K2, `ec_add_gather<Curve>`): the add of two AoS
    projective rows read through int32 row indices, or the identity where a
    flag says the bucket is empty, into SoA points: the MSM pass's Q_d step.
  * K3, the EC prefix scans (csrc/ec_scan.cu) on AoS point rows (16*C*coords
    words, word order (limb, comp, coord)): ec_scan_gather (`ec_scan_gather
    <Curve>`, the MSM's fine scan) reads affine table rows through a row
    index and writes inclusive prefixes from the identity; ec_scan_excl
    (`ec_scan_excl<Curve>`, the coarse scan) writes exclusive prefixes of
    projective rows, SCAN_CHUNKS threads per lane. ec_scan_rows is the JAX
    package's interface over both: prefix sums over the leading k axis of
    (k, 16*C*coords, N) limb-major rows, "mixed" (affine, inclusive) or
    "excl" (projective, exclusive).

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
launches = {"mont_mul": 0, "ec_op": 0, "ec_add_gather": 0, "ec_scan_gather": 0,
            "ec_scan_excl": 0}
# threads per block of K2 (ec_op, ec_add_gather), G1 and G2 alike, from the
# sweep in PERF.md
EC_THREADS = 64
MAX_THREADS = 256
# threads per lane of the coarse scan (K3 "excl") and threads per block of
# the fine scan (K3 "mixed"), from the sweeps in PERF.md
SCAN_CHUNKS = 64
MAX_SCAN_CHUNKS = 256
FINE_THREADS = 128

_FIELD_IDS = {"fr": 0, "fq": 1}
_OP_IDS = {"add": 0, "add_mixed": 1, "double": 2}


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


def _block(threads: Optional[int]) -> int:
    threads = EC_THREADS if threads is None else threads
    if not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"threads per block must lie in [32, {MAX_THREADS}], got {threads}")
    return threads


def _check_index(index: torch.Tensor, n_rows: int, what: str) -> None:
    """Kernels read rows at these int32 values unchecked. The check raises
    at once on the CPU and as a device-side assert on the card, so it
    never waits for the card."""
    if index.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32, got {index.dtype}")
    if index.numel():
        lo, hi = torch.aminmax(index)
        torch._assert_async((lo >= 0) & (hi < n_rows),
                            f"{what} values must lie in [0, {n_rows})")


def ec_op(
    op: str, components: int, p: torch.Tensor, q: Optional[torch.Tensor] = None,
    threads: Optional[int] = None,
) -> torch.Tensor:
    """EC kernel on (16, C, coords, *batch) int32 points.

    op in {add, add_mixed, double}; q is (16, C, 3 or 2, *batch), None for
    double. Returns (16, C, 3, *batch). threads: per block of the kernel,
    32-256 (default EC_THREADS)."""
    if op not in _OP_IDS:
        raise ValueError(f"unknown EC op {op!r}")
    batch = tuple(p.shape[3:])
    if tuple(p.shape[:3]) != (L, components, 3):
        raise ValueError(f"ec_op: p has shape {tuple(p.shape)}")
    if op != "double":
        coords = 3 if op == "add" else 2
        if q is None or tuple(q.shape) != (L, components, coords) + batch:
            raise ValueError(f"ec_op {op}: q must be (16, {components}, {coords}) + {batch}")
    threads = _block(threads)
    tensors = (p,) if op == "double" else (p, q)
    if not on_cuda(*tensors):
        return ec_op_plain(op, components, p, q)
    for t, name in zip(tensors, ("p", "q")):
        check_limbs(t, name)
    out = torch.empty_like(p)
    n = p.numel() // (L * components * 3)
    if n:
        _cuda.launch(
            "zk_ec_op", components - 1, _OP_IDS[op], p, p if q is None else q, out, n, threads
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


def ec_add_gather(components: int, fine_rows: torch.Tensor, fidx: torch.Tensor,
                  coarse_rows: torch.Tensor, cidx: torch.Tensor, empty: torch.Tensor,
                  threads: Optional[int] = None) -> torch.Tensor:
    """K2's add through row indices (the MSM pass's Q_d step): per lane i
    of fidx's shape, the identity where empty[i], else rcb_add(fine_rows
    [fidx[i]], coarse_rows[cidx[i]]).

    fine_rows, coarse_rows: (R, 16*C*3) int32 AoS projective rows, word
    order (limb, comp, coord); fidx, cidx: int32 row indices and empty:
    bool, all of one shape. Returns (16, C, 3) + that shape. threads: per
    block of the kernel, 32-256 (default EC_THREADS)."""
    _, rows = _scan_rows(components, "excl")
    for t, name in ((fine_rows, "fine_rows"), (coarse_rows, "coarse_rows")):
        if t.ndim != 2 or t.shape[1] != rows:
            raise ValueError(f"ec_add_gather: {name} must be (R, {rows}), got {tuple(t.shape)}")
    if fidx.shape != cidx.shape or empty.shape != fidx.shape:
        raise ValueError(f"ec_add_gather: fidx, cidx and empty must share one shape, got "
                         f"{tuple(fidx.shape)}, {tuple(cidx.shape)}, {tuple(empty.shape)}")
    if empty.dtype != torch.bool:
        raise TypeError(f"ec_add_gather: empty must be bool, got {empty.dtype}")
    _check_index(fidx, fine_rows.shape[0], "ec_add_gather: fidx")
    _check_index(cidx, coarse_rows.shape[0], "ec_add_gather: cidx")
    threads = _block(threads)
    if not on_cuda(fine_rows, fidx, coarse_rows, cidx, empty):
        return ec_add_gather_plain(components, fine_rows, fidx, coarse_rows, cidx, empty)
    for t, name in ((fine_rows, "fine_rows"), (coarse_rows, "coarse_rows"), (fidx, "fidx"),
                    (cidx, "cidx")):
        check_limbs(t, name)
        if name.endswith("rows") and t.data_ptr() % 16:
            raise ValueError(f"ec_add_gather: {name} must be 16-byte aligned")
    if not empty.is_contiguous():
        raise ValueError("ec_add_gather: expected a contiguous empty")
    out = torch.empty((L, components, 3) + tuple(fidx.shape), dtype=torch.int32,
                      device=fidx.device)
    if fidx.numel():
        _cuda.launch("zk_ec_add_gather", components - 1, fine_rows, fidx, coarse_rows, cidx,
                     empty, out, fidx.numel(), threads)
        launches["ec_add_gather"] += 1
    return out


def ec_add_gather_plain(components: int, fine_rows: torch.Tensor, fidx: torch.Tensor,
                        coarse_rows: torch.Tensor, cidx: torch.Tensor,
                        empty: torch.Tensor) -> torch.Tensor:
    """Plain version of ec_add_gather: two gathers into SoA, ec_op_plain
    "add", the identity where empty."""

    def soa(rows, idx):  # AoS rows at idx -> (16, C, 3, lanes)
        return (rows[idx.reshape(-1).long()].reshape(-1, L, components, 3)
                .permute(1, 2, 3, 0).contiguous())

    q = ec_op_plain("add", components, soa(fine_rows, fidx), soa(coarse_rows, cidx))
    ident = identity_points(components, q.shape[-1], q.device)
    q = torch.where(empty.reshape(-1), ident, q)
    return q.reshape((L, components, 3) + tuple(fidx.shape))


# ---------------------------------------------------------------------------
# K3: EC prefix scans
# ---------------------------------------------------------------------------


def _scan_rows(components: int, kind: str):
    in_rows = L * components * (2 if kind == "mixed" else 3)
    return in_rows, L * components * 3


def ec_scan_gather(components: int, table_rows: torch.Tensor, index: torch.Tensor,
                   threads: int = FINE_THREADS) -> torch.Tensor:
    """Fine scan (K3 "mixed") through a row index: per lane (o, b) the
    inclusive prefix sums over j of the affine rows table_rows[index[o, j, b]].

    table_rows: (R, 16*C*2) int32 AoS rows, word order (limb, comp, coord),
    (0, 0) = infinity; index: (outer, k, inner) int32 in [0, R). Returns (outer, k,
    inner, 16*C*3) projective AoS rows, from the identity, in the order of
    the sequential scan (ec_scan_rows_plain "mixed"). threads: per block
    of the kernel, 32-256 (one thread per lane)."""
    in_rows, out_rows = _scan_rows(components, "mixed")
    if table_rows.ndim != 2 or table_rows.shape[1] != in_rows:
        raise ValueError(f"ec_scan_gather: table_rows must be (R, {in_rows}), "
                         f"got {tuple(table_rows.shape)}")
    if index.ndim != 3:
        raise ValueError(f"ec_scan_gather: index must be (outer, k, inner), "
                         f"got {tuple(index.shape)}")
    _check_index(index, table_rows.shape[0], "ec_scan_gather: index")
    if not on_cuda(table_rows, index):
        return ec_scan_gather_plain(components, table_rows, index)
    check_limbs(table_rows, "table_rows")
    check_limbs(index, "index")
    if table_rows.data_ptr() % 16:
        raise ValueError("ec_scan_gather: table_rows must be 16-byte aligned")
    outer, k, inner = index.shape
    out = torch.empty(tuple(index.shape) + (out_rows,), dtype=torch.int32, device=index.device)
    if index.numel():
        _cuda.launch("zk_ec_scan_gather", components - 1, table_rows, index, out, k, inner,
                     outer * inner, threads)
        launches["ec_scan_gather"] += 1
    return out


def ec_scan_gather_plain(components: int, table_rows: torch.Tensor,
                         index: torch.Tensor) -> torch.Tensor:
    """Plain version of ec_scan_gather: a gather, then ec_scan_rows_plain."""
    in_rows, out_rows = _scan_rows(components, "mixed")
    outer, k, inner = index.shape
    rows = table_rows[index.long()].permute(1, 3, 0, 2).reshape(k, in_rows, outer * inner)
    out = ec_scan_rows_plain(components, rows, "mixed")
    return out.reshape(k, out_rows, outer, inner).permute(2, 0, 3, 1).contiguous()


def ec_scan_excl(components: int, x: torch.Tensor, chunks: int = SCAN_CHUNKS) -> torch.Tensor:
    """Coarse scan (K3 "excl"): per lane (o, b) the exclusive prefix sums
    over j of the projective rows x[o, j, b], split into `chunks` chunks per
    lane (the grouping of csrc/ec_scan.cu, followed by ec_scan_rows_plain).

    x: (outer, k, inner, 16*C*3) int32 AoS rows; each row and the inner
    axis contiguous, outer and k strided by whole rows (the MSM pass scans
    the last fine prefix of every block in place). Returns dense (outer, k,
    inner, 16*C*3) rows; step 0 holds the identity."""
    _, rows = _scan_rows(components, "excl")
    if x.ndim != 4 or x.shape[3] != rows:
        raise ValueError(f"ec_scan_excl: x must be (outer, k, inner, {rows}), got {tuple(x.shape)}")
    if not 1 <= chunks <= MAX_SCAN_CHUNKS:
        raise ValueError(f"ec_scan_excl: chunks must lie in [1, {MAX_SCAN_CHUNKS}], got {chunks}")
    if not on_cuda(x):
        return ec_scan_excl_plain(components, x, chunks)
    if x.dtype != torch.int32:
        raise TypeError(f"x: expected int32 limbs, got {x.dtype}")
    outer, k, inner, _ = x.shape
    if (x.stride(3) != 1 or x.stride(2) != rows or x.stride(1) % rows or x.stride(0) % rows
            or x.data_ptr() % 16):
        raise ValueError(f"ec_scan_excl: rows must be contiguous and 16-byte aligned along "
                         f"inner and whole rows apart along outer and k, got strides {x.stride()}")
    out = torch.empty((outer, k, inner, rows), dtype=torch.int32, device=x.device)
    if x.numel():
        _cuda.launch("zk_ec_scan_excl", components - 1, x, out, k, chunks, inner, outer * inner,
                     x.stride(0) // rows, x.stride(1) // rows)
        launches["ec_scan_excl"] += 1
    return out


def ec_scan_excl_plain(components: int, x: torch.Tensor, chunks: int = SCAN_CHUNKS) -> torch.Tensor:
    """Plain version of ec_scan_excl."""
    outer, k, inner, rows = x.shape
    x_rows = x.permute(1, 3, 0, 2).reshape(k, rows, outer * inner)
    out = ec_scan_rows_plain(components, x_rows, "excl", chunks)
    return out.reshape(k, rows, outer, inner).permute(2, 0, 3, 1).contiguous()


def ec_scan_rows(components: int, x_rows: torch.Tensor, kind: str) -> torch.Tensor:
    """EC prefix scan over the leading k axis of x_rows (k, in_rows, N)
    limb-major rows: in_rows = 16*C*2 for kind "mixed" (affine inputs,
    inclusive prefixes) and 16*C*3 for "excl" (projective inputs, exclusive
    prefixes, SCAN_CHUNKS chunks per lane). Returns (k, 16*C*3, N)
    projective prefix points. On the card it runs ec_scan_gather (an
    identity index over the rows) or ec_scan_excl."""
    if kind not in ("mixed", "excl"):
        raise ValueError(f"unknown scan kind {kind!r}")
    in_rows, _ = _scan_rows(components, kind)
    if x_rows.ndim != 3 or x_rows.shape[1] != in_rows:
        raise ValueError(f"ec_scan_rows: expected (k, {in_rows}, N), got {tuple(x_rows.shape)}")
    if not on_cuda(x_rows):
        return ec_scan_rows_plain(components, x_rows, kind)
    k, _, n = x_rows.shape
    aos = x_rows.permute(0, 2, 1).contiguous()  # (k, N, in_rows)
    if kind == "mixed":
        index = torch.arange(k * n, dtype=torch.int32, device=x_rows.device).reshape(1, k, n)
        out = ec_scan_gather(components, aos.reshape(k * n, in_rows), index)
    else:
        out = ec_scan_excl(components, aos[None])
    return out[0].permute(0, 2, 1).contiguous()


def ec_scan_rows_plain(components: int, x_rows: torch.Tensor, kind: str,
                       chunks: int = SCAN_CHUNKS) -> torch.Tensor:
    """Plain version of ec_scan_rows: "mixed" is a loop of mixed adds over
    k; "excl" follows csrc/ec_scan.cu's grouping into `chunks` chunks."""
    fq = plain_adapter(components)
    k, _, n = x_rows.shape
    if kind == "excl":
        return _scan_excl_chunked(fq, components, x_rows, chunks)
    out = torch.empty((k, L * components * 3, n), dtype=torch.int32, device=x_rows.device)
    carry = identity_points(components, n, x_rows.device)
    for j in range(k):
        carry = rcb_add_mixed(fq, carry, x_rows[j].reshape(L, components, 2, n))
        out[j] = carry.reshape(-1, n)
    return out


def _scan_excl_chunked(fq, components: int, x_rows: torch.Tensor, chunks: int) -> torch.Tensor:
    """Exclusive prefixes of (k, 16*C*3, N) projective rows, grouped as the
    kernel groups them (csrc/ec_scan.cu): chunk t holds steps
    [t*k//chunks, (t+1)*k//chunks); (1) its sum from its first row, (2) a
    Kogge-Stone scan over the chunk sums, s_t = add(s_{t-d}, s_t), (3) a
    walk of each chunk from the sum of the chunks before it. Each step runs
    on all chunks at once."""
    k, rows, n = x_rows.shape
    dev = x_rows.device
    pts = x_rows.reshape(k, L, components, 3, n)
    lo = [t * k // chunks for t in range(chunks)]
    length = [(t + 1) * k // chunks - lo[t] for t in range(chunks)]

    def flat(p):  # (L, C, 3, T', N) -> (L, C, 3, T'*N)
        return p.reshape(L, components, 3, -1)

    def rows_at(ts, step):  # x rows of chunks ts at their step, (L, C, 3, T', N)
        return pts[torch.tensor([lo[t] + step for t in ts], device=dev)].permute(1, 2, 3, 0, 4)

    def chunks_with(step):
        return [t for t in range(chunks) if step < length[t]]

    # 1. chunk sums; an empty chunk holds the identity
    s = identity_points(components, chunks * n, dev).reshape(L, components, 3, chunks, n)
    for step in range(max(length)):
        ts = chunks_with(step)
        x = rows_at(ts, step)
        if step:
            x = rcb_add(fq, flat(s[:, :, :, ts]), flat(x)).reshape(x.shape)
        s[:, :, :, ts] = x
    # 2. Kogge-Stone inclusive scan over the chunk axis
    d = 1
    while d < chunks:
        summed = rcb_add(fq, flat(s[:, :, :, : chunks - d]), flat(s[:, :, :, d:]))
        s = torch.cat([s[:, :, :, :d], summed.reshape(L, components, 3, chunks - d, n)], dim=3)
        d *= 2
    # 3. walk each chunk from its offset
    acc = torch.cat([identity_points(components, n, dev)[:, :, :, None], s[:, :, :, :-1]], dim=3)
    out = torch.empty((k, rows, n), dtype=torch.int32, device=dev)
    for step in range(max(length)):
        ts = chunks_with(step)
        idx = torch.tensor([lo[t] + step for t in ts], device=dev)
        out[idx] = acc[:, :, :, ts].permute(3, 0, 1, 2, 4).reshape(len(ts), rows, n)
        more = [t for t in ts if step + 1 < length[t]]
        if more:
            summed = rcb_add(fq, flat(acc[:, :, :, more]), flat(rows_at(more, step)))
            acc[:, :, :, more] = summed.reshape(L, components, 3, len(more), n)
    return out
