"""Wrappers of the witness evaluator's kernels (W1, W2), with their plain versions.

Both run on the evaluator's slot buffer, which lies lane-major: a
(lanes, n_slots, 8) int32 tensor whose last axis holds a value's eight
32-bit little-endian words (Montgomery form, canonical), so a kernel reads
each operand with one 32-byte load. The public assignment keeps the
package's (16, n, B) 16-bit-limb layout; limbs_to_words / words_to_limbs
convert.

  * witness_steps (W1, csrc/witness_kernels.cu `witness_steps<Rich>`):
    runs all the steps of one segment in one launch, in place. Replaces the
    JAX package's lax.scan over the steps (zerokit_tpu/circuit/
    witness_eval.py `_scan_fn`). sched is the segment's (steps, W, 4) int32
    schedule (op code, ia, ib, ic of each node); step t writes its W nodes
    into slots write_start + t*W + w. A NOP node writes nothing.
  * witness_div (W2, `witness_div`): every Div of one group, a * b^(p-2)
    with inv(0) = 0, in place (the JAX package's `_div_apply`).

The wrappers check shapes, types, the write window and every slot index
(field_kernels._check_index: a device-side assert on the card, no wait for
the card).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
`*_plain` version, which runs on any device and launches no kernel (its
products are ff/field.mont_mul_sos through FrPlain). The plain step is the
JAX package's `_step_candidates` on (16, W, B) limbs: each op's candidate
for the step's nodes, selected by op code; a NOP selects its operand a.
`launches` counts kernel launches per wrapper and nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import LIMB_BITS, NUM_LIMBS, R
from ..ff import _cuda
from ..ff.field import FrPlain, _carry, _const_like, int_to_limbs
from ..ff.field_kernels import _check_index, check_limbs, on_cuda
from . import witness_eval as we

L = NUM_LIMBS
launches = {"witness_steps": 0, "witness_div": 0}
DIV_THREADS = 128

_HALF_LIMBS = int_to_limbs((R - 1) // 2)


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


def limbs_to_words(x: torch.Tensor) -> torch.Tensor:
    """(16, n, B) int32 16-bit limbs -> (B, n, 8) int32 32-bit words."""
    w = x[0::2].to(torch.int64) | (x[1::2].to(torch.int64) << LIMB_BITS)
    w = w - ((w >> 31) << 32)  # the int32 of the same bits
    return w.to(torch.int32).permute(2, 1, 0).contiguous()


def words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(B, n, 8) int32 32-bit words -> (16, n, B) int32 16-bit limbs."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([u & 0xFFFF, u >> LIMB_BITS], dim=-1).reshape(w.shape[:2] + (L,))
    return limbs.to(torch.int32).permute(2, 1, 0).contiguous()


def _check_buffer(buf: torch.Tensor) -> None:
    check_limbs(buf, "buf")
    if buf.ndim != 3 or buf.shape[2] != 8:
        raise ValueError(f"slot buffer must be (lanes, n_slots, 8), got {tuple(buf.shape)}")


# ---------------------------------------------------------------------------
# The step semantics, plain (zerokit_tpu/circuit/witness_eval.py:307-392)
# ---------------------------------------------------------------------------


def _signed_lt(a_canon, b_canon):
    """Signed a < b (reference graph.rs:456-466): the negative range lies
    above (p-1)/2. Inputs canonical limbs."""
    half = _const_like(_HALF_LIMBS, a_canon, torch.int64)
    a64, b64 = a_canon.to(torch.int64), b_canon.to(torch.int64)
    a_neg = _carry(half - a64)[1] < 0  # borrow => half < a => a negative
    b_neg = _carry(half - b64)[1] < 0
    raw_lt = _carry(a64 - b64)[1] < 0
    # (a_neg, b_neg): (F,F)->raw, (T,F)->True, (F,T)->False, (T,T)->raw
    return torch.where(a_neg == b_neg, raw_lt, a_neg)


def _bool_to_mont(flag, like):
    return torch.where(flag[None], FrPlain.one(like), torch.zeros_like(like))


def _dynamic_shr(a_canon, b_canon):
    """Barrel shifter: a >> b with Shr clamping semantics (graph.rs:328-363):
    0 when b >= 254 as an integer."""
    shift = b_canon[0]
    big = (b_canon[1:] != 0).any(dim=0) | (b_canon[0] >= 254)
    v = a_canon
    for k in range(8):  # shifts up to 255 in powers of two
        bit = (shift >> k) & 1
        v = torch.where(bit[None] != 0, FrPlain.canon_shift_right_const(v, 1 << k), v)
    return torch.where(big[None], torch.zeros_like(v), v)


def _bitwise_fix(d):
    """Conditionally subtract p once when d > p (graph.rs:365-414); d = p
    stays p, as in the JAX package."""
    diff, carry = _carry(d.to(torch.int64) - _const_like(FrPlain.spec.p_limbs, d, torch.int64))
    gt = (carry == 0) & (d != _const_like(FrPlain.spec.p_limbs, d)).any(dim=0)
    return torch.where(gt[None], diff.to(torch.int32), d)


def _step_candidates(a, b, c, codes):
    """Each op's result for one gathered step, for the op codes in `codes`
    (the JAX package computes all N_LEAN or N_RICH of them). a/b/c:
    (16, W, B) Montgomery. Returns {code: (16, W, B)}."""
    f = FrPlain
    cands = {}
    a_zero, b_zero = f.is_zero(a), f.is_zero(b)
    for code in codes:
        if code == we.F_NOP:
            cands[code] = a
        elif code == we.F_MUL:
            cands[code] = f.mul(a, b)
        elif code == we.F_ADD:
            cands[code] = f.add(a, b)
        elif code == we.F_SUB:
            cands[code] = f.sub(a, b)
        elif code == we.F_NEG:
            cands[code] = f.neg(a)
        elif code == we.F_EQ:
            cands[code] = _bool_to_mont(f.eq(a, b), a)
        elif code == we.F_NEQ:
            cands[code] = _bool_to_mont(~f.eq(a, b), a)
        elif code == we.F_LAND:
            cands[code] = _bool_to_mont(~a_zero & ~b_zero, a)
        elif code == we.F_LOR:
            cands[code] = _bool_to_mont(~a_zero | ~b_zero, a)
        elif code == we.F_TERN:
            cands[code] = torch.where(a_zero[None], c, b)
    rich = [code for code in codes if code >= we.N_LEAN]
    if rich:
        ac, bc = f.from_mont(a), f.from_mont(b)
        for code in rich:
            if code == we.F_SHR:
                cands[code] = f.to_mont(_dynamic_shr(ac, bc))
            elif code == we.F_BAND:
                cands[code] = f.to_mont(_bitwise_fix(ac & bc))
            elif code == we.F_BOR:
                cands[code] = f.to_mont(_bitwise_fix(ac | bc))
            elif code == we.F_BXOR:
                cands[code] = f.to_mont(_bitwise_fix(ac ^ bc))
            elif code == we.F_LT:
                cands[code] = _bool_to_mont(_signed_lt(ac, bc), a)
            elif code == we.F_GT:
                cands[code] = _bool_to_mont(_signed_lt(bc, ac), a)
            elif code == we.F_LEQ:
                cands[code] = _bool_to_mont(~_signed_lt(bc, ac), a)
            elif code == we.F_GEQ:
                cands[code] = _bool_to_mont(~_signed_lt(ac, bc), a)
    unknown = set(codes) - set(cands)
    if unknown:
        raise ValueError(f"op codes {sorted(unknown)} are not in the step's op set")
    return cands


def step_plain(ops: np.ndarray, a, b, c, rich: bool):
    """One step's W results: each node's op on its operands (16, W, B)."""
    top = we.N_RICH if rich else we.N_LEAN
    codes = sorted(set(int(op) for op in ops))
    if codes[-1] >= top or codes[0] < 0:
        raise ValueError(f"op codes {codes} outside the {'rich' if rich else 'lean'} set")
    cands = _step_candidates(a, b, c, codes)
    which = torch.as_tensor(np.asarray(ops), device=a.device)[None, :, None]
    res = cands[codes[0]]
    for code in codes[1:]:
        res = torch.where(which == code, cands[code], res)
    return res


# ---------------------------------------------------------------------------
# W1: one segment's steps
# ---------------------------------------------------------------------------


def witness_steps(buf: torch.Tensor, sched: torch.Tensor, write_start: int,
                  rich: bool) -> torch.Tensor:
    """Runs the steps of sched (steps, W, 4) on the slot buffer buf
    (lanes, n_slots, 8) in place; returns buf."""
    _check_index(sched[..., 1:], buf.shape[1], "witness_steps: sched slots")
    if not on_cuda(buf, sched):
        return witness_steps_plain(buf, sched, write_start, rich)
    _check_buffer(buf)
    check_limbs(sched, "sched")
    lanes, n_slots, _ = buf.shape
    steps = sched.shape[0]
    if sched.shape != (steps, we.W, 4):
        raise ValueError(f"sched must be (steps, {we.W}, 4), got {tuple(sched.shape)}")
    if write_start < 1 or write_start + steps * we.W > n_slots:
        raise ValueError(f"steps write slots [{write_start}, {write_start + steps * we.W}) "
                         f"outside the buffer's {n_slots}")
    if steps and lanes:
        _cuda.launch("zk_witness_steps", int(rich), buf, sched, steps, write_start, n_slots,
                     lanes)
        launches["witness_steps"] += 1
    return buf


def witness_steps_plain(buf: torch.Tensor, sched: torch.Tensor, write_start: int,
                        rich: bool) -> torch.Tensor:
    """Plain version of witness_steps, on the JAX package's (16, n_slots, B)
    limbs: per step, gather the operand rows, select each node's candidate,
    write the step's W-slot window."""
    x = words_to_limbs(buf)
    s = sched.cpu().numpy()
    idx = torch.from_numpy(s[:, :, 1:].astype(np.int64)).to(buf.device)
    for t in range(s.shape[0]):
        a, b, c = (x[:, idx[t, :, j]] for j in range(3))
        start = write_start + t * we.W
        x[:, start:start + we.W] = step_plain(s[t, :, 0], a, b, c, rich)
    buf.copy_(limbs_to_words(x))
    return buf


# ---------------------------------------------------------------------------
# W2: one group of Divs
# ---------------------------------------------------------------------------


def witness_div(buf: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
    """buf[:, out] = buf[:, ia] / buf[:, ib] (0 where the divisor is 0), in
    place on the slot buffer; ia, ib, out (n_div,) int32. Returns buf."""
    for t, name in ((ia, "ia"), (ib, "ib"), (out, "out")):
        _check_index(t, buf.shape[1], f"witness_div: {name}")
    if not on_cuda(buf, ia, ib, out):
        return witness_div_plain(buf, ia, ib, out)
    _check_buffer(buf)
    lanes, n_slots, _ = buf.shape
    n_div = ia.numel()
    if ia.shape != (n_div,) or ib.shape != (n_div,) or out.shape != (n_div,):
        raise ValueError("ia, ib and out must be (n_div,) each")
    for t, name in ((ia, "ia"), (ib, "ib"), (out, "out")):
        check_limbs(t, name)
    if n_div and lanes:
        _cuda.launch("zk_witness_div", buf, ia, ib, out, n_div, n_slots, lanes, DIV_THREADS)
        launches["witness_div"] += 1
    return buf


def witness_div_plain(buf: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
                      out: torch.Tensor) -> torch.Tensor:
    """Plain version of witness_div (the JAX package's _div_apply:
    a * inv(b), Fermat inversion with inv(0) = 0)."""
    x = words_to_limbs(buf)
    a = x[:, ia.long()]
    b = x[:, ib.long()]
    x[:, out.long()] = FrPlain.mul(a, FrPlain.inv(b))
    buf.copy_(limbs_to_words(x))
    return buf
