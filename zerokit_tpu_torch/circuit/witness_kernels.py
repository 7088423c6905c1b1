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
    witness_eval.py `_scan_fn`). It takes the segment's slot-file plan
    (circuit/witness_plan.py): records (steps, W, 4) int32, the preload
    slots and the register file's size, with the graph's constant table.
    It writes to the slot buffer only the values the plan
    marks (signals, W2's operands, later segments' values).
  * witness_div (W2, `witness_div`): every Div of one group, a * b^-1
    with inv(0) = 0, in place (the JAX package's `_div_apply`). The
    kernel inverts by constant-time safegcd; its plain version keeps the
    JAX package's Fermat power, so the two are independent forms.

The wrappers check shapes, types, and every slot index and reference
(field_kernels._check_index and W1's record check: device-side asserts on
the card, no wait for the card); W1's wrapper raises when the plan's
shared memory exceeds the card's (witness_plan.SlotFileTooLarge).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
`*_plain` version, which runs on any device and launches no kernel (its
products are ff/field.mont_mul_sos through FrPlain). The plain step is the
JAX package's `_step_candidates` on (16, nodes, B) limbs: each op's
candidate for the step's nodes, selected by op code.
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
from . import witness_plan as wp

L = NUM_LIMBS
launches = {"witness_steps": 0, "witness_div": 0}
DIV_THREADS = 128
LANES_PER_BLOCK = 2  # W1's lanes a block, csrc/witness_kernels.cu kLanes (PERF.md)
MAX_SMEM = 232448  # dynamic shared memory a block can have (H100)

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


def _check_steps(buf, records, preload, n_regs, consts) -> None:
    """Every op code, reference, preload slot and global slot of a
    segment's records inside what it names (device-side asserts on the
    card, no wait)."""
    n_slots = buf.shape[1]
    n_refs = consts.shape[0] + preload.numel() + n_regs
    if n_refs > wp.MAX_REFS:
        raise ValueError(f"{n_refs} shared values exceed W1's 16-bit references")
    _check_index(preload, n_slots, "witness_steps: preload slots")
    if not records.numel():
        return
    r = records.to(torch.int64) & 0xFFFFFFFF
    op, dst = r[..., 0] & 0xFFFF, r[..., 0] >> 16
    live = op != we.F_NOP
    refs = torch.stack([r[..., 1] & 0xFFFF, r[..., 1] >> 16, r[..., 2]], -1)
    base = consts.shape[0] + preload.numel()
    bad = ((op >= we.N_RICH)
           | (live & ((refs.amax(-1) >= n_refs)
                      | ((dst != wp.NO_REG) & ((dst < base) | (dst >= n_refs)))))
           | (records[..., 3] < -1) | (records[..., 3] >= n_slots))
    torch._assert_async(~bad.any(), "witness_steps: a record names a value outside the "
                        "slot file or the slot buffer")


def steps_smem_bytes(n_pre: int, n_regs: int, n_consts: int) -> int:
    """W1's dynamic shared memory a block, the layout of csrc/
    witness_kernels.cu: the schedule ring, the constant table, and each of
    the block's LANES_PER_BLOCK lanes' preload area and registers."""
    words = (wp.RING_STEPS * we.W * wp.RECORD_WORDS + n_consts * wp.SLOT_WORDS
             + LANES_PER_BLOCK * (n_pre + n_regs) * wp.SLOT_WORDS)
    return 4 * words


def witness_steps(buf: torch.Tensor, records: torch.Tensor, preload: torch.Tensor, n_regs: int,
                  consts: torch.Tensor, rich: bool) -> torch.Tensor:
    """Runs one segment's steps (circuit/witness_plan: records (steps, W, 4),
    the preload slots, the register file's size) on the slot buffer buf
    (lanes, n_slots, 8) in place, with the constant table consts (n_consts,
    8) int32 words; returns buf."""
    if not on_cuda(buf, records, preload, consts):
        _check_steps(buf, records, preload, n_regs, consts)
        return witness_steps_plain(buf, records, preload, n_regs, consts, rich)
    _check_buffer(buf)
    for t, name in ((records, "records"), (preload, "preload"), (consts, "consts")):
        check_limbs(t, name)
    lanes, n_slots, _ = buf.shape
    steps = records.shape[0]
    if records.shape != (steps, we.W, wp.RECORD_WORDS):
        raise ValueError(f"records must be (steps, {we.W}, {wp.RECORD_WORDS}), got "
                         f"{tuple(records.shape)}")
    if consts.ndim != 2 or consts.shape[1] != 8:
        raise ValueError("consts must be (n, 8) words")
    _check_steps(buf, records, preload, n_regs, consts)
    smem = steps_smem_bytes(preload.numel(), n_regs, consts.shape[0])
    if smem > MAX_SMEM:
        raise wp.SlotFileTooLarge(f"W1 needs {smem} B of shared memory a block; the card "
                                  f"gives {MAX_SMEM}")
    if steps and lanes:
        _cuda.launch("zk_witness_steps", int(rich), buf, records, steps, preload,
                     preload.numel(), n_regs, consts, consts.shape[0], n_slots, lanes, smem)
        launches["witness_steps"] += 1
    return buf


def witness_steps_plain(buf: torch.Tensor, records: torch.Tensor, preload: torch.Tensor,
                        n_regs: int, consts: torch.Tensor, rich: bool) -> torch.Tensor:
    """Plain version of witness_steps, on the JAX package's (16, ., B) limbs.
    It keeps W1's shared memory as one (16, n_refs, B) file of each lane's
    reference space (the constant table, the preload area copied from the
    slot buffer, the registers) and per step gathers the operands by
    reference, selects each node's result, and writes it to its register
    and to its global slot."""
    x = words_to_limbs(buf)
    lanes = x.shape[2]
    table = words_to_limbs(consts[None])[:, :, 0]  # (16, n_consts)
    file = torch.cat([table[:, :, None].expand(-1, -1, lanes), x[:, preload.long()],
                      torch.zeros((L, n_regs, lanes), dtype=x.dtype, device=x.device)], dim=1)
    f = wp.decode(records.cpu().numpy())
    ops = f["op"]
    idx = torch.from_numpy(np.stack([f["a"], f["b"], f["c"]], -1)).to(buf.device)
    for t in range(ops.shape[0]):
        live = np.flatnonzero(ops[t] != we.F_NOP)
        if not live.size:
            continue
        a, b, c = (file[:, idx[t, live, j]] for j in range(3))
        res = step_plain(ops[t, live], a, b, c, rich)
        dst, slot = f["dst"][t, live], f["slot"][t, live]
        reg, glob = dst != wp.NO_REG, slot >= 0
        if reg.any():
            file[:, torch.from_numpy(dst[reg])] = res[:, torch.from_numpy(np.flatnonzero(reg))]
        if glob.any():
            x[:, torch.from_numpy(slot[glob])] = res[:, torch.from_numpy(np.flatnonzero(glob))]
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
