"""Speed-of-light microbenchmarks of one NVIDIA GPU for the limb arithmetic.

Counterpart of tools/tpu_microbench.py. Measures on the card:

  * the 32-bit integer and float32 pipes: register-resident chains of
    mul.lo (IMAD), mul.hi (IMAD.HI), add, shift/xor and f32 FMA at 2^24
    lanes and 256 steps (csrc/microbench.cu `chain_kernel`, wrapper
    `chain`), each held bit for bit against chain_plain on the tensors it
    is timed on;
  * the tensor cores at the JAX tool's shapes, as library yardsticks that
    the port never calls: torch._int_mm for 32768x64x64 int8 and
    torch.matmul for bf16 at 32768 and 2^20 rows;
  * the lane throughput of K1 fq, K2 g1 add / add_mixed / double and K6 at
    65536 lanes, each held against and timed beside its plain version on
    the same tensors (the JAX tool's XLA comparison);
  * the latencies behind W1's step chain, in SM cycles (clock64) of one
    dependent chain a thread at LATENCY_LANES lanes: a product by
    bn254.cuh's CIOS `mul` (W1's product), and one step's memory round trip
    (load, store, __syncwarp among a lane's four threads) through global
    memory, through shared memory, through shared memory with a global
    store beside, and through shared memory across four warps and a block
    barrier (W1's mapping); each held against its plain version
    (latency_plain, roundtrip_plain). Also the SM clock the chains ran at
    (clock_hz: the mul chain's cycles over its device time).

Times are CUDA-event times of calls run back to back
(profiling.device_ms).

The measured IMAD rate is printed beside the ChipSpec peak derived from the
SM count and clock; a measurement above the derived peak means the
derivation is wrong, and the measured rate becomes the peak. Every line
ends with the card's name and power limit.

Run on the card: python -m zerokit_tpu_torch.tools.microbench
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import Q, R
from ..ff import _cuda
from ..ff import field_kernels as fk
from ..ff.field import resolve_device
from ..runtime.profiling import ChipSpec, device_ms, host_call
from . import tc_mont_prototype as tc

OPS = {"imad": 0, "imad_hi": 1, "add": 2, "shift_xor": 3, "ffma": 4}
ACC = 8  # independent accumulators per thread in csrc/microbench.cu
# roundtrip_kernel modes
ROUNDTRIPS = {"global": 0, "shared": 1, "shared_store": 2, "shared_4warps": 3}
LATENCY_LANES, LATENCY_ITERS = 32, 4096
launches = {"chain": 0, "latency": 0, "roundtrip": 0}
_MASK = 0xFFFFFFFF


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def chain(op: str, a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """out[i] = xor over k < ACC of x_k after iters steps x_k <- op(x_k,
    b[i]) from x_k = a[i] + k, on (n,) int32 words: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if a.ndim != 1 or a.shape != b.shape or a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError("chain: a and b must be equal-length 1-d int32 tensors")
    if not fk.on_cuda(a, b):
        return chain_plain(op, a, b, iters)
    fk.check_limbs(a, "a")
    fk.check_limbs(b, "b")
    out = torch.empty_like(a)
    _cuda.launch("zk_chain", OPS[op], a, b, out, a.numel(), iters)
    launches["chain"] += 1
    return out


def _step_plain(op: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One chain step on words held in int64. FMA reads the words as
    float32; with x in [1, 2^9) and y in [0.5, 1) (chain_inputs) x * y + 1
    spans at most 49 bits, so it is exact in float64 and rounding it once
    to float32 gives fma.rn's result."""
    if op == "imad":
        return (x * y) & _MASK
    if op == "imad_hi":  # in 16-bit halves: a 64-bit product overflows int64
        xl, xh, yl, yh = x & 0xFFFF, x >> 16, y & 0xFFFF, y >> 16
        lh, hl = xl * yh, xh * yl
        mid = ((xl * yl) >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
        return xh * yh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    if op == "add":
        return (x + y) & _MASK
    if op == "shift_xor":
        return (x >> 7) ^ y
    xf = x.to(torch.int32).view(torch.float32).to(torch.float64)
    yf = y.to(torch.int32).view(torch.float32).to(torch.float64)
    return (xf * yf + 1.0).to(torch.float32).view(torch.int32).to(torch.int64) & _MASK


def chain_plain(op: str, a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version of chain."""
    y = b.to(torch.int64) & _MASK
    r = torch.zeros_like(y)
    for k in range(ACC):
        x = (a.to(torch.int64) + k) & _MASK
        for _ in range(iters):
            x = _step_plain(op, x, y)
        r ^= x
    return r.to(torch.int32)


def chain_inputs(op: str, n: int, device):
    """Seeded (n,) int32 words a, b; for ffma the float32 patterns of a in
    [1, 2) and b in [0.5, 1), so that x <- x * b + 1 stays in [1, 2^9)
    for up to 256 steps and its plain version stays exact."""
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, size=(2, n), dtype=np.uint64).astype(np.uint32)
    if op == "ffma":
        words = (words & 0x007FFFFF) | np.array([[0x3F800000], [0x3F000000]], dtype=np.uint32)
    t = torch.from_numpy(words.view(np.int32).copy()).to(device)
    return t[0].contiguous(), t[1].contiguous()


def measure_chains(lanes: int = 1 << 24, iters: int = 256) -> dict:
    """Steps per second of each chain on the card. Each chain is first held
    bit for bit against chain_plain on the tensors it is then timed on, so
    a rate is read only from a kernel that ran every step at this shape."""
    rates = {}
    for op in OPS:
        a, b = chain_inputs(op, lanes, "cuda")
        got, host_s = host_call(lambda: chain(op, a, b, iters))
        if not torch.equal(got, chain_plain(op, a, b, iters)):
            raise AssertionError(f"chain {op}: the kernel disagrees with chain_plain "
                                 f"at {lanes} lanes, {iters} steps")
        ms = device_ms(lambda: chain(op, a, b, iters), enqueue_s=host_s)
        rates[op] = lanes * iters * ACC / (ms * 1e-3)
    return rates


def _words(values, n_words: int) -> torch.Tensor:
    return torch.tensor([[(v >> (32 * k)) & _MASK for k in range(n_words)] for v in values],
                        dtype=torch.int64).to(torch.int32)


def _ints(words: torch.Tensor) -> list:
    w = words.cpu().to(torch.int64) & _MASK
    return [sum(int(x) << (32 * k) for k, x in enumerate(row)) for row in w]


def latency_inputs(n: int, device):
    """Seeded (n, 8) words x and y, Montgomery values < r."""
    rng = np.random.default_rng(17)
    xs = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    ys = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    return _words(xs, 8).to(device), _words(ys, 8).to(device)


def latency(x: torch.Tensor, y: torch.Tensor, iters: int):
    """(x after iters dependent products x <- mul(x, y), (n, 8) words;
    cycles (n,) int64)."""
    if x.ndim != 2 or x.shape[1] != 8 or y.shape != x.shape:
        raise ValueError("latency: x and y must be (n, 8) int32 words")
    if not fk.on_cuda(x, y):
        return latency_plain(x, y, iters), None
    for t, name in ((x, "x"), (y, "y")):
        fk.check_limbs(t, name)
    out = torch.empty_like(x)
    cycles = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    _cuda.launch("zk_latency", x, y, out, cycles, x.shape[0], iters)
    launches["latency"] += 1
    return out, cycles


def latency_plain(x: torch.Tensor, y: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version of latency's values, on Python integers: x * (y /
    2^256)^iters mod r, canonical."""
    rinv = pow(1 << 256, -1, R)
    out = [xv * pow(yv * rinv % R, iters, R) % R for xv, yv in zip(_ints(x), _ints(y))]
    return _words(out, 8).to(x.device)


def roundtrip(mode: str, g: torch.Tensor, iters: int):
    """(g after iters rounds, cycles (blocks, 4) int64): g (blocks, 2, 4, 8)
    words, each block's four values passed around its lane's four threads
    through memory of the ROUNDTRIPS mode."""
    if g.ndim != 4 or g.shape[1:] != (2, 4, 8):
        raise ValueError("roundtrip: g must be (blocks, 2, 4, 8) int32 words")
    if not fk.on_cuda(g):
        return roundtrip_plain(g, iters), None
    fk.check_limbs(g, "g")
    out = g.clone()
    cycles = torch.empty((g.shape[0], 4), dtype=torch.int64, device=g.device)
    _cuda.launch("zk_roundtrip", ROUNDTRIPS[mode], out, cycles, g.shape[0], iters)
    launches["roundtrip"] += 1
    return out, cycles


def roundtrip_plain(g: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version of roundtrip: round i moves value j of buffer i % 2,
    its first word plus 1, to value j + 1 (mod 4) of the other buffer."""
    out = g.clone().to(torch.int64)
    for it in range(iters):
        src, dst = out[:, it & 1], out[:, 1 - (it & 1)]
        moved = torch.roll(src, 1, dims=1)
        moved[:, :, 0] = (moved[:, :, 0] + 1) & _MASK
        dst.copy_(moved)
    return (out - ((out >> 31) << 32)).to(torch.int32)


def measure_latencies(lanes: int = LATENCY_LANES, iters: int = LATENCY_ITERS) -> dict:
    """Cycles of a dependent product ("mul") and of one memory round trip of
    each ROUNDTRIPS mode, the mean over the lanes' chains (one warp), each
    kernel first held against its plain version on the tensors it is timed
    on; and the SM clock the chains ran at ("clock_hz": the product chain's
    cycles over its device time)."""
    x, y = latency_inputs(lanes, "cuda")
    got, cycles = latency(x, y, iters)
    if not torch.equal(got, latency_plain(x, y, iters)):
        raise AssertionError("latency mul: the kernel disagrees with its plain version")
    out = {"mul": cycles.double().mean().item() / iters}
    ms = device_ms(lambda: latency(x, y, iters), 3)
    out["clock_hz"] = cycles.double().max().item() / (ms * 1e-3)
    rng = np.random.default_rng(19)
    g = torch.from_numpy(rng.integers(0, 1 << 32, size=(4, 2, 4, 8), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32)).cuda()
    for mode in ROUNDTRIPS:
        got, cycles = roundtrip(mode, g, iters)
        if not torch.equal(got, roundtrip_plain(g, iters)):
            raise AssertionError(f"roundtrip {mode}: the kernel disagrees with its plain "
                                 f"version")
        out["roundtrip_" + mode] = cycles.double().mean().item() / iters
    return out


def measure_w1_steps(lanes: int = 16, steps: int = 4096, check_steps: int = 256) -> dict:
    """Cycles a W1 step on chains of one op class (tools/witness_graphs.
    chain_graph: one node a step), at `lanes` lanes: device_ms of the
    chain's W1 launch over 3 calls, times the SM clock, over its steps.
    Each kind's W1 is first held bit for bit against its plain version on
    a chain of check_steps."""
    from ..circuit.witness_eval import WitnessEvaluator, compile_graph
    from .witness_graphs import CHAIN_KINDS, chain_graph

    chip = ChipSpec.from_device(torch.cuda.current_device())
    rng = np.random.default_rng(23)
    out = {}
    for kind in CHAIN_KINDS:
        for n in (check_steps, steps):
            ev = WitnessEvaluator(compile_graph(chain_graph(kind, n)), "cuda")
            xs = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(lanes)]]
            buf = ev.load(ev.build_input_buffer({"x": xs}, lanes))
            (seg,) = ev.segments
            if n == check_steps:
                ref = buf.clone()
                ev.steps_of(buf, seg)
                ev.steps_of(ref, seg, plain=True)
                if not torch.equal(buf, ref):
                    raise AssertionError(f"W1 on the {kind} chain disagrees with its plain "
                                         f"version")
                continue
            ms = device_ms(lambda: ev.steps_of(buf, seg), 3)
            out[kind] = ms * 1e-3 * chip.sm_clock_hz / seg.records.shape[0]
    return out


def measure_tensor_cores() -> dict:
    """Operations per second (a multiply and an add each count) of the
    library matmuls at the JAX tool's shapes."""
    m, k, n = 32768, 64, 64
    x8 = torch.ones((m, k), dtype=torch.int8, device="cuda")
    w8 = torch.ones((k, n), dtype=torch.int8, device="cuda")
    xb = torch.ones((m, k), dtype=torch.bfloat16, device="cuda")
    wb = torch.ones((k, n), dtype=torch.bfloat16, device="cuda")
    xb2 = torch.ones((1 << 20, k), dtype=torch.bfloat16, device="cuda")
    out = {}
    for label, fn, rows in (
        (f"int8 _int_mm {m}x{k}x{n}", lambda: torch._int_mm(x8, w8), m),
        (f"bf16 matmul {m}x{k}x{n}", lambda: torch.matmul(xb, wb), m),
        (f"bf16 matmul {1 << 20}x{k}x{n}", lambda: torch.matmul(xb2, wb), 1 << 20),
    ):
        ms = device_ms(fn)
        out[label] = (ms, 2 * rows * k * n / (ms * 1e-3))
    return out


def measure_kernels(lanes: int = 1 << 16) -> dict:
    """(kernel ms, plain ms) of K1 fq, K2 g1 add / add_mixed / double and K6
    on the same seeded tensors, after holding kernel and plain version
    equal on them (device_ms: 10 kernel calls, one plain call). Values
    are arbitrary field elements: the formulas are polynomials, so the
    time does not depend on them."""
    rng = np.random.default_rng(11)

    def elems(*shape):
        limbs = rng.integers(0, 1 << 16, size=(16,) + shape, dtype=np.uint32)
        limbs[15] %= (Q >> 240) & 0xFFFF
        return torch.from_numpy(limbs.astype(np.int32)).cuda()

    a, b = elems(lanes), elems(lanes)
    p, q = elems(1, 3, lanes), elems(1, 3, lanes)
    q_aff = q[:, :, :2].contiguous()
    cases = {
        "K1 mont_mul fq": (lambda: fk.mont_mul("fq", a, b), lambda: fk.mont_mul_plain("fq", a, b)),
        "K2 g1 add": (lambda: fk.ec_op("add", 1, p, q), lambda: fk.ec_op_plain("add", 1, p, q)),
        "K2 g1 add_mixed": (lambda: fk.ec_op("add_mixed", 1, p, q_aff),
                            lambda: fk.ec_op_plain("add_mixed", 1, p, q_aff)),
        "K2 g1 double": (lambda: fk.ec_op("double", 1, p), lambda: fk.ec_op_plain("double", 1, p)),
        "K6 mont_mul_tc": (lambda: tc.mont_mul_tc(a, b), lambda: tc.mont_mul_tc_plain(a, b)),
    }
    out = {}
    for name, (kern, plain) in cases.items():
        (got, kern_s), (want, plain_s) = host_call(kern), host_call(plain)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: the kernel disagrees with its plain version")
        out[name] = (device_ms(kern, enqueue_s=kern_s), device_ms(plain, 1, plain_s))
    return out


def main() -> dict:
    """Prints and returns the rates; the returned ChipSpec carries the
    measured IMAD rate where it exceeds the derived one."""
    resolve_device("cuda")
    chip = ChipSpec.from_device(torch.cuda.current_device())
    label = chip.label()
    rates = measure_chains()
    names = {"imad": "u32 mul.lo (IMAD)", "imad_hi": "u32 mul.hi (IMAD.HI)", "add": "u32 add",
             "shift_xor": "u32 shr/xor", "ffma": "f32 fma"}
    for op, rate in rates.items():
        print(f"{names[op]} x{ACC} chains, 2^24 lanes, 256 steps (checked against the plain "
              f"version): {rate / 1e12:.3f} Top/s; {label}", flush=True)
    derived = chip.derived_imad_per_sec
    print(f"IMAD peak derived ({chip.sm_count} SMs x {chip.sm_clock_hz / 1e9:.3f} GHz x "
          f"{chip.imad_per_clk_per_sm}/clk): {derived / 1e12:.3f} Top/s; measured "
          f"{rates['imad'] / 1e12:.3f} Top/s ({rates['imad'] / derived:.1%}); {label}", flush=True)
    if rates["imad"] > derived:
        print("the measured IMAD rate exceeds the derived peak: the derivation is wrong; "
              f"the measured rate is the peak; {label}", flush=True)
        chip.measured_imad_per_sec = rates["imad"]
    lat = measure_latencies()
    print(f"SM clock under the latency chains: {lat['clock_hz'] / 1e9:.3f} GHz; {label}",
          flush=True)
    for what, cycles in lat.items():
        if what == "clock_hz":
            continue
        print(f"latency {what}: {cycles:.1f} cycles (one dependent chain a thread, "
              f"{LATENCY_LANES} lanes x {LATENCY_ITERS} steps, clock64; checked against the "
              f"plain version); {label}", flush=True)
    w1 = measure_w1_steps()
    for kind, cycles in w1.items():
        print(f"W1 step on a {kind} chain (16 lanes, 4096 steps, checked against the plain "
              f"version): {cycles:.1f} cycles; {label}", flush=True)
    tensor = measure_tensor_cores()
    for what, (ms, ops) in tensor.items():
        print(f"{what}: {ms:.4f} ms ({ops / 1e12:.2f} Top/s); {label}", flush=True)
    lanes = 1 << 16
    kernels = measure_kernels(lanes)
    for what, (ms, plain_ms) in kernels.items():
        print(f"{what} ({lanes} lanes): {ms:.4f} ms ({lanes / ms / 1e3:.1f} M ops/s), "
              f"plain {plain_ms:.2f} ms; {label}", flush=True)
    return {"chip": chip, "chains": rates, "latency": lat, "w1_steps": w1, "tensor": tensor,
            "kernels": kernels}


if __name__ == "__main__":
    main()
