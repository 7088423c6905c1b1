"""The inline-PTX carry chains of csrc/bn254.cuh, simulated on the CPU.

No CUDA compiler runs here, so this test reads each asm statement of the
field core (add8, sub8, mad_row, redc_row, merge_row), executes its PTX
(add/sub/mad with the carry flag, mul.lo/hi) on Python integers, and runs
the header's own composition of them: the C bodies of mul (its rows and
their order), add, sub and canon, translated line by line into Python. For
Fr and Fq they are held against big-integer arithmetic: results in [0, 2p)
that agree mod p,
canon exact, and no chain that the header ends without a carry-out may
drop one. The inputs reach the lazy core's edges (0, p - 1, p, 2p - 1,
values just above p - 2^32, words of all ones).
"""

import functools
import os
import random
import re

import pytest

from zerokit_tpu_torch.constants import Q, R

SRC = open(os.path.join(os.path.dirname(__file__), "..", "zerokit_tpu_torch", "csrc",
                        "bn254.cuh")).read()
M32 = 0xFFFFFFFF
NINV = {Q: 0xE4866389, R: 0xEFFFFFFF}
MOD_2_256 = ("add8", "sub8")  # chains that wrap mod 2^256 by design


def _asm(fname):
    """(instructions, operand expressions, number of outputs) of the one
    asm statement in function `fname`."""
    start = SRC.index(f" {fname}(")
    j = SRC.index("asm(", start)
    depth, k = 0, j + 3
    while True:
        depth += {"(": 1, ")": -1}.get(SRC[k], 0)
        if depth == 0:
            break
        k += 1
    parts = SRC[j + 4:k].split(":")
    text = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', parts[0])).replace("\\n", "\n")
    text = text.replace("\\t", "")
    outs = re.findall(r'"[+=]r"\(([^)]*)\)', parts[1])
    ins = re.findall(r'"r"\(([^)]*)\)', parts[2])
    instrs = [i.strip() for i in text.replace("{", "").replace("}", "").split(";") if i.strip()]
    return instrs, outs + ins, len(outs)


def run(fname, env):
    """Executes fname's asm on env (operand expression -> value)."""
    instrs, ops, nout = _asm(fname)
    regs = {i: env.get(e, 0) for i, e in enumerate(ops)}
    local, carry = {}, None

    def val(tok):
        if tok.startswith("%"):
            return regs[int(tok[1:])]
        return local[tok] if tok in local else int(tok, 0)

    for ins in instrs:
        if ins.startswith(".reg"):
            local[ins.split()[-1]] = 0
            continue
        op, args = ins.split(None, 1)
        a = [x.strip() for x in args.split(",")]
        parts = op.split(".")
        base = parts[0]
        if base in ("addc", "subc", "madc"):
            assert carry is not None, f"{fname}: {ins} reads a carry no instruction set"
            cin = carry
        else:
            cin = 0
        if base in ("add", "addc"):
            v = val(a[1]) + val(a[2]) + cin
            out = v >> 32
        elif base in ("sub", "subc"):
            v = val(a[1]) - val(a[2]) - cin
            out = 1 if v < 0 else 0
        elif base == "mul":
            p = val(a[1]) * val(a[2])
            v, out = (p if "lo" in parts else p >> 32), None
        else:  # mad, madc
            p = val(a[1]) * val(a[2])
            v = ((p & M32) if "lo" in parts else (p >> 32)) + val(a[3]) + cin
            out = v >> 32
        if a[0].startswith("%"):
            assert int(a[0][1:]) < nout, f"{fname}: {ins} writes an input"
            regs[int(a[0][1:])] = v & M32
        else:
            local[a[0]] = v & M32
        if "cc" in parts:
            carry = out
        else:
            if out and fname not in MOD_2_256:
                raise AssertionError(f"{fname}: {ins} drops a carry")
            carry = None
    for i, e in enumerate(ops[:nout]):
        env[e] = regs[i]
    return env


def words(x):
    return [(x >> (32 * i)) & M32 for i in range(8)]


def num(w):
    return sum(v << (32 * i) for i, v in enumerate(w))


def bind(name, w):
    return {f"{name}[{i}]": v for i, v in enumerate(w)}


def unbind(env, name):
    return [env[f"{name}[{i}]"] for i in range(8)]


def _body(signature):
    """The lines between the braces of the header function that starts with
    `signature`."""
    start = SRC.index("{", SRC.index(signature))
    depth, k = 0, start
    while True:
        depth += {"{": 1, "}": -1}.get(SRC[k], 0)
        if depth == 0:
            return SRC[start + 1:k].splitlines()
        k += 1


def _python(name, params, lines):
    """The header function's C body as Python source: the few forms the
    field core's compositions use (u32 arrays and values, Elem<F> copies,
    for and if blocks, ?:, F:: constants), u32 assignments masked to 32
    bits. Any other form is a syntax error, so the test fails rather than
    simulate something else."""
    out, depth = [f"def {name}({', '.join(params)}):"], 1

    def stmt(s):
        s = (s.replace("load_p<F>", "load_p").replace("load_p2<F>", "load_p2")
             .replace("F::NINV0", "NINV0").replace("F::p2(", "P2(").replace("__umulhi", "umulhi"))
        s = re.sub(r"(\w+) \? (.+) : (.+)", r"(\2 if \1 else \3)", s)
        if m := re.fullmatch(r"u32 (\w+\[8\](?:, \w+\[8\])*)", s):
            return [f"{v.split('[')[0]} = [0] * 8" for v in m[1].split(", ")]
        if m := re.fullmatch(r"Elem<F> (\w+)(?: = (\w+))?", s):
            return [f"{m[1]} = Elem({m[2]}.v)" if m[2] else f"{m[1]} = Elem()"]
        s = re.sub(r"^u32 ", "", s)
        if m := re.fullmatch(r"([\w.]+\[[^]]+\]) = (.+)", s):
            return [f"{m[1]} = ({m[2]}) & M32"]
        return [s]

    for line in lines:
        s = line.split("//")[0].strip()
        if not s or s.startswith(("#pragma", "static_assert")):
            continue
        if s == "}":
            depth -= 1
            continue
        if m := re.fullmatch(r"for \(int (\w+) = (\w+); \1 < (\w+); \1(?: \+= (\w+)|\+\+)\) (.*)", s):
            out.append("    " * depth + f"for {m[1]} in range({m[2]}, {m[3]}, {m[4] or 1}):")
            if m[5] == "{":
                depth += 1
            else:
                out += ["    " * (depth + 1) + x for x in stmt(m[5].rstrip(";"))]
            continue
        if m := re.fullmatch(r"if \((.*)\) \{", s):
            out.append("    " * depth + f"if {m[1]}:")
            depth += 1
            continue
        out += ["    " * depth + x for x in stmt(s.rstrip(";"))]
    return "\n".join(out)


class Elem:
    def __init__(self, v=(0,) * 8):
        self.v = list(v)


def core(p):
    """mul, add, sub and canon of the header for the field of modulus p,
    built from their C bodies, on Elem values; the asm chains run through
    run() and write their outputs back into the arrays, as in C."""

    def chain(fname, **arrays):
        env = {"ninv0": arrays.pop("ninv0", 0), "bi": arrays.pop("bi", 0)}
        for k, w in arrays.items():
            env.update(bind(k, w))
        env = run(fname, env)
        for k, w in arrays.items():
            w[:] = unbind(env, k)
        return env.get("borrow")

    ns = {
        "M32": M32, "Elem": Elem, "NINV0": NINV[p], "P2": lambda i: words(2 * p)[i],
        "umulhi": lambda x, y: (x * y) >> 32,
        "load_p": lambda w: w.__setitem__(slice(None), words(p)),
        "load_p2": lambda w: w.__setitem__(slice(None), words(2 * p)),
        "add8": lambda r, b: chain("add8", r=r, b=list(b)),
        "sub8": lambda r, b: chain("sub8", r=r, b=list(b)),
        "mad_row": lambda e, o, a, bi: chain("mad_row", e=e, o=o, a=list(a), bi=bi),
        "mac_row": lambda e, o, a, bi: chain("mac_row", e=e, o=o, a=list(a), bi=bi),
        "redc_row": lambda e, o, pw, n: chain("redc_row", e=e, o=o, p=list(pw), ninv0=n),
        "merge_row": lambda r, o: chain("merge_row", r=r, o=list(o)),
    }
    for name in ("mul", "add", "sub", "canon"):
        sig = re.search(rf"Elem<F> {name}\(([^)]*)\) {{", SRC)
        params = re.findall(r"const Elem<F>& (\w+)", sig[1])
        exec(_python(name, params, _body(sig[0])), ns)
    body = _body("Elem<F> mul_sum(")
    exec(_python("mul_sum", ["a", "b"], body), ns)
    # the row before its conditional subtractions of 2p
    cut = next(i for i, line in enumerate(body) if "s < N" in line)
    exec(_python("mul_sum_raw", ["a", "b"], body[:cut] + ["return r;"]), ns)
    f = {name: (lambda f: lambda *xs: num(f(*(Elem(words(x)) for x in xs)).v))(ns[name])
         for name in ("mul", "add", "sub", "canon")}

    def row(name):
        def call(a, b):  # N = len(a), as the template argument
            ns["N"] = len(a)
            return num(ns[name]([Elem(words(x)) for x in a], [Elem(words(x)) for x in b]).v)
        return call

    f["mul_sum"], f["mul_sum_raw"] = row("mul_sum"), row("mul_sum_raw")
    return f


def test_the_header_has_the_chains_simulated_here():
    for fname in ("add8", "sub8", "mad_row", "mac_row", "redc_row", "merge_row"):
        instrs, ops, nout = _asm(fname)
        assert instrs and nout <= len(ops) <= 30, fname  # nvcc's operand limit is 30


@pytest.mark.parametrize("p", [R, Q], ids=["fr", "fq"])
def test_ptx_field_core_matches_big_integers(p):
    rng = random.Random(p & 0xFFFF)
    edges = [0, 1, 2, p - 1, p, p + 1, 2 * p - 1, 2 * p - 2, p - 2 ** 32, p - 2 ** 32 + 1,
             2 * p - 2 ** 32, 2 ** 255 % (2 * p), (p + 1) // 2]
    ones = [(rng.randrange(2 * p) | (M32 << (32 * rng.randrange(8)))) % (2 * p)
            for _ in range(6)]
    vals = edges + ones + [rng.randrange(2 * p) for _ in range(6)]
    rinv = pow(2 ** 256, -1, p)
    f = core(p)
    for a in vals:
        assert f["canon"](a) == a % p
        for b in vals[::3] + [a]:
            m = f["mul"](a, b)
            assert m < 2 * p and m % p == a * b * rinv % p, (hex(a), hex(b))
            s = f["add"](a, b)
            assert s < 2 * p and s % p == (a + b) % p
            d = f["sub"](a, b)
            assert d < 2 * p and d % p == (a - b) % p


@functools.lru_cache(maxsize=None)
def _graph_constants():
    """The distinct constants of both depth-20 RLN graphs, canonical."""
    from zerokit_tpu_torch.circuit import graph as gm
    from zerokit_tpu_torch.resources import resource_path

    out = set()
    for rel, max_out in (("tree_depth_20/graph.bin", None),
                         ("tree_depth_20/multi_message_id/max_out_4/graph.bin", 4)):
        graph = gm.graph_from_file(resource_path(rel), 20, max_out)
        out |= {n.const % R for n in graph.nodes if n.kind == gm.K_CONST}
    return sorted(out)


@pytest.mark.parametrize("x", [0, 1, R - 1, (R - 1) // 2, (R + 1) // 2],
                         ids=["0", "1", "r-1", "(r-1)/2", "(r+1)/2"])
def test_w1_product_by_a_graph_constant(x):
    """W1 multiplies by a constant with the header's `mul` and the constant
    table's Montgomery entry c 2^256 mod r: the product of an operand x
    (Montgomery form) lies in [0, 2r) and equals x c mod r. Constants: 0,
    1, r - 1 and seeded ones of both depth-20 graphs. The canonical c in
    place of its table entry fails (a mutation check)."""
    consts = _graph_constants()
    assert len(consts) > 900
    rng = random.Random(x & 0xFFFF)
    sample = [0, 1, R - 1] + rng.sample(consts, 12)
    f = core(R)
    for c in sample:
        m = f["mul"](x, c * 2 ** 256 % R)
        assert m < 2 * R and m % R == x * c % R, (hex(x), hex(c))
    if x:
        assert any(f["mul"](x, c) % R != x * c % R for c in sample)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_mul_sum_row_stays_in_range(n):
    """mul_sum, P1's mix row with one reduction: canonical constants (r - 1
    among them) times values in [0, 2r) at the edges of the lazy core and
    of P1's edge lanes (r - 1, the Montgomery images of r - 1 and of values
    near 2^253). No chain drops a carry (the accumulator stays below
    2^288), and the row lands in [0, 2r), equal to sum a b / 2^256 mod r;
    without its conditional subtraction a row of 3 or 4 passes 2r (the
    range the subtraction exists for), and a row of 2, which has none,
    stays below 2r."""
    from zerokit_tpu_torch.ff.field import FR

    rng = random.Random(n)
    rinv = pow(2 ** 256, -1, R)
    consts = [R - 1, R - 2, 1, 0] + [rng.randrange(R) for _ in range(4)]
    vals = [0, 1, R - 1, R, 2 * R - 1, 2 * R - 2 ** 32, FR.to_mont_int(R - 1),
            FR.to_mont_int((1 << 253) + 1), (1 << 253) + 1] + [rng.randrange(2 * R)
                                                              for _ in range(4)]
    f = core(R)
    worst = 0
    cases = [([consts[(k + j) % len(consts)] for j in range(n)],
              [vals[(k + 3 * j) % len(vals)] for j in range(n)]) for k in range(len(vals))]
    # the largest rows: r - 1 times values near 2r
    cases += [([R - 1] * n, [2 * R - 1 - rng.randrange(1 << 250) for _ in range(n)])
              for _ in range(24)]
    for a, b in cases:
        want = sum(x * y for x, y in zip(a, b)) * rinv % R
        raw = f["mul_sum_raw"](a, b)
        assert raw < (n + 1) * R and raw % R == want
        got = f["mul_sum"](a, b)
        assert got < 2 * R and got % R == want
        worst = max(worst, raw)
    assert (worst >= 2 * R) == (n > 2)
