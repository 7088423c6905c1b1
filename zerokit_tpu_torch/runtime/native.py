"""ctypes bindings for the native host runtime (native/rln_native.cpp).

Loads librln_native.so if present: first the copy built by `python -m
zerokit_tpu_torch.runtime.build` into build/zerokit_tpu_torch/, then the
tracked native/librln_native.so. Installs the Poseidon parameters generated
by the shared Grain-LFSR code and exposes the host Poseidon, keccak and
Merkle root, the host pairing, the small host MSMs and the batched Groth16
blinding assembly. Callers fall back to the pure-Python implementations
when no library loads.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence

_LIB_PATHS = [
    os.path.join(
        os.path.dirname(__file__), "..", "..", "build", "zerokit_tpu_torch",
        "librln_native.so",
    ),
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "librln_native.so"),
]

_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[str] = None
_initialized_t: set = set()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_path
    if _lib is not None:
        return _lib
    for path in _LIB_PATHS:
        path = os.path.abspath(path)
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.rln_native_version.restype = ctypes.c_char_p
                assert lib.rln_native_version().startswith(b"zerokit-tpu-native")
                _lib = lib
                _lib_path = path
                return lib
            except OSError:
                continue
    return None


def available() -> bool:
    return _load() is not None


def loaded_path() -> Optional[str]:
    """Path of the library that loaded, or None."""
    _load()
    return _lib_path


def ensure_loaded(log=print) -> None:
    """Loads the library, building it with g++ (runtime/build.py) when no
    copy loads; raises if it still does not load. Logs which library and
    which host paths (assembly, pairing) are in use."""
    if not available():
        log("native: no library loaded; building with g++")
        from . import build

        build.build()
    if not available():
        raise RuntimeError("native host library unavailable")
    log(f"native: {os.path.relpath(loaded_path())} (assembly: "
        f"{'native batched' if assemble_available() else 'python'}, pairing: "
        f"{'native' if pairing_available() else 'python'})")


def _ensure_params(t: int) -> bool:
    lib = _load()
    if lib is None:
        return False
    if t in _initialized_t:
        return True
    from ..hash.poseidon import params_for_t

    try:
        rf, rp, ark, mds = params_for_t(t)
    except Exception:
        return False
    ark_bytes = b"".join(int(v).to_bytes(32, "little") for v in ark)
    mds_bytes = b"".join(
        int(v).to_bytes(32, "little") for row in mds for v in row
    )
    rc = lib.rln_poseidon_init(t, rf, rp, ark_bytes, mds_bytes)
    if rc != 0:
        return False
    _initialized_t.add(t)
    return True


def poseidon_hash_native(inputs: Sequence[int]) -> Optional[int]:
    t = len(inputs) + 1
    if not _ensure_params(t):
        return None
    lib = _load()
    buf = b"".join(int(v).to_bytes(32, "little") for v in inputs)
    out = ctypes.create_string_buffer(32)
    if lib.rln_poseidon_hash(buf, len(inputs), out) != 0:
        return None
    return int.from_bytes(out.raw, "little")


def poseidon_hash_pairs_native(
    lefts: Sequence[int], rights: Sequence[int]
) -> Optional[List[int]]:
    if not _ensure_params(3):
        return None
    lib = _load()
    lbuf = b"".join(int(v).to_bytes(32, "little") for v in lefts)
    rbuf = b"".join(int(v).to_bytes(32, "little") for v in rights)
    out = ctypes.create_string_buffer(32 * len(lefts))
    if lib.rln_poseidon_hash_pairs(lbuf, rbuf, len(lefts), out) != 0:
        return None
    raw = out.raw
    return [
        int.from_bytes(raw[i * 32 : (i + 1) * 32], "little") for i in range(len(lefts))
    ]


def merkle_compute_root_native(
    leaf: int, path_elems: Sequence[int], path_bits: Sequence[int]
) -> Optional[int]:
    if not _ensure_params(3):
        return None
    lib = _load()
    ebuf = b"".join(int(v).to_bytes(32, "little") for v in path_elems)
    bbuf = bytes(int(b) & 1 for b in path_bits)
    out = ctypes.create_string_buffer(32)
    if lib.rln_merkle_compute_root(
        int(leaf).to_bytes(32, "little"), ebuf, bbuf, len(path_elems), out
    ) != 0:
        return None
    return int.from_bytes(out.raw, "little")


def keccak256_native(data: bytes) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(32)
    lib.rln_keccak256(bytes(data), len(data), out)
    return out.raw


# ---------------------------------------------------------------------------
# Pairing / Groth16 verification primitives (native/pairing.cpp)
# ---------------------------------------------------------------------------


def _g1_bytes(p) -> bytes:
    """Affine G1 (x, y) ints or None -> 64 canonical LE bytes ((0,0) = inf)."""
    if p is None:
        return b"\0" * 64
    return int(p[0]).to_bytes(32, "little") + int(p[1]).to_bytes(32, "little")


def _g2_bytes(p) -> bytes:
    """Affine G2 ((x0,x1),(y0,y1)) or None -> 128 canonical LE bytes."""
    if p is None:
        return b"\0" * 128
    (x0, x1), (y0, y1) = p
    return b"".join(int(v).to_bytes(32, "little") for v in (x0, x1, y0, y1))


class NativeCallError(RuntimeError):
    """A native symbol the caller committed to (after pairing_available())
    was missing or returned a nonzero rc. Distinct from the point-at-infinity
    result so version-skewed .so files can never be mistaken for inf."""


def pairing_available() -> bool:
    """True only when EVERY symbol the verify/assembly callers use exists —
    a skewed .so with the pairing but no MSM must not be treated as a
    pairing-capable backend (callers would silently drop MSM terms)."""
    lib = _load()
    return lib is not None and all(
        hasattr(lib, sym)
        for sym in ("rln_multi_pairing_is_one", "rln_g1_msm", "rln_g2_msm")
    )


def multi_pairing_is_one_native(pairs) -> Optional[bool]:
    """prod e(P_i, Q_i) == 1 via the native tower pairing (~2-3 ms per
    Miller loop vs ~170 ms for the pure-Python oracle). pairs: iterable of
    (g1_point, g2_point) host affine tuples; None = infinity."""
    lib = _load()
    if lib is None or not hasattr(lib, "rln_multi_pairing_is_one"):
        raise NativeCallError(
            "rln_multi_pairing_is_one unavailable (gate on pairing_available())"
        )
    pairs = list(pairs)
    g1s = b"".join(_g1_bytes(p) for p, _ in pairs)
    g2s = b"".join(_g2_bytes(q) for _, q in pairs)
    out = ctypes.c_int(0)
    rc = lib.rln_multi_pairing_is_one(g1s, g2s, len(pairs), ctypes.byref(out))
    if rc != 0:
        raise NativeCallError(f"rln_multi_pairing_is_one failed rc={rc}")
    return bool(out.value)


def g1_msm_native(points, scalars) -> Optional[object]:
    """sum_i scalars[i] * points[i] over G1 (host affine ints; None = inf)."""
    lib = _load()
    if lib is None or not hasattr(lib, "rln_g1_msm"):
        raise NativeCallError("rln_g1_msm unavailable (gate on pairing_available())")
    pbuf = b"".join(_g1_bytes(p) for p in points)
    sbuf = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    out = ctypes.create_string_buffer(64)
    rc = lib.rln_g1_msm(pbuf, sbuf, len(points), out)
    if rc != 0:
        raise NativeCallError(f"rln_g1_msm failed rc={rc}")
    x = int.from_bytes(out.raw[:32], "little")
    y = int.from_bytes(out.raw[32:], "little")
    return None if (x == 0 and y == 0) else (x, y)


def g2_msm_native(points, scalars) -> Optional[object]:
    """sum_i scalars[i] * points[i] over G2 (((x0,x1),(y0,y1)) ints)."""
    lib = _load()
    if lib is None or not hasattr(lib, "rln_g2_msm"):
        raise NativeCallError("rln_g2_msm unavailable (gate on pairing_available())")
    pbuf = b"".join(_g2_bytes(p) for p in points)
    sbuf = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    out = ctypes.create_string_buffer(128)
    rc = lib.rln_g2_msm(pbuf, sbuf, len(points), out)
    if rc != 0:
        raise NativeCallError(f"rln_g2_msm failed rc={rc}")
    raw = out.raw
    vals = [int.from_bytes(raw[i * 32 : (i + 1) * 32], "little") for i in range(4)]
    if all(v == 0 for v in vals):
        return None
    return ((vals[0], vals[1]), (vals[2], vals[3]))


def g1_is_valid_native(p) -> Optional[bool]:
    """Canonical-range + on-curve check on a host affine G1 tuple (None =
    infinity = valid). Returns None when the symbol is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "rln_g1_is_valid"):
        return None
    return lib.rln_g1_is_valid(_g1_bytes(p)) == 1


def g2_is_valid_native(p, check_subgroup: bool = True) -> Optional[bool]:
    """Range + on-twist-curve (+ r-torsion subgroup) check on a host affine
    G2 tuple. Returns None when the symbol is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "rln_g2_is_valid"):
        return None
    return lib.rln_g2_is_valid(_g2_bytes(p), 1 if check_subgroup else 0) == 1


def assemble_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "rln_groth16_assemble_batch")


def groth16_assemble_batch_native(
    pk, a_pts, b1_pts, b2_pts, l_pts, h_pts, rs, ss
) -> Optional[list]:
    """Batched blinding assembly (native/pairing.cpp
    rln_groth16_assemble_batch): one C call per batch instead of ~5 MSM
    calls per proof. rs/ss: canonical Fr ints. Returns [(a, b2, c), ...]
    host affine tuples, or None when the symbol is missing (callers fall
    back to the per-proof path)."""
    lib = _load()
    if lib is None or not hasattr(lib, "rln_groth16_assemble_batch"):
        return None
    from ..constants import R

    batch = len(rs)
    rss = [(r % R) * (s % R) % R for r, s in zip(rs, ss)]

    def scal(vals):
        return b"".join((int(v) % R).to_bytes(32, "little") for v in vals)

    out_a = ctypes.create_string_buffer(64 * batch)
    out_b = ctypes.create_string_buffer(128 * batch)
    out_c = ctypes.create_string_buffer(64 * batch)
    rc = lib.rln_groth16_assemble_batch(
        _g1_bytes(pk.vk.alpha_g1),
        _g1_bytes(pk.beta_g1),
        _g1_bytes(pk.delta_g1),
        _g2_bytes(pk.vk.beta_g2),
        _g2_bytes(pk.vk.delta_g2),
        b"".join(_g1_bytes(p) for p in a_pts),
        b"".join(_g1_bytes(p) for p in b1_pts),
        b"".join(_g2_bytes(p) for p in b2_pts),
        b"".join(_g1_bytes(p) for p in l_pts),
        b"".join(_g1_bytes(p) for p in h_pts),
        scal(rs),
        scal(ss),
        scal(rss),
        ctypes.c_size_t(batch),  # stack-passed arg: bare int would be c_int
        out_a,
        out_b,
        out_c,
    )
    if rc != 0:
        raise NativeCallError(f"rln_groth16_assemble_batch failed rc={rc}")

    def g1_of(raw, i):
        x = int.from_bytes(raw[64 * i : 64 * i + 32], "little")
        y = int.from_bytes(raw[64 * i + 32 : 64 * i + 64], "little")
        return None if (x == 0 and y == 0) else (x, y)

    def g2_of(raw, i):
        vals = [
            int.from_bytes(raw[128 * i + 32 * j : 128 * i + 32 * (j + 1)], "little")
            for j in range(4)
        ]
        if all(v == 0 for v in vals):
            return None
        return ((vals[0], vals[1]), (vals[2], vals[3]))

    return [
        (g1_of(out_a.raw, b), g2_of(out_b.raw, b), g1_of(out_c.raw, b))
        for b in range(batch)
    ]


def fr_ntt_native(vals: Sequence[int], inverse: bool = False) -> Optional[List[int]]:
    """Radix-2 NTT over Fr on the ark Radix2EvaluationDomain subgroup
    (natural order; inverse includes the 1/n scaling)."""
    lib = _load()
    if lib is None or not hasattr(lib, "rln_fr_ntt"):
        return None
    from ..constants import FR_TWO_ADICITY, FR_TWO_ADIC_ROOT, R

    n = len(vals)
    if n == 0 or n & (n - 1):
        return None
    logn = n.bit_length() - 1
    w = pow(FR_TWO_ADIC_ROOT, 1 << (FR_TWO_ADICITY - logn), R)
    if inverse:
        w = pow(w, -1, R)
        scale = pow(n, -1, R)
    else:
        scale = 1
    buf = ctypes.create_string_buffer(
        b"".join(int(v).to_bytes(32, "little") for v in vals)
    )
    rc = lib.rln_fr_ntt(
        buf, n, w.to_bytes(32, "little"), scale.to_bytes(32, "little")
    )
    if rc != 0:
        return None
    raw = buf.raw  # one copy: each .raw copies the whole buffer
    return [int.from_bytes(raw[32 * i : 32 * (i + 1)], "little") for i in range(n)]
