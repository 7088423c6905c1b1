"""Builds and loads the CUDA kernels of csrc/ (nvcc + ctypes).

The kernels compile at first use, on the machine with the card, into
build/zerokit_tpu_torch/libzk_kernels_<hash>.so, where <hash> covers the
sources and the flags: an unchanged source tree reuses the library. Each
source compiles in its own nvcc process, all at once. The
library has a plain C interface; every entry point takes raw device
pointers and the CUDA stream as void pointers, launches on that stream and
returns cudaGetLastError(), which `launch` turns into an exception.

Nothing here runs at import time: CPU-only hosts import this module and
never build.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

from ..runtime.build import build_lock

CSRC_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "csrc"))
BUILD_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "build", "zerokit_tpu_torch")
)
SOURCES = (
    "bn254.cuh", "field_kernels.cu", "ec_scan.cu", "ntt_kernels.cu", "mont_tc.cu", "microbench.cu",
    "witness_kernels.cu", "poseidon.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
_PLL = ctypes.POINTER(ctypes.c_longlong)
# entry point -> argument types (a launch takes the stream as its last pointer;
# an occupancy query ends with the int it writes)
_SIGNATURES = {
    "zk_mont_mul": (_I, _P, _P, _P, _LL, _P),
    "zk_ec_op": (_I, _I, _P, _P, _P, _LL, _I, _P),
    "zk_ec_add_gather": (_I, _P, _P, _P, _P, _P, _P, _LL, _I, _P),
    "zk_ec_scan_gather": (_I, _P, _P, _P, _I, _LL, _LL, _I, _P),
    "zk_ec_scan_excl": (_I, _P, _P, _I, _I, _LL, _LL, _LL, _LL, _P),
    "zk_ntt_cross": (_I, _P, _P, _P, _LL, _LL, _LL, _I, _I, _P),
    "zk_ntt_cross_occupancy": (_I, _LL, _LL, _I, _I, _PI),
    "zk_ntt_tail": (_I, _P, _P, _P, _P, _LL, _LL, _LL, _P),
    "zk_ntt_tail_occupancy": (_I, _I, _LL, _PI),
    "zk_mont_mul_tc": (_P, _P, _P, _P, _P, _LL, _P),
    "zk_mont_mul_tc_occupancy": (_PI,),
    "zk_chain": (_I, _P, _P, _P, _LL, _I, _P),
    "zk_latency": (_P, _P, _P, _P, _I, _I, _P),
    "zk_roundtrip": (_I, _P, _P, _I, _I, _P),
    "zk_witness_steps": (_I, _P, _P, _I, _P, _I, _I, _P, _I, _LL, _I, _I, _P),
    "zk_witness_steps_occupancy": (_I, _I, _PI),
    "zk_witness_div": (_P, _P, _P, _P, _I, _LL, _I, _I, _P),
    "zk_poseidon": (_I, _I, _I, _P, _PLL, _PLL, _PLL, _P, _LL, _I, _I, _P),
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
build_info: dict = {}


def _cuda_tool(name: str) -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name),
        shutil.which(name),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found under $CUDA_HOME/bin or on PATH")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libzk_kernels_{source_hash()}.so")


def build() -> str:
    """Compiles csrc/ into the build directory unless the library for this
    source hash exists: one nvcc per source, all started together, then one
    link. Records the seconds and the ptxas report in build_info. Processes
    that call it at once take turns on a lock file in the build directory,
    so one of them builds and the others find its library."""
    path = library_path()
    with build_lock(BUILD_DIR, "libzk_kernels"):
        if os.path.exists(path):
            build_info.update(path=path, seconds=0.0, built=False)
            return path
        return _build(path)


def _build(path: str) -> str:
    stem = f"{path[:-3]}.{os.getpid()}"
    nvcc = _cuda_tool("nvcc")
    t0 = time.perf_counter()
    jobs = []
    for name in SOURCES:
        if name.endswith(".cu"):
            obj = f"{stem}.{name[:-3]}.o"
            with open(obj + ".log", "w") as out:
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, name)]
                proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
            jobs.append((name, obj, proc))
    log, failed = "", []
    for name, obj, proc in jobs:
        proc.wait()
        with open(obj + ".log") as f:
            log += f"== {name}\n{f.read()}"
        os.remove(obj + ".log")
        if proc.returncode != 0:
            failed.append(name)
    objs = [obj for _, obj, _ in jobs]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", f"{stem}.tmp", *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    seconds = time.perf_counter() - t0
    with open(path[:-3] + "_nvcc.log", "w") as f:
        f.write(log)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log[-8000:]}")
    os.replace(f"{stem}.tmp", path)
    build_info.update(path=path, seconds=seconds, built=True, log=log)
    return path


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> list:
    """(kernel, registers, stack bytes, spill-store bytes, spill-load bytes)
    of each kernel entry in an nvcc -Xptxas -v log, kernel names demangled
    where c++filt exists."""
    entries: dict = {}
    entry = props = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            entry = m.group(1)
            entries[entry] = [0, 0, 0, 0]
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif (m := _STACK.search(line)) and props == entry and entry is not None:
            entries[entry][1:] = [int(g) for g in m.groups()]
        elif (m := _REGS.search(line)) and entry is not None:
            entries[entry][0] = int(m.group(1))
    names = list(entries)
    filt = shutil.which("c++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            entries = dict(zip(out.stdout.splitlines(), entries.values()))
    return [(name, *vals) for name, vals in entries.items()]


def _load(path: str) -> ctypes.CDLL:
    handle = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    handle.zk_error_string.argtypes = [ctypes.c_int]
    handle.zk_error_string.restype = ctypes.c_char_p
    return handle


def lib() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once: threads that
    reach the first launch together wait for one build (build() names its
    temporaries by process only)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _load(build())
    return _lib


def launch(name: str, *args) -> None:
    """Calls entry point `name` with tensors passed as device pointers, on
    the current stream of the first tensor's device; raises on a CUDA error."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    handle = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(handle, name)(*conv, stream)
    if rc != 0:
        msg = handle.zk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def occupancy(name: str, *args) -> int:
    """Blocks per SM of a kernel at the launch its wrapper makes, from the
    library's occupancy entry point `name` (cudaOccupancyMaxActiveBlocks-
    PerMultiprocessor, with the launch's threads and shared memory)."""
    blocks = ctypes.c_int(0)
    handle = lib()
    rc = getattr(handle, name)(*args, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({handle.zk_error_string(rc).decode()})")
    return blocks.value


_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]*)")


@functools.lru_cache(maxsize=None)
def _sass(path: str) -> str:
    return subprocess.run([_cuda_tool("cuobjdump"), "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def sass_opcodes(*function_substrings: str) -> collections.Counter:
    """Opcode counts (with modifiers, e.g. IMAD.WIDE.U32, IMMA.16832.U8.U8)
    of the built library's functions whose mangled name contains every
    substring, from cuobjdump -sass."""
    counts: collections.Counter = collections.Counter()
    for section in _sass(build()).split("Function : ")[1:]:
        name, _, body = section.partition("\n")
        if all(sub in name for sub in function_substrings):
            counts.update(_SASS_OP.findall(body))
    return counts
