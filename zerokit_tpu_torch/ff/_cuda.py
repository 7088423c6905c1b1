"""Builds and loads the CUDA kernels of csrc/ (nvcc + ctypes).

The kernels compile at first use, on the machine with the card, into
build/zerokit_tpu_torch/libzk_kernels_<hash>.so, where <hash> covers the
sources and the flags: an unchanged source tree reuses the library. The
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
import time
from typing import Optional

import torch

CSRC_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "csrc"))
BUILD_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "build", "zerokit_tpu_torch")
)
SOURCES = ("bn254.cuh", "field_kernels.cu", "ntt_kernels.cu", "mont_tc.cu", "microbench.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# entry point -> argument types (the stream is the last pointer)
_SIGNATURES = {
    "zk_mont_mul": (_I, _P, _P, _P, _LL, _P),
    "zk_ec_op": (_I, _I, _P, _P, _P, _LL, _P),
    "zk_ec_scan": (_I, _I, _P, _P, _LL, _LL, _P),
    "zk_ntt_stage": (_I, _P, _P, _P, _LL, _LL, _LL, _P),
    "zk_ntt_tail": (_I, _P, _P, _P, _P, _LL, _LL, _LL, _P),
    "zk_mont_mul_tc": (_P, _P, _P, _P, _P, _LL, _P),
    "zk_chain": (_I, _P, _P, _P, _LL, _I, _P),
}

_lib: Optional[ctypes.CDLL] = None
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
    source hash exists. Records the seconds and the ptxas report in
    build_info."""
    path = library_path()
    if os.path.exists(path):
        build_info.update(path=path, seconds=0.0, built=False)
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    srcs = [os.path.join(CSRC_DIR, s) for s in SOURCES if s.endswith(".cu")]
    cmd = [_cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, *srcs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    with open(path[:-3] + "_nvcc.log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log[-8000:]}")
    os.replace(tmp, path)
    build_info.update(path=path, seconds=seconds, built=True, log=log)
    return path


def lib() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        handle.zk_error_string.argtypes = [ctypes.c_int]
        handle.zk_error_string.restype = ctypes.c_char_p
        _lib = handle
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


_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]*)")


@functools.lru_cache(maxsize=None)
def _sass(path: str) -> str:
    return subprocess.run([_cuda_tool("cuobjdump"), "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def sass_opcodes(function_substring: str) -> collections.Counter:
    """Opcode counts (with modifiers, e.g. IMAD.WIDE.U32, IMMA.16832.U8.U8)
    of the built library's functions whose mangled name contains the
    substring, from cuobjdump -sass."""
    counts: collections.Counter = collections.Counter()
    for section in _sass(build()).split("Function : ")[1:]:
        name, _, body = section.partition("\n")
        if function_substring in name:
            counts.update(_SASS_OP.findall(body))
    return counts
