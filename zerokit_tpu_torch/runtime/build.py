"""Builds the native host runtime and the C ABI: python -m zerokit_tpu_torch.runtime.build.

The libraries go into build/zerokit_tpu_torch/ (git-ignored), never over the
tracked native/*.so files; runtime/native.py searches that directory first.
"""

import os
import subprocess
import sys
import sysconfig

REPO_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
NATIVE_DIR = os.path.join(REPO_DIR, "native")
BUILD_DIR = os.path.join(REPO_DIR, "build", "zerokit_tpu_torch")
FFI_SOURCE = os.path.join(REPO_DIR, "zerokit_tpu_torch", "native", "rln_ffi.cpp")
FFI_LIBRARY = os.path.join(BUILD_DIR, "librln_ffi.so")


def build() -> str:
    srcs = [
        os.path.join(NATIVE_DIR, "rln_native.cpp"),
        os.path.join(NATIVE_DIR, "pairing.cpp"),
    ]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, "librln_native.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17", "-o", out] + srcs
    subprocess.run(cmd, check=True)
    return out


def python_flags() -> list:
    """g++ flags for a library that embeds this interpreter, from sysconfig
    (hosts without python3-config have them too): its include directories,
    and its shared libpython when there is one. A static interpreter exports
    the C API from its executable, where the symbols resolve at load time."""
    paths = sysconfig.get_paths()
    flags = [f"-I{d}" for d in dict.fromkeys((paths["include"], paths["platinclude"]))]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldlibrary = sysconfig.get_config_var("LDLIBRARY") or ""
    if ldlibrary.endswith(".so") and os.path.exists(os.path.join(libdir, ldlibrary)):
        name = ldlibrary[len("lib"):-len(".so")]
        flags += [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-l{name}"]
    return flags


def build_ffi() -> str:
    """Builds the C ABI frontend (zerokit_tpu_torch/native/rln_ffi.cpp against
    native/rln.h) into build/zerokit_tpu_torch/librln_ffi.so. The library
    imports zerokit_tpu_torch.ffi_glue, falling back to this checkout's root,
    which the build gives it (-DZK_REPO_ROOT)."""
    if any(c in REPO_DIR for c in '"\\'):
        raise ValueError(f"repository path holds a quote or a backslash: {REPO_DIR}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{FFI_LIBRARY}.{os.getpid()}.tmp"
    cmd = (
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{NATIVE_DIR}",
         f'-DZK_REPO_ROOT="{REPO_DIR}"', "-o", tmp, FFI_SOURCE]
        + python_flags()
    )
    subprocess.run(cmd, check=True)
    os.replace(tmp, FFI_LIBRARY)
    return FFI_LIBRARY


if __name__ == "__main__":
    path = build()
    print(f"built {path}", file=sys.stderr)
    path = build_ffi()
    print(f"built {path}", file=sys.stderr)
