"""Builds the native host runtime: python -m zerokit_tpu_torch.runtime.build.

The library goes into build/zerokit_tpu_torch/ (git-ignored), never over the
tracked native/*.so files; runtime/native.py searches that directory first.
"""

import os
import subprocess
import sys

REPO_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
NATIVE_DIR = os.path.join(REPO_DIR, "native")
BUILD_DIR = os.path.join(REPO_DIR, "build", "zerokit_tpu_torch")


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


if __name__ == "__main__":
    path = build()
    print(f"built {path}", file=sys.stderr)
