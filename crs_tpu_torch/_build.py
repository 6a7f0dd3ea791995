"""Build native sources of the port into its own git-ignored build directory.

Each library is compiled at first use from the sources in the repository and
rebuilt when its source is newer than the built file. The compiler writes to
a per-process temporary name that is then renamed into place, so concurrent
first uses (test workers) never load a half-written file.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from typing import List

__all__ = ["BUILD_DIR", "REPO_ROOT", "BuildResult", "build_library", "nvcc_path"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(_PKG_DIR)
BUILD_DIR = os.path.join(_PKG_DIR, "build")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def compile_command(source: str, output: str) -> List[str]:
    """Compiler command for ``source``: ``nvcc`` for ``.cu`` (plain C
    interface, ``sm_90a``, no PyTorch headers), ``g++`` otherwise."""
    if source.endswith(".cu"):
        return [
            nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", output, source,
        ]
    return ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", source, "-o", output]


def _stale(source: str, output: str) -> bool:
    return not os.path.exists(output) or os.path.getmtime(output) < os.path.getmtime(source)


class BuildResult:
    """Outcome of one build: the library path, seconds spent compiling (0.0
    when the built file was fresh) and the compiler's messages."""

    def __init__(self, path: str, seconds: float, log: str):
        self.path, self.seconds, self.log = path, seconds, log


def build_library(source: str, name: str, timeout: float = 600.0) -> BuildResult:
    """Compile ``source`` into ``BUILD_DIR/name`` when stale; raise
    ``RuntimeError`` with the compiler's output when it fails."""
    output = os.path.join(BUILD_DIR, name)
    if not _stale(source, output):
        return BuildResult(output, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{output}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            compile_command(source, tmp), capture_output=True, text=True, timeout=timeout
        )
    except FileNotFoundError as e:
        raise RuntimeError(f"compiler for {source} not found: {e}") from e
    log = (proc.stdout or "") + (proc.stderr or "")
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building {source} failed (rc {proc.returncode}):\n{log}")
    os.replace(tmp, output)
    return BuildResult(output, time.perf_counter() - t0, log)

