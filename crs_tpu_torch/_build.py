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
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

__all__ = [
    "BUILD_DIR", "CSRC_DIR", "CUDA_SOURCES", "REPO_ROOT", "BuildResult", "build_cuda",
    "build_library", "nvcc_path",
]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(_PKG_DIR)
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

# Every CUDA kernel of the port: one source each, one library each
# (``lib<stem>.so``), so the nvcc runs can start together.
CUDA_SOURCES = ("int8_scan_topk.cu", "scan_topk_f32_bf16.cu", "pq_adc_scan_topk.cu",
                "segmax_scan_topk.cu", "q4_matmul.cu", "decode_attention_int8.cu",
                "fused_mlp_int8.cu", "gemv_probe.cu")


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


def _stale(sources: List[str], output: str) -> bool:
    return not os.path.exists(output) or any(
        os.path.getmtime(output) < os.path.getmtime(src) for src in sources)


class BuildResult:
    """Outcome of one build: the library path, seconds spent compiling (0.0
    when the built file was fresh) and the compiler's messages."""

    def __init__(self, path: str, seconds: float, log: str):
        self.path, self.seconds, self.log = path, seconds, log


def build_library(source: str, name: str, timeout: float = 600.0,
                  deps: Tuple[str, ...] = ()) -> BuildResult:
    """Compile ``source`` into ``BUILD_DIR/name`` when it or one of the
    headers ``deps`` is newer than the built file; raise ``RuntimeError``
    with the compiler's output when it fails."""
    output = os.path.join(BUILD_DIR, name)
    if not _stale([source, *deps], output):
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


def build_cuda(source: str) -> BuildResult:
    """Build one of :data:`CUDA_SOURCES` into ``BUILD_DIR/lib<stem>.so``."""
    if source not in CUDA_SOURCES:
        raise ValueError(f"{source} is not one of the port's CUDA sources {CUDA_SOURCES}")
    stem = os.path.splitext(source)[0]
    headers = tuple(os.path.join(CSRC_DIR, h) for h in sorted(os.listdir(CSRC_DIR))
                    if h.endswith(".cuh"))
    return build_library(os.path.join(CSRC_DIR, source), f"lib{stem}.so", deps=headers)


def build_all_cuda() -> Dict[str, BuildResult]:
    """Build every CUDA source at once (one ``nvcc`` each, all started
    together); raises the first build error."""
    with ThreadPoolExecutor(max_workers=len(CUDA_SOURCES)) as pool:
        futures = {src: pool.submit(build_cuda, src) for src in CUDA_SOURCES}
        return {src: f.result() for src, f in futures.items()}
