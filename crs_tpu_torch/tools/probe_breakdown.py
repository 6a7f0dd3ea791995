"""Where kernels 12, 13 and 14 of ``csrc/gemv_probe.cu``
(``q4_probe_kernel``, ``q8_gemv_kernel``, ``db_gemv_kernel``) spend their
time on the card.

Each kernel is timed whole and as variants with a part compiled out:
  nomma    (kernels 12, 14) the tensor-core products replaced by integer
           adds on the same registers (the unpacking and every load stay);
  copies   each ring stage waited for and released, nothing computed on it;
  compute  (kernels 13, 14) no loads: the products run on whatever shared
           memory holds;
  launch   (kernels 13, 14) the block returns at once: the launch alone.
The variants are built from the source in the checkout by replacing
anchored lines (a source that no longer holds an anchor is refused, not
measured), with the port's nvcc flags, into ``crs_tpu_torch/build/``. Each
is timed by torch.profiler as device µs a launch, its weights cycled
through copies past the 50 MB L2, as ``chip_smoke.py``'s ``gemv`` phase
times the kernels. The variants' outputs are wrong by design; the whole
build is first checked to give the port's own kernel's output bit for bit.

Usage: python -m crs_tpu_torch.tools.probe_breakdown (on the card only)
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Tuple

import torch

__all__ = ["VARIANTS", "KERNEL_VARIANTS", "variant_source", "main"]

_MMA_BEGIN = "__device__ __forceinline__ void mma_s8("
_MMA_END = "// a · b + c on bf16 pairs"
_NO_MMA = """__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
    d[0] += a[0] ^ b0, d[1] += a[1] ^ b1, d[2] += a[2] ^ b0, d[3] += a[3] ^ b1;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    d[0] += __int_as_float(a[0] ^ b0), d[1] += __int_as_float(a[1] ^ b1);
    d[2] += __int_as_float(a[2] ^ b0), d[3] += __int_as_float(a[3] ^ b1);
}

"""
# (anchor, replacement) pairs of each variant; the anchor must occur once
_EDITS = {
    "copies": [
        ("        const int c0 = ch * QP_KC;\n",
         "        const int c0 = ch * QP_KC;\n"
         "        total[0][0][0] += (float)st[tid];\n        continue;\n"),
        ("        float acc[2][4] = {};  // the tile's sums\n",
         "        float acc[2][4] = {};  // the tile's sums\n"
         "        wsum[0][0] += (float)st[tid];\n        continue;\n"),
        ("        const uint8_t* sb = smem + (size_t)(ch % slots) * S::BYTES;\n",
         "        const uint8_t* sb = smem + (size_t)(ch % slots) * S::BYTES;\n"
         "        acc[0][0][0] += (float)sb[tid];\n        continue;\n"),
    ],
    "compute": [
        ("        sm90::mbar_wait(sm90::smem_u32(&full[ch % slots]), (ch / slots) & 1);\n"
         "        __syncthreads();  // every thread has read tile ch − 1\n",
         "        __syncthreads();\n"),
        ("        for (int s = 0; s < pre; ++s) issue(s);\n", ""),
        ("            issue(ch + Q8_STAGES - 1);\n", "            ;\n"),
        ("        sm90::mbar_wait(sm90::smem_u32(&full[ch % slots]), (ch / slots) & 1);  "
         "// chunk ch landed\n", ""),
        ("        for (int c = 0; c < pre; ++c) issue(c);\n", ""),
        ("            if (tid == 0 && ch + slots - 1 < nch) issue(ch + slots - 1);\n", ""),
    ],
    "launch": [
        ("    float* red = reinterpret_cast<float*>(smem + (size_t)slots * Q8_STAGE);\n",
         "    float* red = reinterpret_cast<float*>(smem + (size_t)slots * Q8_STAGE);\n"
         "    if (R > 0) return;\n"),
        ("    const bool ring = nch > slots;\n",
         "    const bool ring = nch > slots;\n    if (R > 0) return;\n"),
    ],
}
VARIANTS = ("whole", "nomma", "copies", "compute", "launch")
KERNEL_VARIANTS = {  # the variants timed for each kernel
    "q4_probe_kernel": ("whole", "nomma", "copies"),
    "q8_gemv_kernel": ("whole", "copies", "compute", "launch"),
    "db_gemv_kernel": VARIANTS,
}
_GEMV_SHAPES = ((8, 2048), (8, 4096))  # (R, d) of kernels 13, 14: the chain tool's, and d 4096
_L2_BYTES = 50e6


def variant_source(src: str, name: str) -> str:
    """``src`` (``gemv_probe.cu``) with the part ``name`` compiles out
    removed; raises ``ValueError`` when an anchor is missing or repeated."""
    if name == "whole":
        return src
    if name == "nomma":
        a, b = src.find(_MMA_BEGIN), src.find(_MMA_END)
        if a < 0 or b < a:
            raise ValueError("gemv_probe.cu no longer holds mma_s8 before its bf16 helpers")
        return src[:a] + _NO_MMA + src[b:]
    for anchor, new in _EDITS[name]:
        if src.count(anchor) != 1:
            raise ValueError(f"variant {name}: anchor {anchor.strip()!r} occurs "
                             f"{src.count(anchor)} times in gemv_probe.cu")
        src = src.replace(anchor, new)
    return src


def _build(name: str):
    from .._build import BUILD_DIR, CSRC_DIR, compile_command
    from ..ops.launch import ARG_FLOAT, ARG_INT, ARG_PTR

    out_dir = os.path.join(BUILD_DIR, "probe_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(CSRC_DIR, "gemv_probe.cu")) as f:
        src = variant_source(f.read(), name)
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    cmd = compile_command(path, os.path.join(out_dir, f"lib{name}.so"))
    cmd[1:1] = ["-I", CSRC_DIR]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"building the {name} variant failed:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(cmd[cmd.index("-o") + 1])
    lib.q4_probe_launch.argtypes = [ARG_PTR] * 6 + [ARG_INT] * 7 + [ARG_PTR]
    lib.q8_gemv_launch.argtypes = [ARG_PTR] * 4 + [ARG_INT] * 3 + [ARG_PTR]
    lib.db_gemv_launch.argtypes = [ARG_PTR] * 3 + [ARG_INT] * 3 + [ARG_FLOAT, ARG_PTR]
    return lib


def _device_us(fn: Callable[[int], None], calls: int, kernel: str) -> float:
    """Mean device µs a launch of ``kernel`` over ``calls`` calls of
    ``fn(i)`` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA and kernel in e.name]
    if len(evs) < calls:
        raise RuntimeError(f"the profiler saw {len(evs)} of {calls} launches of {kernel}")
    return sum(e.time_range.end - e.time_range.start for e in evs) / len(evs)


def _checked(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _q4_rows(libs, dev, stream) -> Dict[str, Dict[str, float]]:
    """Kernel 12 at bench_q4_kernel's defaults (R 32, K 2048, N 32000, g 16)."""
    from ..ops import gemv_probe as gp

    g = torch.Generator(device=dev)
    g.manual_seed(12)
    rt, k2, n, grp = 32, 1024, 32000, 16
    gs2, gpt = gp.probe_tiles(k2, grp)
    codes = torch.randint(-128, 128, (k2, n), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
    scales = torch.rand((grp, n), generator=g, device=dev) * 0.015 + 0.005
    xs = torch.rand((rt, 1), generator=g, device=dev) + 0.5
    xi = torch.randint(-20, 20, (2, rt, k2), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    copies = [(codes.clone(), scales.clone())
              for _ in range(max(1, math.ceil(3 * _L2_BYTES / codes.numel())))]
    out = torch.empty((rt, n), device=dev)
    rows = {}
    for var, fold in (("i32", 0), ("fold_i32", 1)):
        xe, xo = (xi[0].to(torch.bfloat16), xi[1].to(torch.bfloat16)) if fold else (xi[0], xi[1])

        def call(lib, i, xe=xe, xo=xo, fold=fold):
            c, s = copies[i % len(copies)]
            _checked(lib.q4_probe_launch(xe.data_ptr(), xo.data_ptr(), xs.data_ptr(), c.data_ptr(),
                                         s.data_ptr(), out.data_ptr(), rt, k2, n, gs2, gpt, fold,
                                         0, stream), "q4_probe_launch")
        call(libs["whole"], 0)
        want = gp.q4_probe_matmul(xe, xo, xs, *copies[0], unpack="i32", fold=bool(fold))
        if not torch.equal(out, want):
            raise AssertionError(f"the whole {var} build differs from the port's kernel")
        rows[var] = {name: _device_us(lambda i, lib=libs[name]: call(lib, i),
                                      max(20, len(copies)), "q4_probe_kernel")
                     for name in KERNEL_VARIANTS["q4_probe_kernel"]}
    return rows


def _q8_rows(libs, dev, stream) -> Dict[str, Dict[str, float]]:
    """Kernel 13 at the chain tool's layer (R 8, d 2048) and at d 4096."""
    from ..ops import gemv_probe as gp

    g = torch.Generator(device=dev)
    g.manual_seed(13)
    rows = {}
    for r, d in _GEMV_SHAPES:
        codes = torch.randint(-127, 128, (d, d), generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
        sc = torch.full((d,), 1e-2 / d ** 0.5, device=dev)
        x = torch.randn((r, d), generator=g, device=dev).to(torch.bfloat16)
        copies = [codes.clone() for _ in range(max(1, math.ceil(3 * _L2_BYTES / codes.numel())))]
        out = torch.empty((r, d), device=dev)

        def call(lib, i, x=x, sc=sc, out=out, copies=copies, r=r, d=d):
            _checked(lib.q8_gemv_launch(x.data_ptr(), copies[i % len(copies)].data_ptr(),
                                        sc.data_ptr(), out.data_ptr(), r, d, d, stream),
                     "q8_gemv_launch")
        call(libs["whole"], 0)
        if not torch.equal(out, gp.q8_gemv(x, copies[0], sc)):
            raise AssertionError(f"the whole q8 build differs from the port's kernel at R {r}")
        rows[f"R={r} d={d}"] = {name: _device_us(lambda i, lib=libs[name]: call(lib, i),
                                                 max(20, len(copies)), "q8_gemv_kernel")
                                for name in KERNEL_VARIANTS["q8_gemv_kernel"]}
    return rows


def _db_rows(libs, dev, stream) -> Dict[str, Dict[str, float]]:
    """Kernel 14 at the chain tool's layer (R 8, d 2048) and at d 4096."""
    from ..ops import gemv_probe as gp

    g = torch.Generator(device=dev)
    g.manual_seed(14)
    rows = {}
    for r, d in _GEMV_SHAPES:
        codes = torch.randint(-127, 128, (d, d), generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
        x = torch.randn((r, d), generator=g, device=dev).to(torch.bfloat16)
        scale = 1e-2 / d ** 0.5
        copies = [codes.clone() for _ in range(max(1, math.ceil(3 * _L2_BYTES / codes.numel())))]
        out = torch.empty((r, d), device=dev)

        def call(lib, i, x=x, scale=scale, out=out, copies=copies, r=r, d=d):
            _checked(lib.db_gemv_launch(x.data_ptr(), copies[i % len(copies)].data_ptr(),
                                        out.data_ptr(), r, d, d, scale, stream), "db_gemv_launch")
        call(libs["whole"], 0)
        if not torch.equal(out, gp.db_gemv(x, copies[0], scale)):
            raise AssertionError(f"the whole db build differs from the port's kernel at R {r}")
        rows[f"R={r} d={d}"] = {name: _device_us(lambda i, lib=libs[name]: call(lib, i),
                                                 max(20, len(copies)), "db_gemv_kernel")
                                for name in KERNEL_VARIANTS["db_gemv_kernel"]}
    return rows


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_breakdown times kernels on the card: no CUDA device")
    dev = torch.device("cuda")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc a variant, started together
        libs = dict(zip(VARIANTS, pool.map(_build, VARIANTS)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    res = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
           "unit": "device µs a launch (torch.profiler), weights past the L2",
           "q4_probe_kernel": _q4_rows(libs, dev, stream),
           "q8_gemv_kernel": _q8_rows(libs, dev, stream),
           "db_gemv_kernel": _db_rows(libs, dev, stream)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
