"""The port of the decode weight-streaming tools (``crs_tpu_torch/tools/``)
and their three kernels (``crs_tpu_torch/ops/gemv_probe.py``) against the
JAX tools ``tools/bench_q4_kernel.py`` and ``tools/bench_chain_gemv.py``.

The JAX kernels run in Pallas interpret mode, as the tools run them off the
TPU. Kernels 12 and 13's register arithmetic (byte permutes, bf16 bit
tricks, the mma fragment layouts) is restated in numpy and held to the
plain arithmetic exactly, and the variants ``crs_tpu_torch.tools.probe_breakdown``
compiles must build from the kernels' own source. ``_q4_kernel_var`` is imported from its tool by path; ``k8`` / ``q8mm``
and ``kdb`` / ``dbmm`` are closures inside ``bench_chain_gemv.main()``, so
they are restated here from ``tools/bench_chain_gemv.py:150-186,205-260``.
The port runs its plain versions, which its wrappers take for CPU tensors.

Tolerances:
- the unfolded int4 probe: |port − JAX| ≤ 1e-6·max|out| (exact int32 group
  sums; f32 products and sums in the same order);
- the fold probe and the W8A16 GEMVs: ≤ 1e-5·Σ|x·w| (bf16 × bf16 products
  are exact in f32, only the order of the f32 sums differs);
- the chains (d 1024, 2 layers, R 8, one repetition): |port − JAX| ≤ tol ·
  max|JAX| with tol 1e-5 where every layer is exact (int8, i4native), 1e-3
  where x is rounded to bf16 each layer after f32 sums in another order (q4,
  q8pallas, pldb), 1e-2 for dq4 (the port's bf16 ``torch.matmul`` rounds its
  output to bf16, XLA's dot keeps f32).
"""

import importlib.util
import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _load_tool(name: str):
    """A JAX tool of ``tools/`` as a module (it adds the repo to sys.path)."""
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jq():
    return _load_tool("bench_q4_kernel")


CPU = torch.device("cpu")
SUM_RTOL = 1e-5
Q4_VARIANTS = ["i32", "i16", "none", "fold_i32", "fold_i16"]
# (R, K, N, g): gpt 8 in one K-step (the tiled fold scale shows), gpt 4 over
# two K-steps, gpt 1 over two K-steps; groups of 16 and 4 packed rows (gs2
# below the kernel's 32-row products: masked B words), gpt 32 and 128 (a
# fold scale row that changes within a 16-row piece)
Q4_SHAPES = [(8, 1024, 512, 8), (8, 2048, 512, 8), (8, 2048, 512, 2), (8, 2048, 512, 64),
             (8, 2048, 512, 256)]


def _split(var):
    fold = var.startswith("fold_")
    return (var.split("_")[-1] if fold else var), fold


def _jax_probe(jq, r, k, n, g, unpack, fold, xe, xo, xs, codes, scales):
    """build_variant's pallas_call (tools/bench_q4_kernel.py:90-116) with its
    grid and specs, returning the whole [rt, N] output instead of its sum."""
    k2 = k // 2
    gs2 = k2 // g
    gpt = 1
    for cand in range(g, 0, -1):
        if g % cand == 0 and cand * gs2 <= 512 and (cand * gs2) % 128 == 0:
            gpt = cand
            break
    kt2 = gpt * gs2
    rt = max(32, -(-r // 32) * 32)
    nt = 512
    return np.asarray(pl.pallas_call(
        partial(jq._q4_kernel_var, gpt=gpt, gs2=gs2, unpack=unpack, fold=fold),
        grid=(rt // rt, n // nt, k2 // kt2),
        in_specs=[
            pl.BlockSpec((rt, kt2), lambda i, j, kk: (i, kk), memory_space=pltpu.VMEM),
            pl.BlockSpec((rt, kt2), lambda i, j, kk: (i, kk), memory_space=pltpu.VMEM),
            pl.BlockSpec((rt, 1), lambda i, j, kk: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((kt2, nt), lambda i, j, kk: (kk, j), memory_space=pltpu.VMEM),
            pl.BlockSpec((g, nt), lambda i, j, kk: (0, j), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((rt, nt), lambda i, j, kk: (i, j), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rt, n), jnp.float32),
        interpret=True,
    )(xe, xo, xs, codes, scales))


def _probe_operands(r, k, n, g, fold, seed):
    """Random operands for both packages; random scales, so a fold that
    takes the wrong scale row shows."""
    rng = np.random.default_rng(seed)
    rt, k2 = max(32, -(-r // 32) * 32), k // 2
    xe, xo = (rng.integers(-20, 20, (rt, k2)) for _ in range(2))
    xs = (rng.random((rt, 1)) + 0.5).astype(np.float32)
    codes = rng.integers(-128, 128, (k2, n)).astype(np.int8)
    scales = (rng.random((g, n)) * 0.015 + 0.005).astype(np.float32)
    jdt = jnp.bfloat16 if fold else jnp.int8
    tdt = torch.bfloat16 if fold else torch.int8
    jax_ops = (jnp.asarray(xe, jdt), jnp.asarray(xo, jdt), jnp.asarray(xs), jnp.asarray(codes),
               jnp.asarray(scales))
    port_ops = (torch.from_numpy(xe).to(tdt), torch.from_numpy(xo).to(tdt), torch.from_numpy(xs),
                torch.from_numpy(codes), torch.from_numpy(scales))
    return jax_ops, port_ops


@pytest.mark.parametrize("shape", Q4_SHAPES, ids=lambda s: "R%d-K%d-N%d-g%d" % s)
@pytest.mark.parametrize("var", Q4_VARIANTS)
def test_q4_probe_plain_matches_pallas(jq, var, shape):
    from crs_tpu_torch.ops import gemv_probe as gp

    r, k, n, g = shape
    unpack, fold = _split(var)
    jax_ops, port_ops = _probe_operands(r, k, n, g, fold, seed=k + g)
    want = _jax_probe(jq, r, k, n, g, unpack, fold, *jax_ops)
    got = gp.q4_probe_matmul(*port_ops, unpack=unpack, fold=fold).numpy()
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.float64) - want)
    if not fold:
        assert diff.max() <= 1e-6 * np.abs(want).max(), diff.max()
        return
    xe, xo, xs, codes, scales = port_ops
    wlo, whi = gp.fold_weights(codes, scales, unpack)
    abs_sum = ((xe.float().abs() @ wlo.float().abs() + xo.float().abs() @ whi.float().abs())
               * xs).numpy()
    assert (diff <= SUM_RTOL * abs_sum).all(), (diff / abs_sum).max()
    gs2, gpt = gp.probe_tiles(k // 2, g)
    if gpt > 1:  # each row its own group's scale (kernel 8's mapping) misses the TPU kernel
        own = torch.repeat_interleave(scales, gs2, 0).to(torch.bfloat16)
        lo, hi = gp._nibbles(codes, unpack)
        kt2 = gpt * gs2
        miss = torch.zeros_like(torch.from_numpy(got))
        for s in range(k // 2 // kt2):
            ks = slice(s * kt2, (s + 1) * kt2)
            miss = miss + (xe[:, ks].float() @ (lo[ks].to(torch.bfloat16) * own[ks]).float()
                           + xo[:, ks].float() @ (hi[ks].to(torch.bfloat16) * own[ks]).float()) * xs
        assert np.abs(miss.numpy() - want).max() > 1e3 * SUM_RTOL * abs_sum.max()


@pytest.mark.parametrize("var", Q4_VARIANTS + ["int8"])
def test_q4_tool_sums_match_the_jax_tool(jq, var):
    """The port's build_variant (and the int8 variant) on the JAX tool's own
    draws: the summed [rt, N] output equals the JAX tool's run(*args)."""
    from crs_tpu_torch.tools import bench_q4_kernel as pq

    r, k, n, g = 8, 1024, 1024, 8
    if var == "int8":
        from crs_tpu.models.quantized import _int8_act_matmul

        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal((r, k)), jnp.float32)
        codes = jnp.asarray(rng.integers(-127, 128, (k, n)), jnp.int8)
        want = float(jax.jit(lambda a, b: _int8_act_matmul(a, b, jnp.full((n,), 0.01)).sum())(
            x, codes))
        run, args = pq.int8_variant(r, k, n, device="cpu")
        scale = float(np.abs(np.asarray(_int8_act_matmul(x, codes, jnp.full((n,), 0.01)))).sum())
    else:
        unpack, fold = _split(var)
        jrun, jargs = jq.build_variant(r, k, n, g, unpack=unpack, fold=fold)
        want = float(jrun(*jargs))
        run, args = pq.build_variant(r, k, n, g, unpack=unpack, fold=fold, device="cpu")
        for a, b in zip(args, jargs):  # the same draws
            assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))
        from crs_tpu_torch.ops.gemv_probe import q4_probe_matmul

        scale = float(q4_probe_matmul(*args, unpack=unpack, fold=fold).abs().sum())
    got = float(run(*args))
    assert abs(got - want) <= SUM_RTOL * scale, (got, want)


# -- rows 13 and 14: k8 / q8mm and kdb / dbmm, restated ---------------------------------

def _jax_q8mm(d):
    """tools/bench_chain_gemv.py:150-186 (k8 and q8mm), restated."""
    kt, nt = 512, 512

    def k8(x_ref, codes_ref, scales_ref, out_ref):
        kstep = pl.program_id(2)
        w = codes_ref[:].astype(jnp.bfloat16)
        acc = jax.lax.dot_general(
            x_ref[:], w,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )

        @pl.when(kstep == 0)
        def _():
            out_ref[:] = acc * scales_ref[0, :][None, :]

        @pl.when(kstep > 0)
        def _():
            out_ref[:] = out_ref[:] + acc * scales_ref[0, :][None, :]

    rt8 = 16

    def q8mm(x, codes, scales):
        rr = x.shape[0]
        xp = jnp.pad(x.astype(jnp.bfloat16), ((0, rt8 - rr), (0, 0)))
        o = pl.pallas_call(
            k8,
            grid=(1, d // nt, d // kt),
            in_specs=[
                pl.BlockSpec((rt8, kt), lambda i, j, kk: (i, kk), memory_space=pltpu.VMEM),
                pl.BlockSpec((kt, nt), lambda i, j, kk: (kk, j), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, nt), lambda i, j, kk: (0, j), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((rt8, nt), lambda i, j, kk: (i, j), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((rt8, d), jnp.float32),
            interpret=jax.default_backend() != "tpu",
        )(xp, codes, scales)
        return o[:rr]

    return q8mm


def _jax_dbmm(d):
    """tools/bench_chain_gemv.py:205-260 (kdb and dbmm), restated."""
    ck = 512
    nchunks = d // ck
    rt = 8

    def kdb(x_ref, w_hbm, out_ref):
        def body(scratch, sems):
            def get_dma(slot, ci):
                return pltpu.make_async_copy(
                    w_hbm.at[pl.ds(ci * ck, ck)],
                    scratch.at[slot],
                    sems.at[slot],
                )

            get_dma(0, 0).start()

            def loop(ci, _):
                slot = ci % 2

                @pl.when(ci + 1 < nchunks)
                def _():
                    get_dma((ci + 1) % 2, ci + 1).start()

                get_dma(slot, ci).wait()
                w = scratch[slot].astype(jnp.bfloat16)  # [ck, d]
                acc = jax.lax.dot_general(
                    x_ref[:], w,
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )  # [rt, ck]
                out_ref[ci] = acc
                return 0

            jax.lax.fori_loop(0, nchunks, loop, 0)

        pl.run_scoped(
            body,
            scratch=pltpu.VMEM((2, ck, d), jnp.int8),
            sems=pltpu.SemaphoreType.DMA((2,)),
        )

    def dbmm(x, codes):
        rr = x.shape[0]
        xp = jnp.pad(x.astype(jnp.bfloat16), ((0, rt - rr), (0, 0)))
        o = pl.pallas_call(
            kdb,
            in_specs=[
                pl.BlockSpec(memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pl.ANY),
            ],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct(
                (nchunks, rt, ck), jnp.float32),
            interpret=jax.default_backend() != "tpu",
        )(xp, codes)
        # [nchunks, rt, ck] -> [rr, d]
        return o.transpose(1, 0, 2).reshape(rt, d)[:rr] * (1e-2 / d**0.5)

    return dbmm


GEMV_D = 1024  # two K tiles (q8mm) and two weight chunks (dbmm)


@pytest.mark.parametrize("r", [8, 1, 16, 3])
def test_q8_gemv_plain_matches_pallas(r):
    from crs_tpu_torch.ops import gemv_probe as gp

    d = GEMV_D
    rng = np.random.default_rng(13 + r)
    x = rng.standard_normal((r, d)).astype(np.float32)
    codes = rng.integers(-127, 128, (d, d)).astype(np.int8)
    scales = (rng.random((1, d)) * 0.02 + 0.01).astype(np.float32)
    want = np.asarray(jax.jit(_jax_q8mm(d))(jnp.asarray(x), jnp.asarray(codes),
                                            jnp.asarray(scales)))
    tx, tc, ts = (torch.from_numpy(a) for a in (x, codes, scales))
    got = gp.q8_gemv(tx, tc, ts).numpy()
    abs_sum = ((tx.to(torch.bfloat16).float().abs() @ tc.float().abs()) * ts).numpy()
    assert got.shape == want.shape == (r, d)
    assert (np.abs(got - want) <= SUM_RTOL * abs_sum).all()


@pytest.mark.parametrize("r", [8, 1, 3, 5])
def test_db_gemv_plain_matches_pallas(r):
    from crs_tpu_torch.ops import gemv_probe as gp

    d = GEMV_D
    rng = np.random.default_rng(14 + r)
    x = rng.standard_normal((r, d)).astype(np.float32)
    codes = rng.integers(-127, 128, (d, d)).astype(np.int8)
    want = np.asarray(jax.jit(_jax_dbmm(d))(jnp.asarray(x), jnp.asarray(codes)))
    tx, tc = torch.from_numpy(x), torch.from_numpy(codes)
    scale = 1e-2 / d ** 0.5
    got = gp.db_gemv(tx, tc, scale).numpy()
    abs_sum = ((tx.to(torch.bfloat16).float().abs() @ tc.float().abs().T) * scale).numpy()
    assert got.shape == want.shape == (r, d)
    assert (np.abs(got - want) <= SUM_RTOL * abs_sum).all()


# -- kernels 12 and 13's register arithmetic, mirrored ----------------------------------------
# csrc/gemv_probe.cu builds the tensor cores' B fragments with byte permutes
# and bit masks; these tests restate those steps in numpy and hold them to
# the plain arithmetic.

def _byte_perm(a: int, b: int, sel: int) -> int:
    """CUDA's __byte_perm (default mode): byte i of the result is byte
    (sel >> 4i) & 7 of the 8 bytes b:a."""
    src = (b << 32) | a
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _bf16_bits_to_float(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32).astype(np.float64)


def _transpose4(w):  # gemv_probe.cu transpose4
    lo01, lo23 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[2], w[3], 0x5140)
    hi01, hi23 = _byte_perm(w[0], w[1], 0x7362), _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
            _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]


def _pair_bytes(a, b, c):  # gemv_probe.cu pair_bytes: byte c of a, of b in bytes 0, 2
    return _byte_perm(a, b, c | (c << 4) | ((c + 4) << 8) | ((c + 4) << 12))


@pytest.mark.parametrize("trick", ["s8_pair_bf16", "s4_pair_bf16", "sixteen_nibbles",
                                   "the_source_uses_them"])
def test_kernel_bit_tricks_are_exact(trick):
    if trick == "the_source_uses_them":  # the mirrored constants are the kernels'
        src = (REPO / "crs_tpu_torch" / "csrc" / "gemv_probe.cu").read_text()
        for lit in ("0x5140", "0x7362", "0x5410", "0x7632", "(c + 4) << 8", "0x007F007Fu",
                    "0x00800080u", "0x43004300u", "0x000F000Fu", "0x43084308u", "0xC308C308u",
                    "0xF0F0F0F0u", "0x4140", "0x4342"):
            assert lit in src, lit
        return
    b = np.arange(256, dtype=np.uint32)
    signed = b.astype(np.uint8).view(np.int8).astype(np.int64)
    if trick == "s8_pair_bf16":  # (128 + low 7 bits) − (128 or 256): the byte as a bf16
        mag = _bf16_bits_to_float((b & 0x7F) | 0x4300)
        sgn = _bf16_bits_to_float((b & 0x80) | 0x4300)
        assert np.array_equal(mag - sgn, signed)
    elif trick == "s4_pair_bf16":  # (128 + (nibble ^ 8)) − 136: the signed nibble
        for nib, want in ((b & 0xF, (signed << 60) >> 60), (b >> 4, signed >> 4)):
            m = _bf16_bits_to_float((nib ^ 8) | 0x4300)
            assert np.array_equal(m - 136, want)
        # × the bf16 scale, one rounding: the plain version's bf16 product
        rng = np.random.default_rng(0)
        sc = torch.from_numpy(rng.random(64).astype(np.float32) * 0.02 + 1e-3).to(torch.bfloat16)
        v = torch.arange(-8, 8, dtype=torch.float64)
        exact = (v[:, None] * sc.double()[None, :]).float().to(torch.bfloat16)
        assert torch.equal(exact, v.to(torch.bfloat16)[:, None] * sc[None, :])
    else:  # (w << 4) & 0xF0, w & 0xF0: 16 × each nibble, as int8
        lo = ((b << 4) & 0xF0).astype(np.uint8).view(np.int8).astype(np.int64)
        hi = (b & 0xF0).astype(np.uint8).view(np.int8).astype(np.int64)
        assert np.array_equal(lo, 16 * ((signed << 60) >> 60))
        assert np.array_equal(hi, 16 * (signed >> 4))
        assert np.array_equal(lo >> 4, (signed << 60) >> 60)  # shifted back: exact


def _s8_pair_values(w: int):
    """gemv_probe.cu s8_pair_bf16: bytes 0 and 2 of w as the bf16 pair (low
    half, high half), 128 + the low 7 bits less 128 + the sign bit's 128."""
    halves = [w & 0xFFFF, w >> 16]
    mag = _bf16_bits_to_float([(h & 0x7F) | 0x4300 for h in halves])
    sgn = _bf16_bits_to_float([(h & 0x80) | 0x4300 for h in halves])
    return mag - sgn


def _db_piece_product(tiles: int):
    """db_gemv_kernel's piece (16·tiles weight rows × 128 k against 8 rows of
    x), from a stage laid out as its TMA boxes land (128-byte swizzle:
    16-byte chunk c of row r at chunk c ^ r % 8; the weight box, then x boxes
    of 64 bf16) and read as the lanes read it: lane (g, t) takes weight
    chunks 2t + (h ^ (t >> 1)) of rows g + 8i and x chunks 4(t & 1) + (q ^
    2(t >> 1)) of row g in x box t >> 1; product (mt, h, j) takes word j of
    weight read h of rows 16·mt + g, + 8 (bytes 0, 1 → a0 / a1, bytes 2, 3 →
    a2 / a3) and half j % 2 of x read 2h + j / 2 (b0, b1). Each 8-lane phase
    of a 16-byte read must hit 8 distinct bank groups."""
    rng = np.random.default_rng(14)
    rows = 16 * tiles
    w = rng.integers(-128, 128, (rows, 128))
    x = rng.integers(-20, 20, (8, 128))
    wbytes = rows * 128
    smem = np.zeros(wbytes + 2 * 1024, np.uint8)
    for r in range(rows):
        for c in range(8):
            dst = r * 128 + ((c ^ (r % 8)) << 4)
            smem[dst:dst + 16] = w[r, 16 * c:16 * c + 16].astype(np.int8).view(np.uint8)
    xbits = (x.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)  # exact bf16
    for b in range(2):
        for r in range(8):
            for c in range(8):
                dst = wbytes + b * 1024 + r * 128 + ((c ^ r) << 4)
                smem[dst:dst + 16] = xbits[r, 64 * b + 8 * c:64 * b + 8 * c + 8].view(np.uint8)

    def read16(off):
        return [int(v) for v in smem[off:off + 16].view("<u4")]

    offs = {}  # (read, lane) → byte offset
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for h in range(2):
            for i in range(2 * tiles):
                offs[("w", h, i), lane] = g * 128 + (((2 * t + (h ^ (t >> 1))) ^ g) << 4) + 1024 * i
        for q in range(4):
            offs[("x", q), lane] = wbytes + (t >> 1) * 1024 + g * 128 + (
                ((4 * (t & 1) + (q ^ (2 * (t >> 1)))) ^ g) << 4)
    for read in {k for k, _ in offs}:
        for phase in range(4):
            groups = {(offs[read, lane] >> 4) % 8 for lane in range(8 * phase, 8 * phase + 8)}
            assert len(groups) == 8, (read, phase)
    D = np.zeros((rows, 8))
    for mt in range(tiles):
        for h in range(2):
            for j in range(4):
                A, B = np.zeros((16, 16)), np.zeros((16, 8))
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    a0w = read16(offs[("w", h, 2 * mt), lane])[j]
                    a1w = read16(offs[("w", h, 2 * mt + 1), lane])[j]
                    A[g, 2 * t:2 * t + 2] = _s8_pair_values(_byte_perm(a0w, 0, 0x4140))
                    A[g + 8, 2 * t:2 * t + 2] = _s8_pair_values(_byte_perm(a1w, 0, 0x4140))
                    A[g, 8 + 2 * t:10 + 2 * t] = _s8_pair_values(_byte_perm(a0w, 0, 0x4342))
                    A[g + 8, 8 + 2 * t:10 + 2 * t] = _s8_pair_values(_byte_perm(a1w, 0, 0x4342))
                    x4 = read16(offs[("x", 2 * h + (j >> 1)), lane])
                    b0, b1 = x4[2 * (j & 1)], x4[2 * (j & 1) + 1]
                    B[2 * t:2 * t + 2, g] = _bf16_bits_to_float([b0 & 0xFFFF, b0 >> 16])
                    B[8 + 2 * t:10 + 2 * t, g] = _bf16_bits_to_float([b1 & 0xFFFF, b1 >> 16])
                D[16 * mt:16 * mt + 16] += A @ B  # the PTX rule: D[m][n] = Σ_k A[m][k]·B[k][n]
    return D, w @ x.T


@pytest.mark.parametrize("form", ["s8_m16n8k32", "bf16_m16n8k16", "db_bf16_m16n8k16",
                                  "db_bf16_m16n8k16_two_tiles"])
def test_fragment_layouts_compute_the_product(form):
    """One warp's 32 columns of one product, from the lanes' code words as
    the kernels read them: unfolded probe (m16n8k32 s8: a lane reads rows 4t
    + q and 16 + 4t + q, transposed), fold probe and W8A16 GEMV (m16n8k16:
    rows 2t, 2t + 1, 8 + 2t, 9 + 2t, paired by byte). B of n8 tile c holds
    column 4g + c at tile column g; the lane's sums land in columns 8t .. 8t
    + 7. The mma is the PTX fragment rule: D[m][n] = Σ_k A[m][k]·B[k][n]
    with B[k][n] from lane (n, k-quad). The row-major GEMV (db) sums a piece
    of 128 k with the weight as A and x as B, K permuted alike in both
    (:func:`_db_piece_product`), with one m16 tile or two (32 weight rows)."""
    if form.startswith("db_"):
        got, want = _db_piece_product(2 if form.endswith("two_tiles") else 1)
        assert np.array_equal(got, want)
        return
    rng = np.random.default_rng(5)
    k = 32 if form == "s8_m16n8k32" else 16
    codes = rng.integers(0, 256, (k, 32)).astype(np.uint32)  # a stage's rows × 32 columns
    a = rng.integers(-20, 20, (16, k))

    def words(r, g):  # the 4-byte word of row r, columns 4g .. 4g + 3
        return sum(int(codes[r, 4 * g + i]) << (8 * i) for i in range(4))

    def val(byte):  # a code byte as int8
        return byte - 256 if byte > 127 else byte

    B = np.zeros((4, k, 8), np.int64)  # [n8 tile c, k, tile column g]
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        if form == "s8_m16n8k32":
            c0 = _transpose4([words(4 * t + q, g) for q in range(4)])
            c1 = _transpose4([words(16 + 4 * t + q, g) for q in range(4)])
            for c in range(4):  # b0: k 4t..4t+3, b1: k 16+4t..
                for i in range(4):
                    B[c, 4 * t + i, g] = val((c0[c] >> (8 * i)) & 0xFF)
                    B[c, 16 + 4 * t + i, g] = val((c1[c] >> (8 * i)) & 0xFF)
        else:
            w = [words(r, g) for r in (2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t)]
            for c in range(4):  # b0: k 2t, 2t+1 (low, high half), b1: k 8+2t, 9+2t
                p0, p1 = _pair_bytes(w[0], w[1], c), _pair_bytes(w[2], w[3], c)
                B[c, 2 * t, g], B[c, 2 * t + 1, g] = val(p0 & 0xFF), val((p0 >> 16) & 0xFF)
                B[c, 8 + 2 * t, g], B[c, 9 + 2 * t, g] = val(p1 & 0xFF), val((p1 >> 16) & 0xFF)
    D = np.einsum("mk,ckn->cmn", a, B)  # each n8 tile's 16 × 8 sums
    got = np.zeros((16, 32), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for c in range(4):
            for e in range(4):  # d0, d1: row g, tile columns 2t, 2t+1; d2, d3: row g + 8
                row, tcol = g + 8 * (e >> 1), 2 * t + (e & 1)
                assert 4 * tcol + c == 8 * t + 4 * (e & 1) + c  # the lane's 8 adjacent columns
                got[row, 4 * tcol + c] = D[c, row, tcol]
    want = a @ codes.astype(np.uint8).view(np.int8).astype(np.int64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["whole", "nomma", "copies", "compute", "launch"])
def test_probe_breakdown_variants_come_from_the_source(name):
    """crs_tpu_torch.tools.probe_breakdown compiles parts out of the kernels'
    own source: each variant's anchors hold in it, and a source without
    them is refused rather than measured."""
    from crs_tpu_torch.tools.probe_breakdown import KERNEL_VARIANTS, variant_source

    src = (REPO / "crs_tpu_torch" / "csrc" / "gemv_probe.cu").read_text()
    out = variant_source(src, name)
    assert (out == src) == (name == "whole")
    if name != "whole":
        with pytest.raises(ValueError):
            variant_source(src[:src.index("namespace {")], name)  # the header alone

    def body(text, kernel):  # a kernel's section of the source, up to the next one
        start = text.index(f"// -- {kernel} ")
        ends = [e for e in (text.find("\n// -- ", start), text.find("}  // namespace", start))
                if e > 0]
        return text[start:min(ends)]

    for kernel, names in KERNEL_VARIANTS.items():  # each timed variant edits its kernel
        if name in names and name not in ("whole", "nomma"):  # nomma edits the mma helpers
            assert body(out, kernel) != body(src, kernel), kernel


# -- the slice as a whole: the chain --------------------------------------------------------

CHAIN = {"d": 1024, "layers": 2, "r": 8, "g": 16}
CHAIN_TOL = {"int8": 1e-5, "i4native": 1e-5, "q4": 1e-3, "q8pallas": 1e-3, "pldb": 1e-3,
             "dq4": 1e-2}


def _jax_chains(variants, d, L, r, g, reps=1):
    """x after ``reps`` repetitions of the JAX tool's chain for each variant,
    every operand drawn as tools/bench_chain_gemv.py:53-263 draws it; its
    steps with crs_tpu's _int8_act_matmul, q4_matmul, QuantizedTensor and
    the restated q8mm / dbmm."""
    from crs_tpu.models.quantized import QuantizedTensor, _int8_act_matmul
    from crs_tpu.ops.qgemm import q4_matmul

    def run(step, ws, x):
        @jax.jit
        def f(x, ws):
            def body(i, x):
                def layer(xc, w):
                    return step(xc, w), None

                x, _ = jax.lax.scan(layer, x, ws)
                return x * jax.lax.rsqrt(jnp.mean(jnp.square(x)) + 1e-6)

            return jax.lax.fori_loop(0, reps, body, x)

        return np.asarray(f(x, ws))

    rng = np.random.default_rng(0)
    x0 = jnp.asarray(rng.standard_normal((r, d)), jnp.float32)
    out = {}
    for var in variants:
        if var == "int8":
            ws = {"codes": jnp.asarray(rng.integers(-127, 128, (L, d, d)), jnp.int8),
                  "scales": jnp.full((L, d), 1e-2 / d**0.5, jnp.float32)}
            out[var] = run(lambda x, w: _int8_act_matmul(x, w["codes"], w["scales"]), ws, x0)
        elif var in ("q4", "dq4"):
            ws = {"codes": jnp.asarray(rng.integers(-128, 128, (L, d // 2, d)), jnp.int8),
                  "scales": jnp.full((L, g, d), 1e-2 / d**0.5, jnp.float32)}
            if var == "q4":
                out[var] = run(lambda x, w: q4_matmul(x, w["codes"], w["scales"]), ws, x0)
            else:
                def stepdq(x, w):
                    qt = QuantizedTensor(w["codes"], w["scales"], 4, d // g, (d, d))
                    return jnp.dot(x.astype(jnp.bfloat16), qt.dequantize().astype(jnp.bfloat16),
                                   preferred_element_type=jnp.float32)

                out[var] = run(stepdq, ws, x0)
        elif var == "i4native":
            ws = {"codes": jnp.asarray(rng.integers(-8, 8, (L, d, d)), jnp.int4)}
            rng.integers(-100, 100, (r, d))  # xq0

            def stepi4(x, w):
                acc = jax.lax.dot_general(x.astype(jnp.int8), w["codes"],
                                          dimension_numbers=(((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32)
                return acc.astype(jnp.float32) * (1e-2 / d**0.5)

            out[var] = run(stepi4, ws, x0)
        elif var == "q8pallas":
            q8mm = _jax_q8mm(d)
            ws = {"codes": jnp.asarray(rng.integers(-127, 128, (L, d, d)), jnp.int8),
                  "scales": jnp.full((L, 1, d), 1e-2 / d**0.5, jnp.float32)}
            out[var] = run(lambda x, w: q8mm(x, w["codes"], w["scales"]), ws, x0)
        elif var == "pldb":
            dbmm = _jax_dbmm(d)
            ws = {"codes": jnp.asarray(rng.integers(-127, 128, (L, d, d)), jnp.int8)}
            rng.standard_normal((r, d))  # the tool's check input
            out[var] = run(lambda x, w: dbmm(x, w["codes"]), ws, x0)
    return out


@pytest.fixture(scope="module")
def jax_chains():
    from crs_tpu_torch.tools.bench_chain_gemv import VARIANTS

    return _jax_chains(VARIANTS, CHAIN["d"], CHAIN["layers"], CHAIN["r"], CHAIN["g"])


@pytest.fixture(scope="module")
def port_chains():
    from crs_tpu_torch.tools import bench_chain_gemv as bc

    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((CHAIN["r"], CHAIN["d"])).astype(np.float32))
    out = {}
    for var in bc.VARIANTS:
        step, ws, _ = bc.draw_variant(var, rng, CHAIN["d"], CHAIN["layers"], CHAIN["r"],
                                      CHAIN["g"], CPU)
        layers = [{k: v[i] for k, v in ws.items()} for i in range(CHAIN["layers"])]
        out[var] = bc.chain(step, layers, x0, 1).numpy()
    return out


@pytest.mark.parametrize("var", list(CHAIN_TOL))
def test_chain_matches_the_jax_chain(var, jax_chains, port_chains):
    want, got = jax_chains[var], port_chains[var]
    assert got.shape == want.shape == (CHAIN["r"], CHAIN["d"])
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= CHAIN_TOL[var] * max(np.abs(want).max(), 1e-30)


def _child(module, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", module, "--device", "cpu", *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_tools_run_every_variant_as_children():
    from crs_tpu_torch.tools import bench_chain_gemv as bc
    from crs_tpu_torch.tools import bench_q4_kernel as pq

    runs = {  # (child, the variants it must report, its exit code)
        "chain": (_child("crs_tpu_torch.tools.bench_chain_gemv", "--d", "1024", "--layers", "2",
                         "--reps", "1", "--variants", ",".join(bc.VARIANTS)), bc.VARIANTS, 0),
        "q4": (_child("crs_tpu_torch.tools.bench_q4_kernel", "--r", "8", "--k", "1024",
                      "--n", "1024", "--g", "8"), pq.VARIANTS, 0),
        "q4_failing": (_child("crs_tpu_torch.tools.bench_q4_kernel", "--r", "8", "--k", "1024",
                              "--n", "512", "--g", "8", "--variants", "i32,fold_nosuch"),
                       ("i32",), 1),
    }
    for name, (proc, variants, rc) in runs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == rc, (name, out, err)
        assert "device=cpu" in err
        last = json.loads(out.strip().splitlines()[-1])
        assert last["device"] == "cpu" and set(last) == {"device", *variants}, last
        assert all(v > 0 for k, v in last.items() if k != "device")
        assert ("fold_nosuch: FAILED ValueError" in out) == (rc != 0), out


@pytest.mark.parametrize("tool,argv", [
    ("bench_chain_gemv", ["--d", "1024", "--layers", "2", "--reps", "1",
                          "--variants", "int8,nosuch"]),
    ("bench_chain_gemv", ["--d", "1000", "--layers", "1", "--reps", "1",
                          "--variants", "int8,q8pallas"]),
    ("bench_q4_kernel", ["--r", "8", "--k", "1024", "--n", "512", "--g", "8",
                         "--variants", "int8,fold_nosuch"]),
])
def test_a_failed_variant_exits_non_zero(tool, argv, capsys):
    import importlib

    mod = importlib.import_module(f"crs_tpu_torch.tools.{tool}")
    assert mod.main(["--device", "cpu", *argv]) == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert any("FAILED" in line for line in out)
    assert "int8" in json.loads(out[-1])  # the other variant still ran and reported


# -- the device rule ------------------------------------------------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("tool", ["bench_chain_gemv", "bench_q4_kernel"])
def test_tools_raise_without_cuda_unless_cpu_is_asked(no_cuda, tool):
    import importlib

    mod = importlib.import_module(f"crs_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(["--device", "cuda"])


def test_probe_breakdown_needs_the_card(no_cuda):
    from crs_tpu_torch.tools import probe_breakdown

    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_breakdown.main([])


def test_tool_functions_raise_without_cuda(no_cuda):
    from crs_tpu_torch.tools import bench_chain_gemv as bc
    from crs_tpu_torch.tools import bench_q4_kernel as pq

    with pytest.raises(RuntimeError, match="device='cpu'"):
        pq.build_variant(8, 1024, 512, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bc.run_variants(["int8"], 1024, 1, 8, 16, 1, 1, 2)


class _FakeLib:
    """Stands in for the built library: records each launch, returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def __getattr__(self, name):
        def launcher(*args):
            self.calls.append((name, args))
            return self.err

        return launcher


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors reach the kernel path; no plain version may run."""
    from crs_tpu_torch.ops import gemv_probe as gp

    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("the wrapper fell back to the plain version")

    for name in ("emulate_q4_probe_matmul", "emulate_q8_gemv", "emulate_db_gemv"):
        monkeypatch.setattr(gp, name, plain_must_not_run)
    monkeypatch.setattr(gp, "stream_handle", lambda dev: 0)
    return gp


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _card_calls(gp):
    return {
        "q4_probe_matmul": lambda: gp.q4_probe_matmul(
            _meta((32, 1024), torch.int8), _meta((32, 1024), torch.int8),
            _meta((32, 1), torch.float32), _meta((1024, 32000), torch.int8),
            _meta((16, 32000), torch.float32), unpack="none"),
        "q8_gemv": lambda: gp.q8_gemv(_meta((8, 2048), torch.float32),
                                      _meta((2048, 2048), torch.int8),
                                      _meta((1, 2048), torch.float32)),
        "db_gemv": lambda: gp.db_gemv(_meta((8, 2048), torch.float32),
                                      _meta((2048, 2048), torch.int8), 1e-2 / 2048 ** 0.5),
    }


@pytest.mark.parametrize("name", ["q4_probe_matmul", "q8_gemv", "db_gemv"])
def test_wrapper_launches_its_kernel_on_the_card(fake_card, monkeypatch, name):
    lib = _FakeLib()
    monkeypatch.setattr(fake_card, "_load", lambda: lib)
    fake_card.STATS.reset()
    out = _card_calls(fake_card)[name]()
    assert fake_card.STATS.by_kernel == {name: 1} and out.dtype == torch.float32
    launcher, args = lib.calls[0]
    assert launcher == name.replace("_matmul", "") + "_launch"
    ints = [a for a in args if isinstance(a, int)][3 if name == "db_gemv" else
                                                   4 if name == "q8_gemv" else 6:]
    if name == "q4_probe_matmul":  # rt, K/2, N, gs2, gpt, fold, raw
        assert ints[:7] == [32, 1024, 32000, 64, 8, 0, 1]
    elif name == "q8_gemv":  # R, K, N
        assert ints[:3] == [8, 2048, 2048]
    else:  # R, K, N
        assert ints[:3] == [8, 2048, 2048]


@pytest.mark.parametrize("name", ["q4_probe_matmul", "q8_gemv", "db_gemv"])
def test_wrapper_raises_when_its_launch_fails(fake_card, monkeypatch, name):
    monkeypatch.setattr(fake_card, "_load", lambda: _FakeLib(err=1))
    fake_card.STATS.reset()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _card_calls(fake_card)[name]()
    assert fake_card.STATS.launches == 0


@pytest.mark.parametrize("call", [
    lambda gp: gp.q8_gemv(torch.zeros(17, 512), torch.zeros(512, 512, dtype=torch.int8),
                          torch.ones(1, 512)),
    lambda gp: gp.q8_gemv(torch.zeros(8, 1000), torch.zeros(1000, 512, dtype=torch.int8),
                          torch.ones(1, 512)),
    lambda gp: gp.db_gemv(torch.zeros(9, 512), torch.zeros(512, 512, dtype=torch.int8), 1.0),
    lambda gp: gp.q4_probe_matmul(*(torch.zeros(32, 512, dtype=torch.int8),) * 2,
                                  torch.ones(32, 1), torch.zeros(512, 512, dtype=torch.int8),
                                  torch.ones(8, 512), unpack="i8"),
    lambda gp: gp.q4_probe_matmul(*(torch.zeros(32, 512, dtype=torch.int8),) * 2,
                                  torch.ones(32, 1), torch.zeros(512, 512, dtype=torch.int8),
                                  torch.ones(8, 512), fold=True),
], ids=["q8-rows", "q8-K", "db-rows", "q4-unpack", "q4-fold-dtype"])
def test_plain_versions_refuse_what_the_kernels_refuse(call):
    from crs_tpu_torch.ops import gemv_probe as gp

    with pytest.raises(ValueError):
        call(gp)
