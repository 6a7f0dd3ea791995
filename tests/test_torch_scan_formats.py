"""The port's float and PQ ADC scans against ``crs_tpu``'s Pallas kernels.

The JAX side runs as its own tests run it: ``pallas_topk``,
``pallas_topk_residual_pq_adc`` and ``pallas_topk_pq_adc`` in Pallas
interpret mode. The port runs its plain torch versions (the CUDA kernels'
CPU counterparts) through the same host side: finalize, ceilings, targeted
repair and the exact fallback.

Tolerances:
- ADC scans (kernels 3 and 5): bits. Given the LUTs JAX builds, scores and
  ids are identical (``_luts`` entry points); the ADC scores add the same
  bf16/f32 values in the Pallas kernels' order.
- Float scan (kernel 2): a score tolerance of rtol·(1 + |s|), rtol = 1e-5
  for fp32 and 1e-2 for bf16 (the f32 sums run in another order), and equal
  ids at every rank whose score is farther than 1e-5·(1 + |s|) from both
  neighbours' scores (in both dtypes the products are exact in f32 and
  only the order of the f32 sums differs), and at every -1e30 (padding /
  masked) rank.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)

N, D, B, BS = 3000, 64, 10, 256
ID_RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_float_scan_close(got, ref, rtol):
    ref_s, ref_i = (np.asarray(a, np.float64) for a in ref)
    got_s, got_i = got[0].double().numpy(), got[1].numpy()
    assert np.all(np.abs(got_s - ref_s) <= rtol * (1.0 + np.abs(ref_s))), \
        np.abs(got_s - ref_s).max()
    # ids: both dtypes accumulate exact products in f32, so the ranks that
    # must agree are those separated by more than the f32 sum-order bound
    tol = ID_RTOL * (1.0 + np.abs(ref_s))
    gap_prev = np.full(ref_s.shape, np.inf)
    gap_next = np.full(ref_s.shape, np.inf)
    gap_prev[:, 1:] = ref_s[:, :-1] - ref_s[:, 1:]
    gap_next[:, :-1] = ref_s[:, :-1] - ref_s[:, 1:]
    need = ((gap_prev > tol) & (gap_next > tol)) | (ref_s <= -1e29)
    assert need.any()  # the rule is not vacuous
    np.testing.assert_array_equal(got_i[need], ref_i[need].astype(np.int64))


def _clustered(rng, n, d, b, hot=50):
    """Every query owns a hot run of rows near it: its top-k crowds into one
    block, so small kb trips ceilings (repair) or the budget (fallback)."""
    base = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    for qi in range(b):
        st = (256 * qi) % (n - hot - 10)
        base[st:st + hot] = q[qi][None] * 10 + 0.01 * rng.standard_normal((hot, d))
    return base, q


# -- kernel 2: pallas_topk ---------------------------------------------------

FLOAT_CASES = {
    # name: (clustered corpus, k, kb, repair, masked, counts expected)
    "exact_k_le_kb": (False, 4, 8, 256, True, {}),
    "repair": (True, 40, 2, 256, False, {"repairs": 1}),
    "repair_masked": (True, 40, 2, 256, True, {"repairs": 1}),
    "fallback_over_budget": (True, 40, 2, 4, False, {"fallbacks": 1}),
    "fallback_no_repair": (True, 40, 2, 0, True, {"fallbacks": 1}),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLOAT_CASES))
def test_float_scan_matches_pallas_topk(dtype, case):
    from crs_tpu.ops.pallas_scan import pallas_topk
    from crs_tpu_torch.ops.scan import STATS, scan_topk

    clustered, k, kb, repair, masked, counts = FLOAT_CASES[case]
    rng = np.random.default_rng(10)
    v, q = _clustered(rng, N, D, B) if clustered else (_unit(rng, N, D), _unit(rng, B, D))
    mask = rng.random(N) < 0.6 if masked else None
    valid = N - 37
    jdt, tdt, rtol = ((jnp.float32, torch.float32, 1e-5) if dtype == "fp32"
                      else (jnp.bfloat16, torch.bfloat16, 1e-2))
    ref = pallas_topk(jnp.asarray(v, jdt), jnp.asarray(q), k, valid, block_size=BS, kb=kb,
                      row_mask=None if mask is None else jnp.asarray(mask), repair=repair)
    STATS.reset()
    got = scan_topk(_t(v).to(tdt), _t(q), k, valid, block_size=BS, kb=kb,
                    row_mask=None if mask is None else _t(mask), repair=repair)
    for name, want in counts.items():
        assert getattr(STATS, name) == want, (name, vars(STATS))
    _assert_float_scan_close(got, ref, rtol)


def test_float_scan_ties_and_exhausted_blocks():
    """Duplicated rows tie exactly (lowest id first); a mask that leaves
    fewer allowed rows than k makes blocks re-emit their lowest id at
    -1e30 — the ids at those ranks must be the Pallas kernel's."""
    from crs_tpu.ops.pallas_scan import pallas_topk
    from crs_tpu_torch.ops.scan import scan_topk

    rng = np.random.default_rng(11)
    v = _unit(rng, N, D)
    v[2000:2100] = v[0:100]  # exact duplicates → exactly tied scores
    q = v[:B].copy()
    mask = np.zeros(N, bool)
    mask[rng.choice(N, 12, replace=False)] = True
    mask[:B] = True
    mask[2000:2000 + B] = True
    for k, kb in ((40, 8), (40, 0)):
        ref = pallas_topk(jnp.asarray(v), jnp.asarray(q), k, N, block_size=BS, kb=kb,
                          row_mask=jnp.asarray(mask))
        got = scan_topk(_t(v), _t(q), k, N, block_size=BS, kb=kb, row_mask=_t(mask))
        assert (np.asarray(ref[0]) <= -1e29).any()  # ranks past the allowed rows
        _assert_float_scan_close(got, ref, 1e-5)
        ids = got[1].numpy()
        assert all(i2 == i0 + 2000 for row in ids for i0, i2 in [(row[0], row[1])])


def test_float_scan_plain_partials_reemit_lowest_id():
    """The plain version's partials: a block with no allowed row emits its
    lowest row id kb times at -1e30 (``_extract_block_topk``)."""
    from crs_tpu_torch.ops.scan import FLOAT_QUERY_TILE, block_topk_float_plain

    rng = np.random.default_rng(12)
    v = _t(_unit(rng, 1024, 32))
    q = _t(_unit(rng, FLOAT_QUERY_TILE, 32))
    bias = torch.zeros(1024)
    bias[256:512] = -1e30  # block 1 fully masked
    bias[512:768:64] = -1e30
    out_s, out_i = block_topk_float_plain(q, v, bias, 3, 256)
    assert out_s.shape == (1, 4, 3, FLOAT_QUERY_TILE)
    assert torch.all(out_s[:, 1] == np.float32(-1e30)) and torch.all(out_i[:, 1] == 256)
    assert torch.all(out_s[:, 0, 0] >= out_s[:, 0, 1])


# -- kernels 3 and 5: the ADC scans -------------------------------------------

M, C, K = 8, 256, 256


@pytest.fixture(scope="module")
def adc_state():
    rng = np.random.default_rng(13)
    rot = np.linalg.qr(rng.standard_normal((D, D)))[0].astype(np.float32)
    coarse = (rng.standard_normal((C, D)) * 0.3).astype(np.float32)
    cents = (rng.standard_normal((M, K, D // M)) * 0.1).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    ext = np.concatenate([np.zeros((N, 1)), rng.integers(0, C, (N, 1)),
                          rng.integers(0, K, (N, M))], 1).astype(np.uint8)
    ext[2000:2100] = ext[0:100]  # duplicated rows → exactly tied ADC scores

    @jax.jit
    def luts(q, rot, coarse, cents):  # the JAX wrappers' LUT products
        qr = jnp.dot(q, rot, preferred_element_type=jnp.float32)
        cl = jnp.dot(qr, coarse.T, preferred_element_type=jnp.float32)
        sub = qr.reshape(q.shape[0], M, D // M)
        return cl, jnp.einsum("bmd,mkd->bmk", sub, cents, preferred_element_type=jnp.float32)

    @jax.jit
    def plain_lut(q, cents):
        sub = q.reshape(q.shape[0], M, D // M)
        return jnp.einsum("bmd,mkd->bmk", sub, cents, preferred_element_type=jnp.float32)

    cl, lut = (np.asarray(a) for a in luts(*(jnp.asarray(a) for a in (q, rot, coarse, cents))))
    # hot rows: each query's best code in most subspaces, so its top-k
    # crowds into one block (repair) — plain-PQ hot rows likewise
    plut = np.asarray(plain_lut(jnp.asarray(q), jnp.asarray(cents)))
    for qi in range(B):
        st = (256 * qi) % (N - 60)
        best = np.argmax(lut[qi], axis=1)
        ext[st:st + 50, 2:] = np.where(rng.random((50, M)) < 0.7, best[None], ext[st:st + 50, 2:])
    codes = ext[:, 2:].copy()
    for qi in range(B):
        st = (256 * qi + 128) % (N - 60)
        best = np.argmax(plut[qi], axis=1)
        codes[st:st + 50] = np.where(rng.random((50, M)) < 0.7, best[None], codes[st:st + 50])
    return dict(rot=rot, coarse=coarse, cents=cents, q=q, ext=ext, cl=cl, lut=lut,
                codes=codes, plut=plut, mask=rng.random(N) < 0.7)


ADC_CASES = {
    # name: (k, repair, masked, counts expected)
    "exact_k_le_kb": (3, 256, True, {}),
    "repair": (40, 256, False, {"repairs": 1}),
    "repair_masked": (40, 256, True, {"repairs": 1}),
    "fallback_over_budget": (40, 2, False, {"fallbacks": 1}),
    "fallback_no_repair": (40, 0, True, {"fallbacks": 1}),
}


@pytest.mark.parametrize("case", sorted(ADC_CASES))
def test_residual_adc_scan_matches_pallas_bits(adc_state, case):
    from crs_tpu.ops.pallas_scan import pallas_topk_residual_pq_adc
    from crs_tpu_torch.ops.scan import STATS, scan_topk_residual_pq_adc_luts

    k, repair, masked, counts = ADC_CASES[case]
    st = adc_state
    mask = st["mask"] if masked else None
    valid = N - 23
    ref_s, ref_i = pallas_topk_residual_pq_adc(
        *(jnp.asarray(st[a]) for a in ("rot", "coarse", "cents", "ext", "q")), k, valid,
        block_size=BS, row_mask=None if mask is None else jnp.asarray(mask), repair=repair)
    STATS.reset()
    s, i = scan_topk_residual_pq_adc_luts(
        _t(st["cl"]), _t(st["lut"]), _t(st["ext"]), k, valid, block_size=BS,
        row_mask=None if mask is None else _t(mask), repair=repair)
    for name, want in counts.items():
        assert getattr(STATS, name) == want, (name, vars(STATS))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("case", sorted(ADC_CASES))
def test_pq_adc_scan_matches_pallas_bits(adc_state, case):
    from crs_tpu.ops.pallas_scan import pallas_topk_pq_adc
    from crs_tpu_torch.ops.scan import STATS, scan_topk_pq_adc_luts

    k, repair, masked, counts = ADC_CASES[case]
    st = adc_state
    mask = st["mask"] if masked else None
    valid = N - 23
    ref_s, ref_i = pallas_topk_pq_adc(
        jnp.asarray(st["cents"]), jnp.asarray(st["codes"]), jnp.asarray(st["q"]), k, valid,
        block_size=BS, row_mask=None if mask is None else jnp.asarray(mask), repair=repair)
    STATS.reset()
    s, i = scan_topk_pq_adc_luts(_t(st["plut"]), _t(st["codes"]), k, valid, block_size=BS,
                                 row_mask=None if mask is None else _t(mask), repair=repair)
    for name, want in counts.items():
        assert getattr(STATS, name) == want, (name, vars(STATS))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


def test_adc_scans_exhausted_blocks_match_pallas(adc_state):
    """Fewer allowed rows than k: the -1e30 ranks carry the Pallas kernels'
    re-emitted ids, in both ADC scans."""
    from crs_tpu.ops.pallas_scan import pallas_topk_pq_adc, pallas_topk_residual_pq_adc
    from crs_tpu_torch.ops.scan import scan_topk_pq_adc_luts, scan_topk_residual_pq_adc_luts

    st = adc_state
    rng = np.random.default_rng(14)
    mask = np.zeros(N, bool)
    mask[rng.choice(N, 9, replace=False)] = True
    k = 20
    ref = pallas_topk_residual_pq_adc(
        *(jnp.asarray(st[a]) for a in ("rot", "coarse", "cents", "ext", "q")), k, N,
        block_size=BS, row_mask=jnp.asarray(mask))
    got = scan_topk_residual_pq_adc_luts(_t(st["cl"]), _t(st["lut"]), _t(st["ext"]), k, N,
                                         block_size=BS, row_mask=_t(mask))
    assert (np.asarray(ref[0]) <= -1e29).any()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    ref = pallas_topk_pq_adc(jnp.asarray(st["cents"]), jnp.asarray(st["codes"]),
                             jnp.asarray(st["q"]), k, N, block_size=BS,
                             row_mask=jnp.asarray(mask))
    got = scan_topk_pq_adc_luts(_t(st["plut"]), _t(st["codes"]), k, N, block_size=BS,
                                row_mask=_t(mask))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


def test_adc_scans_from_queries_match_pallas(adc_state):
    """The public entry points, LUTs built by torch: same ids as Pallas."""
    from crs_tpu.ops.pallas_scan import pallas_topk_pq_adc, pallas_topk_residual_pq_adc
    from crs_tpu_torch.ops.scan import scan_topk_pq_adc, scan_topk_residual_pq_adc

    st = adc_state
    ref = pallas_topk_residual_pq_adc(
        *(jnp.asarray(st[a]) for a in ("rot", "coarse", "cents", "ext", "q")), 16, N,
        block_size=512)
    got = scan_topk_residual_pq_adc(*(_t(st[a]) for a in ("rot", "coarse", "cents", "ext", "q")),
                                    16, N, block_size=512)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-6, atol=1e-6)
    ref = pallas_topk_pq_adc(jnp.asarray(st["cents"]), jnp.asarray(st["codes"]),
                             jnp.asarray(st["q"]), 16, N, block_size=512)
    got = scan_topk_pq_adc(_t(st["cents"]), _t(st["codes"]), _t(st["q"]), 16, N, block_size=512)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-6, atol=1e-6)


def test_adc_tables_round_like_the_tpu_kernels():
    """bf16 residual LUT (round to nearest even) and the hi+lo coarse pair:
    hi + lo reproduces f32 to ~2⁻¹⁶ relative; both equal JAX's astype."""
    from crs_tpu_torch.ops.scan import adc_tables

    rng = np.random.default_rng(15)
    c = (rng.standard_normal((4, 300)) * 3).astype(np.float32)
    lut = rng.standard_normal((4, 3, 16)).astype(np.float32)
    lut_bf, hi, lo = adc_tables(_t(lut), _t(c))
    j_hi = jnp.asarray(c).astype(jnp.bfloat16)
    j_lo = (jnp.asarray(c) - j_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(hi.float().numpy(), np.asarray(j_hi.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.float().numpy(), np.asarray(j_lo.astype(jnp.float32)))
    np.testing.assert_array_equal(
        lut_bf.float().numpy(), np.asarray(jnp.asarray(lut).astype(jnp.bfloat16).astype(jnp.float32)))
    rel = np.abs((hi.float() + lo.float()).numpy() - c) / np.abs(c)
    assert rel.max() < 2.0**-15


def test_scans_hand_the_kernels_contiguous_operands(adc_state, monkeypatch):
    """The CUDA wrappers refuse strided tensors (an einsum's LUT is one), so
    every scan must hand them contiguous operands; the plain versions would
    not notice, so this checks it on the CPU."""
    from crs_tpu_torch.ops import scan

    seen = []

    def spy(name):
        real = getattr(scan, name)

        def wrapper(*args, **kwargs):
            seen.append(name)
            for a in list(args) + list(kwargs.values()):
                if isinstance(a, torch.Tensor):
                    assert a.is_contiguous(), name
            return real(*args, **kwargs)

        monkeypatch.setattr(scan, name, wrapper)

    for name in ("block_topk_int8", "block_topk_float", "block_topk_adc"):
        spy(name)
    st = adc_state
    q_strided = _t(np.asfortranarray(st["q"]))  # a column-major query batch
    rng = np.random.default_rng(16)
    v = _t(_unit(rng, N, D))
    scan.scan_topk(v, q_strided, 5, N, block_size=BS)
    scan.scan_topk_int8(*scan.scalar_quantize(v), q_strided, 5, N)
    scan.scan_topk_residual_pq_adc(*(_t(st[a]) for a in ("rot", "coarse", "cents")),
                                   _t(st["ext"]), q_strided, 5, N, block_size=BS)
    scan.scan_topk_pq_adc(_t(st["cents"]), _t(st["ext"])[:, 2:], q_strided, 5, N, block_size=BS)
    assert seen == ["block_topk_float", "block_topk_int8", "block_topk_adc", "block_topk_adc"]
