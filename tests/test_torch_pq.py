"""The port's product quantizer against ``crs_tpu.ops.pq``.

Encoding and ADC are held to ``crs_tpu``'s output on codebooks that JAX
trained: codes and coarse ids identical; ADC ids identical, and ADC scores
identical given the LUTs JAX builds (``_luts`` entry points) or within
1e-6 when torch builds them (float32 products summed in another order).
Training cannot share ``jax.random``'s streams, so the port's own training
is held to the JAX package's quality thresholds on the same synthetic sets
(``tests/test_residual_pq.py``, ``tests/test_aniso_pq.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_residual_pq import hard_clustered_corpus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _t(x):
    return torch.from_numpy(np.array(x))


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.fixture(scope="module")
def corpus():
    x = hard_clustered_corpus().astype(np.float32)  # 6000 × 128
    rng = np.random.default_rng(42)
    qi = rng.choice(len(x), 40, replace=False)
    q = x[qi] + 0.02 * rng.standard_normal((40, x.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


@pytest.fixture(scope="module")
def jax_rpq(corpus):
    """Residual PQ trained by crs_tpu (small, fast settings)."""
    from crs_tpu.ops.pq import train_residual_pq

    x, _ = corpus
    return train_residual_pq(jax.random.PRNGKey(0), jnp.asarray(x[:3000]), num_subspaces=8,
                             num_clusters=64, coarse_clusters=256, num_iters=5, opq_iters=1,
                             coarse_iters=4)


def _port_rpq(rpq):
    from crs_tpu_torch.ops.pq import PQCodebook, ResidualPQ

    return ResidualPQ(rotation=_t(rpq.rotation), coarse=_t(rpq.coarse),
                      codebook=PQCodebook(_t(rpq.codebook.centroids)))


def _recall(exact, cand):
    return np.mean([len(set(exact[i]) & set(cand[i])) / 10 for i in range(len(exact))])


# -- encoding against crs_tpu, same codebooks ---------------------------------

def test_residual_encode_identical(corpus, jax_rpq):
    from crs_tpu.ops.pq import residual_codes_ext as j_ext, residual_pq_encode as j_enc
    from crs_tpu_torch.ops.pq import residual_codes_ext, residual_pq_encode

    x, _ = corpus
    j_cids, j_codes = j_enc(jax_rpq, jnp.asarray(x))
    cids, codes = residual_pq_encode(_port_rpq(jax_rpq), _t(x))
    assert codes.dtype == torch.uint8 and cids.dtype == torch.int32
    np.testing.assert_array_equal(cids.numpy(), np.asarray(j_cids))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    np.testing.assert_array_equal(residual_codes_ext(cids, codes).numpy(),
                                  np.asarray(j_ext(j_cids, j_codes)))


@pytest.mark.parametrize("eta", [None, 4.0])
def test_pq_encode_identical(corpus, eta):
    from crs_tpu.ops.pq import PQCodebook as JCB, pq_encode as j_enc, train_pq as j_train
    from crs_tpu_torch.ops import pq

    x, _ = corpus
    u = x / np.linalg.norm(x, axis=1, keepdims=True)
    cb = j_train(jax.random.PRNGKey(1), jnp.asarray(x[:2000]), 8, 32, 4)
    dirs, jdirs = (None, None) if eta is None else (_t(u), jnp.asarray(u))
    ref = j_enc(JCB(cb.centroids), jnp.asarray(x), jdirs, None if eta is None else jnp.float32(eta))
    got = pq.pq_encode(pq.PQCodebook(_t(cb.centroids)), _t(x), dirs, eta)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_pq_encode_row_blocks(corpus, monkeypatch):
    """Blocked encoding (a block size that does not divide N) equals one block."""
    from crs_tpu_torch.ops import pq

    x, _ = corpus
    cb = pq.PQCodebook(_t(np.random.default_rng(2).standard_normal((8, 16, 16)).astype(np.float32)))
    whole = pq.pq_encode(cb, _t(x[:1000]))
    monkeypatch.setattr(pq, "_ENCODE_BLOCK_ROWS", 96)
    np.testing.assert_array_equal(pq.pq_encode(cb, _t(x[:1000])).numpy(), whole.numpy())


def test_residual_codes_ext_rejects_wide_coarse_ids():
    from crs_tpu_torch.ops.pq import residual_codes_ext

    with pytest.raises(ValueError):
        residual_codes_ext(torch.tensor([0, 70000], dtype=torch.int32),
                           torch.zeros((2, 4), dtype=torch.uint8))


def test_reconstruct_identical(corpus, jax_rpq):
    from crs_tpu.ops.pq import _pq_reconstruct as j_rec, residual_pq_encode as j_enc
    from crs_tpu_torch.ops.pq import _pq_reconstruct

    x, _ = corpus
    _, codes = j_enc(jax_rpq, jnp.asarray(x[:500]))
    ref = j_rec(jax_rpq.codebook, codes)
    got = _pq_reconstruct(_port_rpq(jax_rpq).codebook, _t(codes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- ADC against crs_tpu ------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_residual_adc_topk(corpus, jax_rpq, masked):
    from crs_tpu.ops.pq import residual_pq_adc_topk as j_adc, residual_pq_encode as j_enc
    from crs_tpu_torch.ops.pq import _residual_adc_topk_luts, residual_pq_adc_topk

    x, q = corpus
    cids, codes = j_enc(jax_rpq, jnp.asarray(x))
    mask = np.random.default_rng(3).random(len(x)) < 0.6 if masked else None
    jm, tm = (None, None) if mask is None else (jnp.asarray(mask), _t(mask))
    ref_s, ref_i = j_adc(jax_rpq, cids, codes, jnp.asarray(q), 25, len(x) - 11, row_mask=jm)
    s, i = residual_pq_adc_topk(_port_rpq(jax_rpq), _t(cids), _t(codes), _t(q), 25,
                                len(x) - 11, row_mask=tm)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-6, atol=1e-6)
    # the LUTs JAX builds → the same scores to the bit
    qr = jnp.dot(jnp.asarray(q), jax_rpq.rotation, preferred_element_type=jnp.float32)
    cl = jnp.dot(qr, jax_rpq.coarse.T, preferred_element_type=jnp.float32)
    lut = jnp.einsum("bmd,mkd->bmk", qr.reshape(len(q), 8, -1), jax_rpq.codebook.centroids,
                     preferred_element_type=jnp.float32)
    s2, i2 = _residual_adc_topk_luts(_t(cl), _t(lut), _t(cids), _t(codes), 25, len(x) - 11,
                                     row_mask=tm)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(ref_s))


def test_pq_adc_topk_and_blockwise(corpus, monkeypatch):
    """Plain ADC (dense and the blockwise form past the row threshold) equals
    crs_tpu's dense ADC."""
    from crs_tpu.ops.pq import pq_adc_topk as j_adc, pq_encode as j_enc, train_pq as j_train
    from crs_tpu_torch.ops import pq

    x, q = corpus
    cb = j_train(jax.random.PRNGKey(2), jnp.asarray(x[:2000]), 8, 32, 4)
    codes = j_enc(cb, jnp.asarray(x))
    mask = np.random.default_rng(4).random(len(x)) < 0.7
    ref_s, ref_i = j_adc(cb, codes, jnp.asarray(q), 30, len(x) - 5, row_mask=jnp.asarray(mask))
    pcb = pq.PQCodebook(_t(cb.centroids))
    s, i = pq.pq_adc_topk(pcb, _t(codes), _t(q), 30, len(x) - 5, row_mask=_t(mask))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(pq, "_ADC_DENSE_MAX_ROWS", 100)
    sb, ib = pq.pq_adc_topk(pcb, _t(codes), _t(q), 30, len(x) - 5, row_mask=_t(mask))
    np.testing.assert_array_equal(ib.numpy(), i.numpy())
    np.testing.assert_array_equal(sb.numpy(), s.numpy())


def test_residual_adc_blockwise_equals_dense(corpus, jax_rpq, monkeypatch):
    from crs_tpu.ops.pq import residual_pq_encode as j_enc
    from crs_tpu_torch.ops import pq

    x, q = corpus
    cids, codes = j_enc(jax_rpq, jnp.asarray(x))
    rpq = _port_rpq(jax_rpq)
    dense = pq.residual_pq_adc_topk(rpq, _t(cids), _t(codes), _t(q), 12, len(x) - 3)
    monkeypatch.setattr(pq, "_ADC_DENSE_MAX_ROWS", 100)
    block = pq.residual_pq_adc_topk(rpq, _t(cids), _t(codes), _t(q), 12, len(x) - 3)
    np.testing.assert_array_equal(block[1].numpy(), dense[1].numpy())
    np.testing.assert_array_equal(block[0].numpy(), dense[0].numpy())


# -- the port's own training, held to crs_tpu's quality thresholds -------------

def test_port_residual_pq_recall_at_16_bytes(corpus):
    """tests/test_residual_pq.py's bar: recall@10-in-100 ≥ 0.9 at 8 residual
    bytes + 1 coarse id, and the residual code beats plain PQ."""
    from crs_tpu_torch.ops.pq import (
        pq_adc_topk, pq_encode, residual_pq_adc_topk, residual_pq_encode, train_pq,
        train_residual_pq,
    )

    x, q = corpus
    exact = np.argsort(-(q @ x.T), axis=1)[:, :10]
    rpq = train_residual_pq(_gen(0), _t(x), num_subspaces=8, coarse_clusters=512,
                            num_iters=15, opq_iters=3)
    rot = rpq.rotation.numpy()
    np.testing.assert_allclose(rot @ rot.T, np.eye(x.shape[1]), atol=1e-4)  # orthogonal
    cids, codes = residual_pq_encode(rpq, _t(x))
    _, cand = residual_pq_adc_topk(rpq, cids, codes, _t(q), 100, len(x))
    r_res = _recall(exact, cand.numpy())
    assert r_res >= 0.9, r_res
    cb = train_pq(_gen(0), _t(x), 8, 256, 15)
    _, cand_plain = pq_adc_topk(cb, pq_encode(cb, _t(x)), _t(q), 100, len(x))
    r_plain = _recall(exact, cand_plain.numpy())
    assert r_res >= r_plain and (r_res >= r_plain + 0.05 or r_res >= 0.98), (r_res, r_plain)


def test_port_kmeans_deterministic_and_keeps_empty_clusters():
    from crs_tpu_torch.ops.pq import kmeans

    rng = np.random.default_rng(5)
    x = _t(np.repeat(rng.standard_normal((4, 8)).astype(np.float32), 8, axis=0))
    a = kmeans(_gen(3), x, 6, 5)
    b = kmeans(_gen(3), x, 6, 5)
    assert torch.equal(a, b) and torch.all(torch.isfinite(a))
    s = kmeans(_gen(3), x, 40, 3, init="sample")  # more clusters than points: replacement
    assert s.shape == (40, 8) and torch.all(torch.isfinite(s))


def _explicit_loss(x, c, u, eta):
    e = x[:, None, :] - c[None, :, :]
    par = np.einsum("nkd,nd->nk", e, u)
    return np.sum(e * e, axis=2) + (eta - 1.0) * par**2


def test_port_aniso_encode_is_exact_argmin():
    """tests/test_aniso_pq.py's check: the anisotropic code is the argmin of
    ‖e‖² + (η−1)·⟨e, u⟩² per subspace."""
    from crs_tpu_torch.ops.pq import PQCodebook, pq_encode

    rng = np.random.default_rng(0)
    n, d, m, k, eta = 200, 32, 4, 16, 8.0
    dsub = d // m
    x = rng.standard_normal((n, d)).astype(np.float32)
    u = x / np.linalg.norm(x, axis=1, keepdims=True)
    cents = rng.standard_normal((m, k, dsub)).astype(np.float32)
    codes = pq_encode(PQCodebook(_t(cents)), _t(x), _t(u), eta).numpy()
    for s in range(m):
        sl = slice(s * dsub, (s + 1) * dsub)
        np.testing.assert_array_equal(codes[:, s],
                                      np.argmin(_explicit_loss(x[:, sl], cents[s], u[:, sl], eta), 1))


def test_port_aniso_kmeans_reduces_its_loss():
    from crs_tpu_torch.ops.pq import _kmeans_aniso

    rng = np.random.default_rng(2)
    n, d, k, eta = 800, 16, 8, 6.0
    x = rng.standard_normal((n, d)).astype(np.float32)
    u = x / np.linalg.norm(x, axis=1, keepdims=True)

    def total(c):
        return float(np.sum(np.min(_explicit_loss(x, c.numpy(), u, eta), axis=1)))

    c1 = _kmeans_aniso(_gen(3), _t(x), _t(u), k, 1, eta)
    c10 = _kmeans_aniso(_gen(3), _t(x), _t(u), k, 10, eta)
    assert total(c10) <= total(c1) * 1.0001


def test_port_aniso_training(corpus):
    """Anisotropic codebooks cut the score error on true top-10 pairs vs
    isotropic ones, and aniso residual PQ keeps its recall (within 0.03) —
    tests/test_aniso_pq.py's bars on its 4000 × 128 corpus."""
    from crs_tpu_torch.ops.pq import (
        _pq_reconstruct, pq_encode, residual_pq_adc_topk, residual_pq_encode, train_pq,
        train_residual_pq,
    )

    x = hard_clustered_corpus(n=4000, d=128).astype(np.float32)
    rng = np.random.default_rng(7)
    qi = rng.choice(len(x), 32, replace=False)
    q = x[qi] + 0.02 * rng.standard_normal((32, x.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    exact = np.argsort(-(q @ x.T), axis=1)[:, :10]
    u = _t(x / np.linalg.norm(x, axis=1, keepdims=True))

    def score_err(rec):
        rec = rec.numpy()
        return np.mean([np.mean((q[i] @ (x[exact[i]] - rec[exact[i]]).T) ** 2)
                        for i in range(len(q))])

    cb_iso = train_pq(_gen(0), _t(x), 8, 256, 15)
    cb_an = train_pq(_gen(0), _t(x), 8, 256, 15, dirs=u, aniso_eta=10.0)
    e_iso = score_err(_pq_reconstruct(cb_iso, pq_encode(cb_iso, _t(x))))
    e_an = score_err(_pq_reconstruct(cb_an, pq_encode(cb_an, _t(x), u, 10.0)))
    assert e_an < e_iso, (e_an, e_iso)

    def recall(eta):
        rpq = train_residual_pq(_gen(0), _t(x), num_subspaces=8, coarse_clusters=256,
                                num_iters=10, opq_iters=2, aniso_eta=eta)
        cids, codes = residual_pq_encode(rpq, _t(x), eta)
        _, cand = residual_pq_adc_topk(rpq, cids, codes, _t(q), 100, len(x))
        return _recall(exact, cand.numpy())

    r_iso, r_an = recall(None), recall(10.0)
    assert r_an >= r_iso - 0.03, (r_an, r_iso)
