"""Product quantization: k-means codebooks, OPQ, residual (IVF-style) PQ and
the ADC top-k (port of ``crs_tpu.ops.pq``).

The vector dim is split into M subspaces with K-entry codebooks trained by
Lloyd's k-means; vectors are stored as [N, M] uint8 code ids, and a query
scores them by asymmetric distance computation (ADC): a per-query [M, K]
table of subspace dot products, summed by code-id gather. The residual form
adds a coarse quantizer (one coarse id per row, a [C]-wide table) and an
OPQ rotation learned on the residuals; the anisotropic (score-aware) loss
of Guo et al. (ICML 2020) is the optional ``aniso_eta`` > 1.

Randomness: k-means takes an explicit ``torch.Generator``. Torch cannot
reproduce ``jax.random``'s streams, so training matches the JAX package in
quality, not in bits; encoding and ADC given the same codebooks compute
what the JAX package computes. The fixed host rotations (the QR of a
``np.random.default_rng(0)`` matrix) and the Procrustes SVD are numpy, as
in ``crs_tpu``.

Large inputs are processed in row blocks (``_ROW_BLOCK`` rows for
assignments, ``_ENCODE_BLOCK_ROWS`` for encoding, ``_ADC_DENSE_MAX_ROWS`` /
65,536-row blocks for ADC), so no [N, K] table outgrows device memory at
1M rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .topk import NEG_INF, topk_stable

__all__ = [
    "PQCodebook", "kmeans", "aniso_eta_from_threshold", "train_pq", "pq_encode",
    "ResidualPQ", "train_opq", "train_residual_pq", "residual_pq_encode",
    "residual_codes_ext", "sort_codes_by_coarse", "adc_lut", "residual_adc_luts", "residual_pq_adc_topk",
    "pq_adc_topk",
]

ValidN = Optional[Union[int, torch.Tensor]]

_ROW_BLOCK = 1 << 16  # rows per assignment block of k-means / nearest-centroid
_ENCODE_BLOCK_ROWS = 1 << 16
_ANISO_TRAIN_MAX = 65536  # anisotropic training subsample cap (crs_tpu's)
_ADC_DENSE_MAX_ROWS = 1 << 18  # past this many rows the ADC top-k goes blockwise
_ONE_HOT_MAX = 1 << 24  # one-hot entries per chunk of a cluster sum (64 MB in f32)


class PQCodebook(NamedTuple):
    centroids: torch.Tensor  # [M, K, Dsub] f32


class ResidualPQ(NamedTuple):
    """OPQ rotation + coarse quantizer + residual PQ codebooks. A vector x
    encodes as r = xR, c = nearest coarse centroid, codes = PQ(r − coarse[c]);
    its ADC score for query q is (qR)·coarse[c] + Σ_m LUT[m, codes[m]]."""

    rotation: torch.Tensor  # [D, D] f32 orthogonal
    coarse: torch.Tensor  # [C, D] f32 centroids (rotated space)
    codebook: PQCodebook  # residual subspace codebooks (rotated space)


def _assign(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per point: argmax(2·p·c − ‖c‖²), in row blocks."""
    c_norms = torch.sum(centroids * centroids, dim=1)
    out = torch.empty((points.shape[0],), dtype=torch.int64, device=points.device)
    for r0 in range(0, points.shape[0], _ROW_BLOCK):
        dots = points[r0:r0 + _ROW_BLOCK] @ centroids.T
        out[r0:r0 + _ROW_BLOCK] = torch.argmax(2.0 * dots - c_norms[None, :], dim=1)
    return out


def _cluster_sums(assign: torch.Tensor, values: torch.Tensor, k: int) -> torch.Tensor:
    """Σ of ``values`` rows per cluster, [k, W]: ``crs_tpu``'s one-hot
    product, taken over row chunks so no [N, k] one-hot is held at once.
    Each chunk's product and the chunk order are fixed, so the sums are the
    same bits on every run (``index_add_`` adds with atomics on the card)."""
    step = max(1, _ONE_HOT_MAX // max(k, 1))
    sums = torch.zeros((k, values.shape[1]), dtype=torch.float32, device=values.device)
    for r0 in range(0, values.shape[0], step):
        one_hot = torch.nn.functional.one_hot(assign[r0:r0 + step], k).float()
        sums += one_hot.T @ values[r0:r0 + step]
    return sums


def _draw(generator: torch.Generator, n: int, count: int) -> torch.Tensor:
    """``jax.random.choice(key, n, (count,), replace=count > n)``'s role."""
    if count > n:
        return torch.randint(0, n, (count,), generator=generator, device=generator.device)
    return torch.randperm(n, generator=generator, device=generator.device)[:count]


def kmeans(
    generator: torch.Generator,
    points: torch.Tensor,  # [N, D] f32
    num_clusters: int,
    num_iters: int = 25,
    init: str = "farthest",
) -> torch.Tensor:
    """Lloyd's k-means; returns centroids [num_clusters, D].

    ``init="farthest"``: farthest-point init from one random first pick;
    ``init="sample"``: a random sample of points (for large C). A fixed
    number of iterations; empty clusters keep their previous centroid."""
    n, d = points.shape
    dev = points.device
    if init == "sample":
        centroids = points[_draw(generator, n, num_clusters).to(dev)].clone()
    else:
        first = int(torch.randint(0, n, (), generator=generator, device=generator.device))
        centroids = torch.empty((num_clusters, d), dtype=torch.float32, device=dev)
        centroids[0] = points[first]
        min_d2 = torch.sum((points - points[first][None, :]) ** 2, dim=1)
        for c in range(1, num_clusters):
            idx = torch.argmax(min_d2)
            centroids[c] = points[idx]
            min_d2 = torch.minimum(min_d2, torch.sum((points - points[idx][None, :]) ** 2, dim=1))
    for _ in range(num_iters):
        assign = _assign(points, centroids)
        sums = _cluster_sums(assign, points, num_clusters)
        counts = torch.bincount(assign, minlength=num_clusters).float()
        centroids = torch.where(counts[:, None] > 0,
                                sums / torch.clamp_min(counts[:, None], 1.0), centroids)
    return centroids


def aniso_eta_from_threshold(threshold: float, dim: int) -> float:
    """ScaNN's parallel-cost weight η = (d−1)·T²/(1−T²) for unit-norm data
    (Guo et al. 2020, Thm 3.2). T=0.2, d=384 → η ≈ 16."""
    t2 = float(threshold) ** 2
    return (dim - 1) * t2 / max(1.0 - t2, 1e-6)


def _kmeans_aniso(
    generator: torch.Generator,
    points: torch.Tensor,  # [N, D] f32 (one subspace's rows)
    dirs: torch.Tensor,  # [N, D] f32 — subspace slice of the unit datapoint
    num_clusters: int,
    num_iters: int,
    eta: float,
) -> torch.Tensor:
    """Lloyd's under the anisotropic loss ‖e‖² + (η−1)·⟨e, u⟩², e = x − c:
    argmin assignment, then per codeword the normal equations
    (n_k·I + (η−1)·Σ u uᵀ)·c = Σ (x + (η−1)⟨u, x⟩·u), solved batched. Empty
    clusters keep their previous centroid. Sample init."""
    n, d = points.shape
    dev = points.device
    centroids = points[_draw(generator, n, num_clusters).to(dev)].clone()
    w = float(eta) - 1.0
    a = torch.sum(points * dirs, dim=1)  # [N] ⟨x, u⟩
    pnorm2 = torch.sum(points * points, dim=1)
    ax = points + w * a[:, None] * dirs  # A_i x_i rows
    uu_rows = (dirs[:, :, None] * dirs[:, None, :]).reshape(n, d * d)
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    for _ in range(num_iters):
        dots = points @ centroids.T
        udots = dirs @ centroids.T
        loss = (pnorm2[:, None] - 2.0 * dots + torch.sum(centroids * centroids, dim=1)[None, :]
                + w * (a[:, None] - udots) ** 2)
        assign = torch.argmin(loss, dim=1)
        counts = torch.bincount(assign, minlength=num_clusters).float()
        s = _cluster_sums(assign, ax, num_clusters)
        uu = _cluster_sums(assign, uu_rows, num_clusters)
        g = counts[:, None, None] * eye[None] + w * uu.view(num_clusters, d, d)
        g = torch.where(counts[:, None, None] > 0, g, eye[None])
        new = torch.linalg.solve(g, s[..., None])[..., 0]
        centroids = torch.where(counts[:, None] > 0, new, centroids)
    return centroids


def train_pq(
    generator: torch.Generator,
    vectors: torch.Tensor,  # [N, D]
    num_subspaces: int = 8,
    num_clusters: int = 256,
    num_iters: int = 25,
    dirs: Optional[torch.Tensor] = None,  # [N, D] unit datapoint directions
    aniso_eta: Optional[float] = None,
) -> PQCodebook:
    """Per-subspace codebooks (D divisible by num_subspaces); with ``dirs``
    and ``aniso_eta`` > 1 under the anisotropic loss (``dirs`` rows are
    slices of the full unit vector, not re-normalized per subspace)."""
    n, d = vectors.shape
    if d % num_subspaces:
        raise ValueError("dim must divide evenly into subspaces")
    dsub = d // num_subspaces
    k_eff = min(num_clusters, n)
    aniso = dirs is not None and aniso_eta is not None and aniso_eta > 1.0
    if aniso and n > _ANISO_TRAIN_MAX:
        stride = -(-n // _ANISO_TRAIN_MAX)
        vectors, dirs = vectors[::stride], dirs[::stride]
        n = vectors.shape[0]
    sub = vectors.reshape(n, num_subspaces, dsub)
    cents = []
    for mi in range(num_subspaces):
        pts = sub[:, mi, :].contiguous()
        if aniso:
            dsl = dirs.reshape(n, num_subspaces, dsub)[:, mi, :].contiguous()
            cents.append(_kmeans_aniso(generator, pts, dsl, k_eff, num_iters, aniso_eta))
        else:
            cents.append(kmeans(generator, pts, k_eff, num_iters))
    centroids = torch.stack(cents)
    if k_eff < num_clusters:  # pad the codebook so code ids stay uint8-stable
        pad = torch.zeros((num_subspaces, num_clusters - k_eff, dsub), device=vectors.device)
        centroids = torch.cat([centroids, pad], 1)
    return PQCodebook(centroids=centroids)


def _pq_assign_block(centroids, c_norms, sub, dsl, aniso_eta):
    """Nearest-codeword ids for one row block. sub/dsl: [B, M, Dsub]."""
    dots = torch.einsum("nmd,mkd->nmk", sub, centroids)
    score = 2.0 * dots - c_norms[None, :, :]  # maximize ⇔ min Euclidean
    if dsl is not None and aniso_eta is not None:
        w = float(aniso_eta) - 1.0
        udots = torch.einsum("nmd,mkd->nmk", dsl, centroids)
        a = torch.sum(sub * dsl, dim=2)  # [B, M] ⟨x, u⟩ per subspace
        score = score - w * (a[..., None] - udots) ** 2
    return torch.argmax(score, dim=2)


def pq_encode(
    codebook: PQCodebook,
    vectors: torch.Tensor,
    dirs: Optional[torch.Tensor] = None,
    aniso_eta: Optional[float] = None,
) -> torch.Tensor:
    """Code ids [N, M] (nearest centroid per subspace; with ``dirs`` and
    ``aniso_eta``, the anisotropic argmin): uint8 for K ≤ 256, int32
    otherwise. Rows go in ``_ENCODE_BLOCK_ROWS`` blocks."""
    n, _ = vectors.shape
    m, k, dsub = codebook.centroids.shape
    c_norms = torch.sum(codebook.centroids**2, dim=2)  # [M, K]
    out_dtype = torch.uint8 if k <= 256 else torch.int32
    use_dirs = dirs is not None and aniso_eta is not None
    out = torch.empty((n, m), dtype=out_dtype, device=vectors.device)
    for r0 in range(0, n, _ENCODE_BLOCK_ROWS):
        r1 = min(r0 + _ENCODE_BLOCK_ROWS, n)
        sub = vectors[r0:r1].reshape(r1 - r0, m, dsub)
        dsl = dirs[r0:r1].reshape(r1 - r0, m, dsub) if use_dirs else None
        out[r0:r1] = _pq_assign_block(codebook.centroids, c_norms, sub, dsl,
                                      aniso_eta if use_dirs else None).to(out_dtype)
    return out


def _pq_reconstruct(codebook: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    cents = codebook.centroids  # [M, K, dsub]
    idx = codes.long()
    return torch.cat([cents[mi][idx[..., mi]] for mi in range(cents.shape[0])], dim=-1)


def _random_rotation(d: int) -> torch.Tensor:
    """``crs_tpu``'s fixed host rotation: Q of QR(default_rng(0) normal)."""
    rng = np.random.default_rng(0)
    r, _ = np.linalg.qr(rng.standard_normal((d, d)).astype(np.float64))
    return torch.from_numpy(r.astype(np.float32))


def train_opq(
    generator: torch.Generator,
    vectors: torch.Tensor,  # [N, D] f32
    num_subspaces: int = 8,
    num_clusters: int = 256,
    num_iters: int = 20,
    opq_iters: int = 5,
    init_rotation: Optional[np.ndarray] = None,
    dirs: Optional[torch.Tensor] = None,
    aniso_eta: Optional[float] = None,
) -> Tuple[torch.Tensor, PQCodebook]:
    """Learn (rotation, codebooks) by alternating PQ training and the
    orthogonal-Procrustes solve R = UVᵀ of SVD(Xᵀ·recon). Every round
    trains from the same generator state, as ``crs_tpu`` reuses its key."""
    d = vectors.shape[1]
    dev = vectors.device
    if init_rotation is not None:
        r = torch.as_tensor(np.asarray(init_rotation, np.float32)).to(dev)
    else:
        r = _random_rotation(d).to(dev)
    state = generator.get_state()

    def rot_dirs(rot):
        return None if dirs is None or aniso_eta is None else dirs @ rot

    for _ in range(opq_iters):
        xr = vectors @ r
        dr = rot_dirs(r)
        generator.set_state(state)
        cb = train_pq(generator, xr, num_subspaces, num_clusters, num_iters, dirs=dr,
                      aniso_eta=aniso_eta)
        recon = _pq_reconstruct(cb, pq_encode(cb, xr, dr, aniso_eta))
        cross = (vectors.T @ recon).cpu().numpy().astype(np.float64)
        u, _, vt = np.linalg.svd(cross, full_matrices=False)
        r = torch.from_numpy((u @ vt).astype(np.float32)).to(dev)
    xr = vectors @ r
    generator.set_state(state)
    cb = train_pq(generator, xr, num_subspaces, num_clusters, num_iters, dirs=rot_dirs(r),
                  aniso_eta=aniso_eta)
    return r, cb


def train_residual_pq(
    generator: torch.Generator,
    vectors: torch.Tensor,  # [N, D] f32 (valid rows only)
    num_subspaces: int = 12,
    num_clusters: int = 256,
    coarse_clusters: int = 2048,
    num_iters: int = 20,
    opq_iters: int = 4,
    coarse_iters: int = 10,
    aniso_eta: Optional[float] = None,
) -> ResidualPQ:
    """IVF-style residual PQ: a fixed host rotation, a coarse k-means
    (sample init), then OPQ with the identity init on the residuals; the
    OPQ rotation is applied to both the coarse and the residual space. With
    ``aniso_eta`` > 1 the residual codebooks train under the anisotropic
    loss, the direction being the rotated datapoint itself."""
    n, d = vectors.shape
    dev = vectors.device
    r0 = _random_rotation(d).to(dev)
    xr = vectors @ r0
    coarse = kmeans(generator, xr, min(coarse_clusters, n), coarse_iters, init="sample")
    residuals = xr - coarse[_assign(xr, coarse)]
    dirs = None
    if aniso_eta is not None and aniso_eta > 1.0:
        dirs = xr / torch.clamp_min(torch.linalg.vector_norm(xr, dim=1, keepdim=True), 1e-12)
    r1, cb = train_opq(generator, residuals, num_subspaces, num_clusters, num_iters, opq_iters,
                       init_rotation=np.eye(d, dtype=np.float32), dirs=dirs,
                       aniso_eta=aniso_eta)
    return ResidualPQ(rotation=r0 @ r1, coarse=coarse @ r1, codebook=cb)


def residual_pq_encode(
    rpq: ResidualPQ,
    vectors: torch.Tensor,
    aniso_eta: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (coarse_ids [N] int32, codes [N, M] uint8 for K ≤ 256).
    ``aniso_eta`` must match what the codebooks were trained with."""
    xr = vectors @ rpq.rotation
    cids = _assign(xr, rpq.coarse).int()
    dirs = None
    if aniso_eta is not None:
        dirs = xr / torch.clamp_min(torch.linalg.vector_norm(xr, dim=1, keepdim=True), 1e-12)
    codes = pq_encode(rpq.codebook, xr - rpq.coarse[cids.long()], dirs, aniso_eta)
    return cids, codes


def residual_codes_ext(coarse_ids: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[N, M+2] uint8: the coarse id as (hi, lo) bytes, then the residual
    codes — the rows the residual ADC kernel reads. Requires C ≤ 65536 and
    K ≤ 256 (a wider coarse id raises instead of wrapping)."""
    cid = coarse_ids.long()
    if cid.numel() and int(cid.max()) >= 65536:
        raise ValueError(
            "residual_codes_ext: coarse ids must be < 65536 (two uint8 bytes); "
            "reduce pq_coarse_clusters or use the unfused ADC path")
    hi = (cid // 256).to(torch.uint8)
    lo = (cid % 256).to(torch.uint8)
    return torch.cat([hi[:, None], lo[:, None], codes.to(torch.uint8)], dim=1)


def sort_codes_by_coarse(codes_ext, num_coarse: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The sorted residual-ADC scan's layout (host numpy, a one-time build
    cost): the [N, M+2] rows stable-sorted by coarse id. Returns
    ``(sorted_ext, perm int32, counts int64)`` with ``sorted_ext[r] ==
    codes_ext[perm[r]]`` (scan ids map back through ``perm``) and
    ``counts[c]`` the rows of coarse id c, the input of
    :func:`crs_tpu_torch.ops.scan.plan_sorted_coarse_windows`. Raises when
    a coarse id is ≥ ``num_coarse``."""
    ext = codes_ext.cpu().numpy() if isinstance(codes_ext, torch.Tensor) else np.asarray(codes_ext)
    cid = ext[:, 0].astype(np.int64) * 256 + ext[:, 1].astype(np.int64)
    perm = np.argsort(cid, kind="stable")
    counts = np.bincount(cid, minlength=num_coarse)
    if counts.shape[0] > num_coarse:
        raise ValueError(
            f"sort_codes_by_coarse: coarse id {int(cid.max())} >= num_coarse {num_coarse}")
    return ext[perm], perm.astype(np.int32), counts.astype(np.int64)


# -- ADC ---------------------------------------------------------------------

def adc_lut(centroids: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Per-query subspace tables [B, M, K]: q_m · centroid[m, k]."""
    b, d = queries.shape
    m = centroids.shape[0]
    return torch.einsum("bmd,mkd->bmk", queries.reshape(b, m, d // m), centroids)


def residual_adc_luts(rotation, coarse, centroids, queries) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coarse_lut [B, C] = (qR)·coarse, lut [B, M, K] of qR)."""
    qr = queries @ rotation
    return qr @ coarse.T, adc_lut(centroids, qr)


def _adc_bias(n: int, valid_n: ValidN, row_mask: Optional[torch.Tensor], dev) -> torch.Tensor:
    allowed = torch.ones((n,), dtype=torch.bool, device=dev)
    if valid_n is not None:
        allowed = torch.arange(n, device=dev) < valid_n
    if row_mask is not None:
        allowed = allowed & row_mask
    return torch.where(allowed, 0.0, NEG_INF).float()


def _blockwise_adc_topk(lut, codes, bias, k, coarse_lut=None, coarse_ids=None,
                        block_rows: int = 65536):
    """Memory-lean ADC: per row block s = bias (+ coarse term) + Σ_m lut
    terms, the block's top-k, then one exact merge (the ``lax.scan`` of the
    JAX version as a loop)."""
    n, m = codes.shape
    b = lut.shape[0]
    dev = lut.device
    k_eff = min(k, block_rows)
    all_s, all_i = [], []
    for r0 in range(0, n, block_rows):
        r1 = min(r0 + block_rows, n)
        cb = codes[r0:r1].long()
        s = bias[None, r0:r1]
        if coarse_lut is not None:
            s = s + coarse_lut[:, coarse_ids[r0:r1].long()]
        for mi in range(m):
            s = s + lut[:, mi, :][:, cb[:, mi]]
        if r1 - r0 < block_rows:  # padded rows of the last block: bias -1e30, code 0
            pad = torch.full((b, block_rows - (r1 - r0)), NEG_INF, device=dev)
            s = torch.cat([s.expand(b, -1), pad], 1)
        top_s, top_i = topk_stable(s.expand(b, -1), k_eff)
        all_s.append(top_s)
        all_i.append(top_i + r0)
    flat_s, flat_i = torch.cat(all_s, 1), torch.cat(all_i, 1)
    top_s, sel = topk_stable(flat_s, min(k, flat_s.shape[1]))
    return top_s, torch.gather(flat_i, 1, sel)


def _residual_adc_topk_luts(coarse_lut, lut, coarse_ids, codes, k, valid_n: ValidN = None,
                            row_mask=None):
    """:func:`residual_pq_adc_topk` from its LUTs (all f32)."""
    n, m = codes.shape
    dev = lut.device
    if n > _ADC_DENSE_MAX_ROWS:
        return _blockwise_adc_topk(lut, codes, _adc_bias(n, valid_n, row_mask, dev), k,
                                   coarse_lut=coarse_lut, coarse_ids=coarse_ids)
    cb = codes.long()
    scores = coarse_lut[:, coarse_ids.long()]
    for mi in range(m):
        scores = scores + lut[:, mi, :][:, cb[:, mi]]
    return _mask_topk(scores, k, valid_n, row_mask)


def _mask_topk(scores, k, valid_n, row_mask):
    n = scores.shape[1]
    if valid_n is not None:
        scores = torch.where(torch.arange(n, device=scores.device)[None, :] < valid_n,
                             scores, NEG_INF)
    if row_mask is not None:
        scores = torch.where(row_mask[None, :], scores, NEG_INF)
    return topk_stable(scores, min(k, n))


def residual_pq_adc_topk(
    rpq: ResidualPQ,
    coarse_ids: torch.Tensor,  # [N] int
    codes: torch.Tensor,  # [N, M]
    queries: torch.Tensor,  # [B, D] f32
    k: int,
    valid_n: ValidN = None,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC with the coarse term, all f32: score = qR·coarse[c_n] +
    Σ_m LUT[m, codes[n, m]]. Returns (scores [B, k], ids [B, k] int64)."""
    coarse_lut, lut = residual_adc_luts(rpq.rotation, rpq.coarse, rpq.codebook.centroids,
                                        queries)
    return _residual_adc_topk_luts(coarse_lut, lut, coarse_ids, codes, k, valid_n, row_mask)


def _adc_topk_luts(lut, codes, k, valid_n: ValidN = None, row_mask=None):
    """:func:`pq_adc_topk` from its LUT."""
    n, m = codes.shape
    b = lut.shape[0]
    if n > _ADC_DENSE_MAX_ROWS:
        return _blockwise_adc_topk(lut, codes, _adc_bias(n, valid_n, row_mask, lut.device), k)
    cb = codes.long()
    scores = torch.zeros((b, n), dtype=torch.float32, device=lut.device)
    for mi in range(m):
        scores = scores + lut[:, mi, :][:, cb[:, mi]]
    return _mask_topk(scores, k, valid_n, row_mask)


def pq_adc_topk(
    codebook: PQCodebook,
    codes: torch.Tensor,  # [N, M]
    queries: torch.Tensor,  # [B, D] f32
    k: int,
    valid_n: ValidN = None,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC scan: approximate dot(query, vec) = Σ_m LUT[b, m, codes[n, m]]."""
    return _adc_topk_luts(adc_lut(codebook.centroids, queries), codes, k, valid_n, row_mask)
