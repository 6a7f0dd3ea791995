"""The port's calibrated quantizers (``crs_tpu_torch/models/quant_calib.py``),
its calibration tap (``forward_captured``) and the weight quantizers of
``ops/quant.py`` against ``crs_tpu``.

Tolerances:
- the numpy parts (``_rtn_dequant``, ``_recon_error``, ``awq_search_scale``,
  ``gptq_quantize_tensor``, ``awq_quantize_params`` / ``gptq_quantize_params``
  given the same statistics) and the ``ops/quant.py`` quantizers: bits;
- ``forward_captured``: each captured activation, rounded to bf16, equals
  ``crs_tpu``'s; logits within 0.05 (the generator tests' bound);
- ``collect_calibration_stats``: within 1e-5 of each statistic's largest
  magnitude. Torch and XLA sum the Grams in their own orders (identical at
  these sizes so far, not promised);
- ``create_model_interface("gptq" / "awq")`` against ``JaxModel``: codes
  equal in ≥ 99 % (gptq) / 99.9 % (awq) of entries — a last-ulp difference
  in a statistic moves a GPTQ rounding decision and everything it feeds —
  and logits correlated above 0.999.
"""

import pathlib

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


LOGIT_ATOL = 0.05
STATS_RTOL = 1e-5


def _correlated_activations(d, n=512, seed=0, mix=False):
    """Activations with a few dominant channels, optionally mixed low-rank
    (``tests/test_quant_calib.py``'s inputs)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    boost = np.ones(d, np.float32)
    boost[rng.choice(d, d // 16, replace=False)] = 12.0
    x = x * boost[None, :]
    if mix:
        m = np.eye(d, dtype=np.float32) + 0.35 * rng.standard_normal((d, d)).astype(
            np.float32) / np.sqrt(d)
        z = rng.standard_normal((n, d // 4)).astype(np.float32)
        proj = rng.standard_normal((d // 4, d)).astype(np.float32)
        x = (x + 3.0 * (z @ proj)) @ m
    return x


def _weights_and_gram(seed, d=128, out=64, mix=False):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d, out)) * d ** -0.5).astype(np.float32)
    x = _correlated_activations(d, seed=seed + 1, mix=mix)
    return w, (x.T @ x / len(x)).astype(np.float32), np.abs(x).mean(axis=0)


@pytest.mark.parametrize("bits,group", [(4, 64), (3, 64), (2, 32), (4, 128)])
def test_numpy_parts_bit_for_bit(bits, group):
    from crs_tpu.models import quant_calib as jq

    from crs_tpu_torch.models import quant_calib as tq

    w, gram, mean_abs = _weights_and_gram(bits + group, mix=True)
    assert np.array_equal(tq._rtn_dequant(w, bits, group), jq._rtn_dequant(w, bits, group))
    w_hat = jq._rtn_dequant(w, bits, group)
    assert tq._recon_error(w, w_hat, gram) == jq._recon_error(w, w_hat, gram)
    assert np.array_equal(tq.awq_search_scale([w, w[:, :32]], mean_abs, gram, bits, group),
                          jq.awq_search_scale([w, w[:, :32]], mean_abs, gram, bits, group))
    got, ref = (tq.gptq_quantize_tensor(w, gram, bits, group),
                jq.gptq_quantize_tensor(w, gram, bits, group))
    assert got.bits == ref.bits and got.group_size == ref.group_size and got.shape == ref.shape
    assert np.array_equal(got.codes.numpy(), np.asarray(ref.codes))
    assert np.array_equal(got.scales.numpy(), np.asarray(ref.scales))


def test_port_calibration_beats_rtn():
    """The port's AWQ and GPTQ lower the reconstruction error below plain
    rounding (``tests/test_quant_calib.py``'s acceptance, on the port)."""
    from crs_tpu_torch.models.quant_calib import (
        _recon_error, _rtn_dequant, awq_search_scale, gptq_quantize_tensor,
    )

    w, gram, mean_abs = _weights_and_gram(1)
    rtn = _recon_error(w, _rtn_dequant(w, 3, 64), gram)
    s = awq_search_scale([w], mean_abs, gram, 3, 64)
    assert _recon_error(w, _rtn_dequant(w * s[:, None], 3, 64) / s[:, None], gram) < 0.9 * rtn
    w, gram, _ = _weights_and_gram(2, mix=True)
    rtn = _recon_error(w, _rtn_dequant(w, 3, 64), gram)
    qt = gptq_quantize_tensor(w, gram, 3, 64)
    assert _recon_error(w, qt.dequantize().numpy(), gram) < 0.8 * rtn


@pytest.fixture(scope="module")
def tiny():
    """crs_tpu's tiny config and params, the port's copy, and two batches."""
    from crs_tpu.models.transformer import CONFIGS, init_params

    from crs_tpu_torch.convert import params_from_numpy
    from crs_tpu_torch.models.transformer import CONFIGS as TCONFIGS

    jp = init_params(0, CONFIGS["tiny"])
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        ids = rng.integers(0, 512, (2, 48))
        mask = np.ones((2, 48), bool)
        mask[1, 30:] = False
        batches.append((ids, mask))
    return (CONFIGS["tiny"], jp, TCONFIGS["tiny"],
            params_from_numpy(jax.tree.map(np.asarray, jp)), batches)


def test_forward_captured_matches_crs_tpu(tiny):
    from crs_tpu.models.transformer import forward_captured as jfc

    from crs_tpu_torch.models.quant_calib import SITES
    from crs_tpu_torch.models.transformer import forward_captured as tfc

    cj, jp, ct, tp, batches = tiny
    ids, mask = batches[0]
    # jitted, as collect_calibration_stats runs it (eager JAX rounds every
    # bf16 op, the residual sums included)
    lj, sj = jax.jit(lambda p, i, m: jfc(p, cj, i, m))(jp, jnp.asarray(ids), jnp.asarray(mask))
    lt, st = tfc(tp, ct, torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(st) == len(sj) == ct.num_layers
    for cap_t, cap_j in zip(st, sj):
        assert set(cap_t) == set(SITES) == set(cap_j)
        for name in SITES:
            ref = np.asarray(cap_j[name])
            got = cap_t[name].to(torch.bfloat16).view(torch.int16).numpy()
            assert np.array_equal(got, ref.view(np.int16)), name
    assert np.abs(lt.numpy() - np.asarray(lj)).max() <= LOGIT_ATOL


def test_collect_calibration_stats_matches_crs_tpu(tiny):
    from crs_tpu.models import quant_calib as jq

    from crs_tpu_torch.models import quant_calib as tq

    cj, jp, ct, tp, batches = tiny
    ref = jq.collect_calibration_stats(jp, cj, batches)
    got = tq.collect_calibration_stats(tp, ct, batches)
    for layer_t, layer_j in zip(got, ref):
        for name in tq.SITES:
            for key in ("mean_abs", "gram"):
                a, b = layer_t[name][key], layer_j[name][key]
                assert a.dtype == np.float32 and a.shape == b.shape
                assert np.abs(a - b).max() <= STATS_RTOL * np.abs(b).max(), (name, key)


def _same_tree(got, ref):
    """Every leaf of the port's params equals crs_tpu's, bit for bit."""
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _same_tree(got[k], ref[k])
    elif isinstance(ref, list):
        for g, r in zip(got, ref):
            _same_tree(g, r)
    elif hasattr(ref, "codes"):
        assert (got.bits, got.group_size, tuple(got.shape)) == (ref.bits, ref.group_size,
                                                                tuple(ref.shape))
        assert np.array_equal(got.codes.numpy(), np.asarray(ref.codes))
        assert np.array_equal(got.scales.numpy(), np.asarray(ref.scales))
    else:
        r = np.asarray(ref)
        g = got.view(torch.int16).numpy() if got.dtype == torch.bfloat16 else got.numpy()
        assert np.array_equal(g, r.view(np.int16) if r.dtype.name == "bfloat16" else r)


@pytest.mark.parametrize("method", ["awq", "gptq"])
def test_calibrated_params_bit_for_bit_given_the_stats(tiny, method):
    from crs_tpu.models import quant_calib as jq

    from crs_tpu_torch.models import quant_calib as tq

    cj, jp, ct, tp, batches = tiny
    stats = jq.collect_calibration_stats(jp, cj, batches)
    fn_j, fn_t = {"awq": (jq.awq_quantize_params, tq.awq_quantize_params),
                  "gptq": (jq.gptq_quantize_params, tq.gptq_quantize_params)}[method]
    _same_tree(fn_t(tp, ct, stats, bits=4, group_size=64),
               fn_j(jp, cj, stats, bits=4, group_size=64))


def _codes_agreement(jm, tm) -> float:
    same = total = 0
    for lj, lt in zip(jm.params["layers"], tm.params["layers"]):
        for grp in ("attn", "mlp"):
            for name, ref in lj[grp].items():
                same += int((lt[grp][name].codes.numpy() == np.asarray(ref.codes)).sum())
                total += ref.codes.size
    return same / total


@pytest.mark.parametrize("kind,min_agree", [("gptq", 0.99), ("awq", 0.999)])
def test_factory_calibrated_matches_jax_model(kind, min_agree):
    from crs_tpu.models.model_interface import create_model_interface as jcmi

    from crs_tpu_torch.models.model_interface import create_model_interface as tcmi

    jm = jcmi(kind, {"config": "tiny"})
    tm = tcmi(kind, {"config": "tiny"}, device="cpu")
    jm.load()
    tm.load()
    assert tm.quantization == jm.quantization == f"{kind}4"
    assert tm.params["layers"][0]["mlp"]["down"].bits == 4
    assert _codes_agreement(jm, tm) >= min_agree
    ids = np.arange(1, 17)[None, :]
    assert np.corrcoef(jm.forward(ids).ravel(), tm.forward(ids).ravel())[0, 1] > 0.999


def test_awq_scale_folding_is_output_preserving():
    """At 8 bits the rounding is negligible, so awq8 deviating from int8
    would expose a wrong fold (norm → q/k/v, v → o, up → down)."""
    from crs_tpu_torch.models.model_interface import TorchModel

    full = TorchModel({"config": "tiny", "seed": 0}, device="cpu")
    ids = np.arange(1, 17)[None, :]
    a = full.forward(ids).ravel()
    corrs = {}
    for quant in ("int8", "awq8", "awq4", "gptq4"):
        m = TorchModel({"config": "tiny", "seed": 0, "quantization": quant, "group_size": 32},
                       device="cpu")
        corrs[quant] = float(np.corrcoef(a, m.forward(ids).ravel())[0, 1])
    assert corrs["awq8"] > 0.999, corrs
    assert abs(corrs["awq8"] - corrs["int8"]) < 2e-3, corrs
    assert corrs["awq4"] > 0.85 and corrs["gptq4"] > 0.85, corrs


def _text_pdf(path: pathlib.Path, pages) -> None:
    """A PDF of one Helvetica text line per page, uncompressed."""
    n = len(pages)
    objs = {1: b"<< /Type /Catalog /Pages 2 0 R >>",
            2: b"<< /Type /Pages /Kids [%s] /Count %d >>" % (
                b" ".join(b"%d 0 R" % (4 + 2 * i) for i in range(n)), n),
            3: b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>"}
    for i, text in enumerate(pages):
        content = b"BT /F1 10 Tf 40 700 Td (" + text.encode("latin-1") + b") Tj ET"
        objs[4 + 2 * i] = (b"<< /Type /Page /Parent 2 0 R /Resources << /Font << /F1 3 0 R >> >> "
                           b"/Contents %d 0 R >>" % (5 + 2 * i))
        objs[5 + 2 * i] = b"<< /Length %d >>\nstream\n%s\nendstream" % (len(content), content)
    body = b"".join(b"%d 0 obj\n%s\nendobj\n" % (k, v) for k, v in sorted(objs.items()))
    path.write_bytes(b"%PDF-1.4\n" + body + b"trailer\n<< /Root 1 0 R >>\n%%EOF\n")


def test_calibration_batches_read_the_pdf_like_crs_tpu(tmp_path, monkeypatch):
    """With a corpus PDF both packages read it through process_pdf and build
    the same batches; without one both draw the same random tokens."""
    from crs_tpu.models.model_interface import JaxModel

    from crs_tpu_torch.models.model_interface import TorchModel

    words = ("quantized retrieval keeps recall high while the index shrinks " * 8).split()
    pages = [" ".join(words[i:] + words[:i]) for i in range(3)] + ["too short to calibrate"]
    pdf = tmp_path / "corpus.pdf"
    _text_pdf(pdf, pages)
    firsts = []
    for path in (str(pdf), str(tmp_path / "absent.pdf")):
        monkeypatch.setattr(JaxModel, "_CALIB_PDF", path)
        jm = JaxModel({"config": "tiny", "seed": 5})
        tm = TorchModel({"config": "tiny", "seed": 5, "calibration_pdf": path}, device="cpu")
        for m in (jm, tm):
            m.load()
        ref, got = jm._calibration_batches(), tm._calibration_batches()
        assert len(got) == len(ref) == 4
        for (ids_t, mask_t), (ids_j, mask_j) in zip(got, ref):
            assert np.array_equal(ids_t, ids_j) and np.array_equal(mask_t, mask_j)
        firsts.append(got[0][0])
    assert not np.array_equal(firsts[0], firsts[1])  # the PDF's text, not the random tokens


# -- ops/quant.py's weight quantizers ------------------------------------------------

@pytest.mark.parametrize("group", [32, 64])
def test_weight_quantizers_match_crs_tpu(group):
    from crs_tpu.ops import quant as jq

    from crs_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(group)
    w = (rng.standard_normal((128, 96)) * 0.1).astype(np.float32)
    w[:, 5] = 0.0  # an all-zero channel: the 1e-12 floor
    wt = torch.from_numpy(w)
    for got, ref in ((tq.quantize_int8_rowwise(wt), jq.quantize_int8_rowwise(jnp.asarray(w))),
                     (tq.quantize_int4_grouped(wt, group),
                      jq.quantize_int4_grouped(jnp.asarray(w), group))):
        for g, r in zip(got, ref):
            r = np.asarray(r)
            assert g.numpy().dtype == r.dtype and np.array_equal(g.numpy(), r)
    codes, scales = jq.quantize_int4_grouped(jnp.asarray(w), group)
    assert np.array_equal(
        tq.dequantize_int4_grouped(torch.from_numpy(np.array(codes)),
                                   torch.from_numpy(np.array(scales)), group).numpy(),
        np.asarray(jq.dequantize_int4_grouped(codes, scales, group)))
    c8, s8 = jq.quantize_int8_rowwise(jnp.asarray(w.T))
    assert np.array_equal(
        tq.scalar_dequantize(torch.from_numpy(np.array(c8)).T.contiguous(),
                             torch.from_numpy(np.array(s8))).numpy(),
        np.asarray(jq.scalar_dequantize(jnp.asarray(np.asarray(c8).T), s8)))
    with pytest.raises(ValueError):
        tq.quantize_int4_grouped(wt[:100], group)
