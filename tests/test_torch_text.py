"""The port's host text layer against ``crs_tpu``'s, on the held-out corpus.

Featurization, sentence splitting, cleaning and chunking are host code with
no floating-point reordering, so everything must be identical: features
(indices, weights, offsets), chunk texts, ids, offsets and token counts.
"""

import pathlib

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


REPO = pathlib.Path(__file__).resolve().parent.parent
CORPUS = REPO / "results" / "selftrained" / "heldout_corpus.txt"
QA = REPO / "results" / "selftrained" / "heldout_qa.json"


@pytest.fixture(scope="module")
def texts():
    import json

    lines = [ln for ln in CORPUS.read_text(encoding="utf-8").splitlines() if ln.strip()]
    questions = [x["question"] for x in json.loads(QA.read_text())]
    extra = ["Ünïcödé wörds — and 12,345 numbers!", "", "  ", "a" * 300 + " tail",
             "MiXeD CaSe\tTabs\nNewlines"]
    return lines + questions + extra


def _assert_csr_equal(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
        assert np.asarray(g).dtype == np.asarray(r).dtype


@pytest.mark.parametrize("num_features", [32768, 1000])
def test_featurize_batch_native_identical(texts, num_features):
    from crs_tpu.rag import hashed_features as jhf
    from crs_tpu_torch.rag import hashed_features as thf

    assert thf.native_available()
    _assert_csr_equal(thf.featurize_batch(texts, num_features),
                      jhf.featurize_batch(texts, num_features))


@pytest.mark.parametrize("num_features", [32768, 1000])
def test_featurize_batch_python_path_identical(texts, num_features):
    from crs_tpu.rag import hashed_features as jhf
    from crs_tpu_torch.rag import hashed_features as thf

    _assert_csr_equal(thf._featurize_batch_py(texts, num_features),
                      jhf.featurize_batch(texts, num_features))


@pytest.mark.parametrize("parts", ["both", "word", "char"])
@pytest.mark.parametrize("native", [True, False])
def test_featurize_batch_counts_identical(texts, parts, native):
    from crs_tpu.rag import hashed_features as jhf
    from crs_tpu_torch.rag import hashed_features as thf

    ref = jhf.featurize_batch_counts(texts, 131072, parts=parts)
    if native:
        got = thf.featurize_batch_counts(texts, 131072, parts=parts)
    else:
        char = parts != "word"
        got = thf._count_batch_py(texts, 131072, char_ngrams=char, word_grams=parts != "char")
    _assert_csr_equal(got, ref)


def test_featurize_single_and_helpers(texts):
    from crs_tpu.rag import hashed_features as jhf
    from crs_tpu_torch.rag import hashed_features as thf

    for t in texts[:20]:
        assert thf.featurize(t, 32768) == jhf.featurize(t, 32768)
        assert thf._featurize_py(t, 32768) == jhf._featurize_py(t, 32768)
        assert thf._tokenize_bytes(t) == jhf._tokenize_bytes(t)
    for w in (b"", b"a", b"quantization", "ü".encode()):
        assert thf._fnv1a(w) == jhf._fnv1a(w)


def test_split_sentences_identical(texts):
    from crs_tpu.utils.sentences import split_sentences as jsplit
    from crs_tpu_torch.utils.sentences import split_sentences as tsplit

    whole = CORPUS.read_text(encoding="utf-8")
    for t in texts + [whole, "Dr. Smith et al. found 3.5 B params. Next (Fig. 2) shows it."]:
        assert tsplit(t) == jsplit(t)


def test_document_processing_identical():
    from crs_tpu.rag.document_processing import DocumentProcessor as JDP
    from crs_tpu_torch.rag.document_processing import DocumentProcessor as TDP

    for cfg in ({}, {"clean_text": False}, {"remove_citations": False, "remove_urls": False}):
        jdp, tdp = JDP(cfg), TDP(cfg)
        pages = tdp.process_file(str(CORPUS))
        assert pages == jdp.process_file(str(CORPUS))
        text = pages[0][0]
        assert tdp.extract_sections(text) == jdp.extract_sections(text)
        assert tdp.section_spans(text) == jdp.section_spans(text)
    raw = "Page 12\n1 Introduction\nSee [1, 2] and (Smith et al., 2020) at https://x.io ﬁne “q”."
    assert TDP().process_text(raw) == JDP().process_text(raw)


def _chunk_fields(chunks):
    return [(c.text, c.chunk_id, c.start_char, c.end_char, c.page_number, c.section, c.tokens,
             c.to_metadata()) for c in chunks]


@pytest.mark.parametrize("config", [
    {"strategy": "semantic", "chunk_size": 160, "chunk_overlap": 30, "min_chunk_size": 10},
    {"strategy": "semantic"},
    {"strategy": "sentence", "chunk_size": 60, "chunk_overlap": 10, "min_chunk_size": 5},
    {"strategy": "fixed", "chunk_size": 50, "chunk_overlap": 20, "min_chunk_size": 5},
], ids=["bench", "semantic_default", "sentence", "fixed"])
def test_chunks_identical(config):
    from crs_tpu.rag.chunking import TextChunker as JTC
    from crs_tpu.rag.document_processing import DocumentProcessor as JDP
    from crs_tpu_torch.rag.chunking import TextChunker as TTC
    from crs_tpu_torch.rag.document_processing import DocumentProcessor as TDP

    j_pages = JDP({}).process_file(str(CORPUS))
    t_pages = TDP({}).process_file(str(CORPUS))
    jck, tck = JTC(config), TTC(config)
    ref = [c for t, p in j_pages for c in jck.chunk(t, page_number=p, section="s")]
    got = [c for t, p in t_pages for c in tck.chunk(t, page_number=p, section="s")]
    assert got and _chunk_fields(got) == _chunk_fields(ref)


def test_chunker_rejects_bad_config():
    from crs_tpu_torch.rag.chunking import TextChunker

    with pytest.raises(ValueError):
        TextChunker({"strategy": "nope"})
    with pytest.raises(ValueError):
        TextChunker({"chunk_size": 10, "chunk_overlap": 10})
