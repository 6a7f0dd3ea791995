"""The port's PDF text layer (``crs_tpu_torch/utils/pdftext.py`` and
``DocumentProcessor.process_pdf``) against ``crs_tpu``'s.

Inputs: the repository's one PDF (``report/paper/figures/pq_curve_4m.pdf``)
and PDFs the test writes — one page with a simple byte-encoded font in an
uncompressed stream, one with a Type0 / Identity-H font, a ``/ToUnicode``
CMap (bfchar and bfrange) and a FlateDecode stream. Tolerance: none; pages,
cleaned text and page numbers must be identical.
"""

import pathlib
import zlib

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
FIGURE_PDF = REPO / "report" / "paper" / "figures" / "pq_curve_4m.pdf"

_CMAP = b"""/CIDInit /ProcSet findresource begin
12 dict begin
begincmap
1 begincodespacerange
<0000> <FFFF>
endcodespacerange
2 beginbfchar
<0001> <0051>
<0002> <0020>
endbfchar
1 beginbfrange
<0010> <0019> <0061>
endbfrange
endcmap
end end"""


def _stream(dict_extra: bytes, data: bytes) -> bytes:
    return b"<< /Length %d%s >>\nstream\n%s\nendstream" % (len(data), dict_extra, data)


def _write_pdf(path: pathlib.Path) -> None:
    """Two pages: page 1 Helvetica, uncompressed, Tj / TJ / ' and line moves;
    page 2 a CID font through a ToUnicode CMap, FlateDecode."""
    page1 = (b"BT /F1 12 Tf 72 720 Td (Quantized retrieval keeps recall high.) Tj "
             b"0 -14 Td [(Product ) -250 (quantization) ] TJ "
             b"0 -14 Td (Section 2 Methods) Tj T* (page 7) ' ET")
    # Q, space, then a..j through the bfrange
    cid = b"".join(b"%04X" % c for c in (1, 2, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15))
    page2 = zlib.compress(b"BT /F2 10 Tf 50 700 Td <" + cid + b"> Tj 0 -20 Td <0001> Tj ET")
    objs = {
        1: b"<< /Type /Catalog /Pages 2 0 R >>",
        2: b"<< /Type /Pages /Kids [3 0 R 4 0 R] /Count 2 >>",
        3: b"<< /Type /Page /Parent 2 0 R /Resources << /Font << /F1 5 0 R >> >> "
           b"/Contents 7 0 R >>",
        4: b"<< /Type /Page /Parent 2 0 R /Resources << /Font << /F2 6 0 R >> >> "
           b"/Contents 8 0 R >>",
        5: b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
        6: b"<< /Type /Font /Subtype /Type0 /BaseFont /Test /Encoding /Identity-H "
           b"/ToUnicode 9 0 R >>",
        7: _stream(b"", page1),
        8: _stream(b" /Filter /FlateDecode", page2),
        9: _stream(b"", _CMAP),
    }
    out = b"%PDF-1.4\n" + b"".join(b"%d 0 obj\n%s\nendobj\n" % (n, body)
                                   for n, body in sorted(objs.items()))
    path.write_bytes(out + b"trailer\n<< /Root 1 0 R >>\n%%EOF\n")


@pytest.fixture(scope="module")
def written_pdf(tmp_path_factory):
    path = tmp_path_factory.mktemp("pdf") / "written.pdf"
    _write_pdf(path)
    return path


def _pdfs(written_pdf):
    return [FIGURE_PDF, written_pdf]


def test_written_pdf_reads_back(written_pdf):
    from crs_tpu_torch.utils.pdftext import extract_pdf_pages

    pages = extract_pdf_pages(str(written_pdf))
    assert len(pages) == 2
    assert "Quantized retrieval keeps recall high." in pages[0]
    assert "quantization" in pages[0] and "Q abcdef" in pages[1]


@pytest.mark.parametrize("which", [0, 1], ids=["figure", "written"])
def test_extract_pdf_pages_matches_crs_tpu(written_pdf, which):
    from crs_tpu.utils import pdftext as ref

    from crs_tpu_torch.utils import pdftext

    path = str(_pdfs(written_pdf)[which])
    assert pdftext.extract_pdf_pages(path) == ref.extract_pdf_pages(path)
    assert pdftext.extract_pdf_text(path) == ref.extract_pdf_text(path)


@pytest.mark.parametrize("clean", [True, False])
@pytest.mark.parametrize("which", [0, 1], ids=["figure", "written"])
def test_process_pdf_matches_crs_tpu(written_pdf, which, clean):
    from crs_tpu.rag.document_processing import DocumentProcessor as Ref

    from crs_tpu_torch.rag.document_processing import DocumentProcessor

    path = str(_pdfs(written_pdf)[which])
    cfg = {"clean_text": clean}
    got = DocumentProcessor(cfg).process_pdf(path)
    assert got == Ref(cfg).process_pdf(path)
    assert DocumentProcessor(cfg).process_file(path) == got


def test_garbage_pdf_raises_in_both(tmp_path):
    """A file with no PDF objects raises the same error in both packages."""
    from crs_tpu.utils import pdftext as ref

    from crs_tpu_torch.utils import pdftext

    path = tmp_path / "garbage.pdf"
    path.write_bytes(b"%PDF-1.4\nnot really a pdf\n")
    with pytest.raises(ref.PdfParseError):
        ref.extract_pdf_pages(str(path))
    with pytest.raises(pdftext.PdfParseError):
        pdftext.extract_pdf_pages(str(path))
