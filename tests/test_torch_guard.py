"""Guards of the PyTorch port: no JAX on its import graph, the device rule,
and a kernel wrapper that raises instead of falling back."""

import ast
import pathlib

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "crs_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "crs_tpu", "optax")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path} imports {bad}"


def test_guard_sees_the_port():
    assert len(PORT_FILES) >= 15
    assert _forbidden("jax.numpy") and _forbidden("crs_tpu.rag") and not _forbidden("crs_tpu_torch.ops")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _entry_points():
    from crs_tpu_torch import resolve_device
    from crs_tpu_torch.rag.embedding import EmbeddingModel, HashedEncoder
    from crs_tpu_torch.rag.index import VectorStore

    return {
        "resolve_device": lambda dev: resolve_device(dev),
        "EmbeddingModel": lambda dev: EmbeddingModel({"backend": "hashed", "embedding_dim": 16}, device=dev),
        "HashedEncoder": lambda dev: HashedEncoder(dim=16, num_features=64, device=dev),
        "VectorStore": lambda dev: VectorStore({"format": "int8"}, device=dev),
    }


@pytest.mark.parametrize("name", ["resolve_device", "EmbeddingModel", "HashedEncoder", "VectorStore"])
@pytest.mark.parametrize("device", [None, "cuda"])
def test_cuda_request_raises_without_cuda(no_cuda, name, device):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name](device)


@pytest.mark.parametrize("name", ["resolve_device", "EmbeddingModel", "HashedEncoder", "VectorStore"])
def test_explicit_cpu_runs(no_cuda, name):
    assert _entry_points()[name]("cpu") is not None


def test_unported_options_raise():
    from crs_tpu_torch.rag.document_processing import DocumentProcessor
    from crs_tpu_torch.rag.embedding import EmbeddingModel
    from crs_tpu_torch.rag.index import VectorStore
    from crs_tpu_torch.rag.retrieval import ContextRetriever

    for backend in ("lexical", "minilm"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            EmbeddingModel({"backend": backend}, device="cpu")
    for fmt in ("fp32", "bf16", "pq"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            VectorStore({"format": fmt}, device="cpu")
    with pytest.raises(ValueError):
        VectorStore({"format": "int4"}, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DocumentProcessor().process_file("paper.pdf")
    store = VectorStore({"format": "int8"}, device="cpu")
    em = EmbeddingModel({"backend": "hashed", "embedding_dim": 16}, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContextRetriever(store, em, {"prf_beta": 0.5})


class _FakeLib:
    """Stands in for the loaded kernel library: records launches, returns ``err``."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def int8_scan_topk_launch(self, *args):
        self.calls.append(args)
        return self.err


def _card_operands(kb=2, d=64, rows=512, queries=64, device="meta"):
    return (
        torch.empty((queries, d), dtype=torch.int8, device=device),
        torch.empty((rows, d), dtype=torch.int8, device=device),
        torch.empty((rows,), dtype=torch.float32, device=device),
        torch.empty((rows,), dtype=torch.float32, device=device),
        kb,
    )


@pytest.fixture
def fake_card(monkeypatch):
    """Non-CPU tensors reach the kernel path; the plain version must not run."""
    from crs_tpu_torch.ops import scan

    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("the wrapper fell back to the plain version")

    monkeypatch.setattr(scan, "block_topk_int8_plain", plain_must_not_run)
    monkeypatch.setattr(scan, "_stream_handle", lambda device: 0)
    return scan


@pytest.mark.parametrize("err", [1, 700])
def test_wrapper_raises_when_launch_fails(fake_card, monkeypatch, err):
    lib = _FakeLib(err)
    monkeypatch.setattr(fake_card, "_load_lib", lambda: lib)
    before = fake_card.STATS.launches
    with pytest.raises(RuntimeError, match=f"CUDA error {err}"):
        fake_card.block_topk_int8(*_card_operands())
    assert len(lib.calls) == 1
    assert fake_card.STATS.launches == before  # a failed launch is not counted


def test_wrapper_raises_when_library_cannot_load(fake_card, monkeypatch):
    def no_nvcc():
        raise RuntimeError("compiler for int8_scan_topk.cu not found")

    monkeypatch.setattr(fake_card, "_load_lib", no_nvcc)
    with pytest.raises(RuntimeError, match="not found"):
        fake_card.block_topk_int8(*_card_operands())


def test_wrapper_counts_a_launch(fake_card, monkeypatch):
    lib = _FakeLib(0)
    monkeypatch.setattr(fake_card, "_load_lib", lambda: lib)
    before = fake_card.STATS.launches
    out_s, out_i = fake_card.block_topk_int8(*_card_operands(kb=3))
    assert fake_card.STATS.launches == before + 1
    assert out_s.shape == (1, 2, 3, 64) and out_i.dtype == torch.int32
    q, codes, rs, bias, out_s_ptr, out_i_ptr, nq, nblocks, d, kb, stream = lib.calls[0]
    assert (nq, nblocks, d, kb) == (1, 2, 64, 3)


@pytest.mark.parametrize("bad", ["dtype", "rows", "dim", "kb", "block_size", "contiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(fake_card, monkeypatch, bad):
    monkeypatch.setattr(fake_card, "_load_lib", lambda: _FakeLib(0))
    q, codes, rs, bias, kb = _card_operands()
    kwargs = {}
    if bad == "dtype":
        codes = codes.float()
    elif bad == "rows":
        codes, rs, bias = codes[:300], rs[:300], bias[:300]
    elif bad == "dim":
        q, codes = q[:, :40].contiguous(), codes[:, :40].contiguous()
    elif bad == "kb":
        kb = 0
    elif bad == "block_size":
        kwargs["block_size"] = 512
    else:
        codes = torch.empty((64, 512), dtype=torch.int8, device="meta").T
    with pytest.raises(ValueError):
        fake_card.block_topk_int8(q, codes, rs, bias, kb, **kwargs)
