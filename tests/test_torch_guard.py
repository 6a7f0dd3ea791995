"""Guards of the PyTorch port: no JAX on its import graph, the device rule,
and a kernel wrapper that raises instead of falling back."""

import ast
import pathlib

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
PORT_FILES = sorted((REPO / "crs_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    """JAX, the JAX package, and its scripts' directories (``tools/``, ``examples/``)."""
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "crs_tpu", "optax", "tools", "examples")


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
    assert _forbidden("tools.ir_eval") and _forbidden("examples.quickstart")
    assert not _forbidden("crs_tpu_torch.tools.ir_eval")


def test_guard_sees_the_mesh_modules():
    """The multi-device modules are among the files the import guard reads."""
    for rel in ("parallel/__init__.py", "parallel/mesh.py", "parallel/sharded_index.py",
                "parallel/collectives.py", "models/sharding.py"):
        assert REPO / "crs_tpu_torch" / rel in PORT_FILES, rel


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """A mesh constructor run here makes a one-rank group: end it after the test."""
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _entry_points():
    from crs_tpu_torch import resolve_device
    from crs_tpu_torch.rag.embedding import EmbeddingModel, HashedEncoder
    from crs_tpu_torch.models import TorchModel, create_model_interface
    from crs_tpu_torch.rag.index import VectorStore
    from crs_tpu_torch.rag.pipeline import RAGPipeline
    from crs_tpu_torch.models.sharding import make_model_mesh
    from crs_tpu_torch.parallel import corpus_mesh

    return {
        "corpus_mesh": lambda dev: corpus_mesh(device=dev),
        "make_model_mesh": lambda dev: make_model_mesh(device=dev),
        "VectorStore_mesh": lambda dev: VectorStore({"format": "int8"}, device=dev,
                                                    mesh=corpus_mesh(device="cpu")),
        "resolve_device": lambda dev: resolve_device(dev),
        "EmbeddingModel": lambda dev: EmbeddingModel({"backend": "hashed", "embedding_dim": 16}, device=dev),
        "EmbeddingModel_lexical": lambda dev: EmbeddingModel(
            {"backend": "lexical", "embedding_dim": 16, "num_features": 64}, device=dev),
        "EmbeddingModel_minilm": lambda dev: EmbeddingModel({"backend": "minilm"}, device=dev),
        "HashedEncoder": lambda dev: HashedEncoder(dim=16, num_features=64, device=dev),
        "VectorStore": lambda dev: VectorStore({"format": "int8"}, device=dev),
        "VectorStore_fp32": lambda dev: VectorStore({"format": "fp32"}, device=dev),
        "VectorStore_bf16": lambda dev: VectorStore({"format": "bf16"}, device=dev),
        "VectorStore_pq": lambda dev: VectorStore({"format": "pq"}, device=dev),
        "VectorStore_pq_sorted": lambda dev: VectorStore({"format": "pq", "pq_sorted": True},
                                                         device=dev),
        "TorchModel": lambda dev: TorchModel({"config": "tiny"}, device=dev),
        "create_model_interface": lambda dev: create_model_interface(
            "nf4", {"config": "tiny", "kv_bits": 8}, device=dev),
        "create_model_interface_gptq": lambda dev: create_model_interface(
            "gptq", {"config": "tiny"}, device=dev),
        "create_model_interface_awq": lambda dev: create_model_interface(
            "awq", {"config": "tiny"}, device=dev),
        "TorchModel_fused_mlp": lambda dev: create_model_interface(
            "int8", {"config": "tiny", "fused_mlp": True}, device=dev),
        "TorchModel_fuse_projections": lambda dev: TorchModel(
            {"config": "tiny", "fuse_projections": True}, device=dev),
        "TorchModel_model_path": lambda dev: TorchModel({"model_path": "hf_dir"}, device=dev),
        "RAGPipeline": lambda dev: RAGPipeline(
            {"embedding": {"backend": "hashed", "embedding_dim": 16}}, device=dev).setup(),
    }


ENTRY_POINTS = ["resolve_device", "EmbeddingModel", "EmbeddingModel_lexical",
                "EmbeddingModel_minilm", "HashedEncoder", "VectorStore",
                "VectorStore_fp32", "VectorStore_bf16", "VectorStore_pq", "VectorStore_pq_sorted",
                "TorchModel",
                "create_model_interface", "RAGPipeline", "create_model_interface_gptq",
                "create_model_interface_awq", "TorchModel_fused_mlp",
                "TorchModel_fuse_projections", "TorchModel_model_path", "corpus_mesh",
                "make_model_mesh", "VectorStore_mesh"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
@pytest.mark.parametrize("device", [None, "cuda"])
def test_cuda_request_raises_without_cuda(no_cuda, name, device):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name](device)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_explicit_cpu_runs(no_cuda, name):
    assert _entry_points()[name]("cpu") is not None


def test_unported_options_raise():
    from crs_tpu_torch.rag.document_processing import DocumentProcessor
    from crs_tpu_torch.rag.embedding import EmbeddingModel
    from crs_tpu_torch.rag.index import VectorStore
    from crs_tpu_torch.rag.retrieval import ContextRetriever

    for backend in ("lexical", "minilm"):  # ported: both build and embed
        em = EmbeddingModel({"backend": backend, "embedding_dim": 384, "num_features": 1024},
                            device="cpu")
        emb = em.embed(["what is gptq?", "pruning removes weights"], is_query=True)
        assert emb.shape == (2, 384) and torch.allclose(emb.norm(dim=1), torch.ones(2))
    sorted_store = VectorStore({"format": "pq", "pq_sorted": True}, device="cpu")  # ported
    assert sorted_store.pq_sorted
    with pytest.raises(ValueError):
        VectorStore({"format": "int4"}, device="cpu")
    pdf = REPO / "report" / "paper" / "figures" / "pq_curve_4m.pdf"  # PDF input is ported
    assert isinstance(DocumentProcessor().process_file(str(pdf)), list)
    rng = torch.Generator().manual_seed(0)
    emb = torch.nn.functional.normalize(torch.randn((40, 16), generator=rng), dim=1)
    for fmt in ("fp32", "bf16", "int8"):  # every format is ported, and so is add
        store = VectorStore({"format": fmt, "block_size": 32}, device="cpu")
        store.add(["a", "b"], emb[:2])  # an empty store builds
        store.add([f"c{i}" for i in range(38)], emb[2:])  # then grows
        assert store.n == 40 and store._padded_rows() == 96  # 2 + 64 padded rows, rounded up
        assert store.search_batch(emb[30:32], top_k=1)[1][:, 0].tolist() == [30, 31]
    em = EmbeddingModel({"backend": "hashed", "embedding_dim": 16}, device="cpu")
    assert ContextRetriever(store, em, {"prf_beta": 0.5}).prf_beta == 0.5  # PRF is ported


def test_unported_model_options_raise(tmp_path):
    """What raised before the evaluation slice — log-likelihoods,
    ``evaluate`` — now answers (an empty store: no chunks, no generator: no
    answers), and the options ported since load: the calibrated types, the two serving
    flags (not together), a Hugging Face directory (one without weights
    refuses to fall back to random init), and pipelines on the lexical and
    minilm embedding backends."""
    import json

    from crs_tpu_torch.models import TorchModel, create_model_interface
    from crs_tpu_torch.rag.pipeline import RAGPipeline

    for kind in ("gptq", "awq"):
        model = create_model_interface(kind, {"config": "tiny"}, device="cpu")
        model.load()
        assert model.params["layers"][0]["attn"]["q"].bits == 4
    model = create_model_interface("int8", {"config": "tiny", "fuse_projections": True},
                                   device="cpu")
    model.load()
    assert model.get_model_info()["fused_projections"] and "qkv" in model.params["layers"][0]["attn"]
    model = create_model_interface("int8", {"config": "tiny", "fused_mlp": True}, device="cpu")
    model.load()
    # tiny's intermediate width (256) does not divide by the chunk of 1024: as in
    # crs_tpu, no layer takes the fused layout
    assert model.get_model_info()["fused_mlp"] and "fused" not in model.params["layers"][0]["mlp"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        TorchModel({"config": "tiny", "fuse_projections": True, "fused_mlp": True}, device="cpu")
    (tmp_path / "config.json").write_text(json.dumps({  # a Hugging Face directory, no weights
        "vocab_size": 97, "hidden_size": 64, "num_hidden_layers": 1, "num_attention_heads": 4,
        "intermediate_size": 128}))
    with pytest.raises(RuntimeError, match="no weights could be loaded"):
        TorchModel({"model_path": str(tmp_path)}, device="cpu").load()
    model = TorchModel({"config": "tiny"}, device="cpu")
    ll = model.get_loglikelihood("a", "b")
    assert isinstance(ll, float) and ll < 0
    for backend in ("lexical", "minilm"):
        pipe = RAGPipeline({"embedding": {"backend": backend, "num_features": 1024},
                            "vector_store": {"format": "int8"}}, device="cpu").setup()
        assert pipe.embedder.backend == backend
        pipe.index_documents(["Quantization maps weights to low precision integers. " * 8,
                              "Pruning removes unimportant weights from the network. " * 8])
        assert pipe.store.n > 0 and pipe.retrieve("what is quantization?", top_k=1)
    pipe = RAGPipeline({"embedding": {"backend": "hashed", "embedding_dim": 16}}, device="cpu")
    out = pipe.setup().evaluate([{"question": "q"}])
    assert out["chunks"] == [[]] and out["contexts"] == [""] and "rag_answers" not in out


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
    q, codes, rs, bias, out_s_ptr, out_i_ptr, nq, nblocks, d, kb, block_size, stream = \
        lib.calls[0]
    assert (nq, nblocks, d, kb, block_size) == (1, 2, 64, 3, 256)


@pytest.mark.parametrize("block_size", [1, 128, 640, 1000, 512, 1024, 4096])
def test_kernel_1_launches_any_block(fake_card, monkeypatch, block_size):
    """Kernel 1 takes any block_size (it scanned 256-row blocks only until
    its wgmma redesign; a block's last chunk masks the columns past the
    block's end): the launcher receives the block and the partials have one
    entry per block."""
    lib = _FakeLib(0)
    monkeypatch.setattr(fake_card, "_load_lib", lambda: lib)
    fake_card.STATS.reset()
    rows = 8 * block_size
    q, codes, rs, bias, kb = _card_operands(rows=rows)
    out_s, _ = fake_card.block_topk_int8(q, codes, rs, bias, kb, block_size=block_size)
    assert fake_card.STATS.by_kernel == {"int8_scan_topk": 1}
    assert out_s.shape == (1, 8, 2, 64)
    assert lib.calls[0][6:11] == (1, 8, 64, 2, block_size)


@pytest.mark.parametrize("block_size", [128, 640])
def test_int8_store_launches_kernel_1_on_its_own_blocks(monkeypatch, block_size):
    """An int8 store of any block_size reaches kernel 1 on its own blocks:
    the store passes its block_size to ``scan_topk_int8``, which scans its
    codes as they are (whole blocks already: no padded copy), and the
    wrapper launches at that block. The launch is faked on meta copies of
    the operands; the plain version gives the partials, and the store's
    results equal its dense route's."""
    from crs_tpu_torch.ops import scan
    from crs_tpu_torch.rag.index import VectorStore

    lib = _FakeLib(0)
    monkeypatch.setattr(scan, "_load_lib", lambda: lib)
    monkeypatch.setattr(scan, "_stream_handle", lambda device: 0)
    wrapper, plain = scan.block_topk_int8, scan.block_topk_int8_plain
    seen = []

    def launch_then_plain(q_codes, codes, row_scale, bias, kb, bs):
        seen.append((codes.data_ptr(), bs))
        meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
                for t in (q_codes, codes, row_scale, bias)]
        wrapper(*meta, kb, bs)
        return plain(q_codes, codes, row_scale, bias, kb, bs)

    monkeypatch.setattr(scan, "block_topk_int8", launch_then_plain)
    rng = torch.Generator().manual_seed(block_size)
    emb = torch.nn.functional.normalize(torch.randn((1500, 16), generator=rng), dim=1)
    store = VectorStore({"format": "int8", "block_size": block_size}, device="cpu")
    store.add([f"t{i}" for i in range(1500)], emb)
    dense = store.search_batch(emb[:5], top_k=4)
    monkeypatch.setattr(VectorStore, "_scan_here", lambda self, rows: True)
    scan.STATS.reset()
    got = store.search_batch(emb[:5], top_k=4)
    assert seen and all(at == (store._codes.data_ptr(), block_size) for at in seen)
    assert scan.STATS.by_kernel == {"int8_scan_topk": len(seen)}
    nblocks = store._codes.shape[0] // block_size
    assert lib.calls[0][6:11] == (1, nblocks, 16, lib.calls[0][9], block_size)
    assert torch.equal(got[1], dense[1]) and torch.allclose(got[0], dense[0])


@pytest.mark.parametrize("bad", ["dtype", "rows", "dim", "kb", "block_size", "contiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(fake_card, monkeypatch, bad):
    monkeypatch.setattr(fake_card, "_load_lib", lambda: _FakeLib(0))
    q, codes, rs, bias, kb = _card_operands()
    kwargs = {}
    if bad == "dtype":
        codes = codes.float()
    elif bad == "rows":
        codes, rs, bias = codes[:300], rs[:300], bias[:300]
    elif bad == "dim":  # the queries' D is not the corpus's (any one D is taken)
        q = q[:, :40].contiguous()
    elif bad == "kb":
        kb = 0
    elif bad == "block_size":  # no rows a block (any positive block is taken)
        kwargs["block_size"] = 0
    else:
        codes = torch.empty((64, 512), dtype=torch.int8, device="meta").T
    with pytest.raises(ValueError):
        fake_card.block_topk_int8(q, codes, rs, bias, kb, **kwargs)


# -- the float and ADC kernels' wrappers ----------------------------------------

class _FakeKernels:
    """Stands in for a loaded kernel library: records each launcher's calls.
    The fused MLP's plan says what the kernel's says at H 128: hq and hmid
    leave shared memory past a chunk of 16,384, for a slab of 5·R·8·rows
    bytes a chunk (rows = ⌈chunk / 8⌉ in whole 16-row tiles)."""

    def __init__(self, err):
        self.err, self.calls = err, []

    @staticmethod
    def fused_mlp_int8_hq_in_slab(h, chunk):
        return int(chunk > 16384)

    @staticmethod
    def fused_mlp_int8_hg_slab_bytes(r, chunk):
        return 5 * r * 8 * ((-(-chunk // 8) + 15) // 16 * 16)

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)

        def launch(*args):
            self.calls.append((name, args))
            return self.err

        return launch


def _float_operands(dtype=torch.float32, kb=2, d=64, rows=1024, queries=64):
    return (torch.empty((queries, d), dtype=dtype, device="meta"),
            torch.empty((rows, d), dtype=dtype, device="meta"),
            torch.empty((rows,), dtype=torch.float32, device="meta"), kb, 512)


def _adc_operands(residual=True, kb=2, m=8, rows=1024, queries=8, c=512):
    lut = torch.empty((queries, m, 256), dtype=torch.bfloat16, device="meta")
    codes = torch.empty((rows, m + (2 if residual else 0)), dtype=torch.uint8, device="meta")
    bias = torch.empty((rows,), dtype=torch.float32, device="meta")
    coarse = (torch.empty((queries, c), dtype=torch.bfloat16, device="meta"),) * 2
    return (lut, codes, bias, kb, 512) + (coarse if residual else ())


@pytest.fixture
def fake_kernels(monkeypatch):
    """Non-CPU tensors reach the kernels; the plain versions must not run."""
    from crs_tpu_torch.ops import scan

    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("the wrapper fell back to the plain version")

    for name in ("block_topk_float_plain", "block_topk_adc_plain", "block_topk_adc_sorted_plain",
                 "block_topk_segmax_plain", "block_topk_segmax_int8_plain"):
        monkeypatch.setattr(scan, name, plain_must_not_run)
    monkeypatch.setattr(scan, "_stream_handle", lambda device: 0)
    monkeypatch.setattr(scan, "_adc_grid_x", lambda nblocks, nq, dev: 4)
    return scan


def _sorted_operands(kb=2, m=8, rows=1024, queries=8, c=512, group=2, tiles=1):
    lut, codes, bias, kb, bs, hi, lo = _adc_operands(kb=kb, m=m, rows=rows, queries=queries,
                                                     c=c + 256)
    return (lut, codes, bias, kb, bs, hi, lo,
            torch.empty((tiles,), dtype=torch.int32, device="meta"), group)


def _segmax_operands(dtype=torch.float32, kseg=2, d=64, rows=1024, queries=None):
    from crs_tpu_torch.ops.scan import SEGMAX_QUERY_TILE

    queries = queries or SEGMAX_QUERY_TILE
    q = torch.empty((queries, d), dtype=dtype, device="meta")
    vecs = torch.empty((rows, d), dtype=dtype, device="meta")
    if dtype != torch.int8:
        return q, vecs, 1000, kseg, 512
    scale = torch.empty((queries,), dtype=torch.float32, device="meta")
    rs = torch.empty((rows,), dtype=torch.float32, device="meta")
    return q, scale, vecs, rs, 1000, kseg, 512


def _call(scan, which, **kw):
    if which.startswith("float"):
        dtype = torch.float32 if which == "float_f32" else torch.bfloat16
        return scan.block_topk_float(*_float_operands(dtype=dtype, **kw))
    if which == "adc_sorted":
        return scan.block_topk_adc_sorted(*_sorted_operands(**kw))
    if which.startswith("segmax"):
        dtype = {"segmax_f32": torch.float32, "segmax_bf16": torch.bfloat16,
                 "segmax_int8": torch.int8}[which]
        kw = {"kseg" if k == "kb" else k: v for k, v in kw.items()}
        fn = scan.block_topk_segmax_int8 if dtype == torch.int8 else scan.block_topk_segmax
        return fn(*_segmax_operands(dtype=dtype, **kw))
    return scan.block_topk_adc(*_adc_operands(residual=which == "adc_residual", **kw))


KERNEL_CALLS = {"float_f32": "scan_topk_f32", "float_bf16": "scan_topk_bf16",
                "adc_residual": "adc_scan_topk_residual", "adc_plain": "adc_scan_topk_plain",
                "adc_sorted": "adc_scan_topk_sorted", "segmax_f32": "segmax_scan_topk_f32",
                "segmax_bf16": "segmax_scan_topk_bf16", "segmax_int8": "segmax_scan_topk_int8"}


@pytest.mark.parametrize("which", sorted(KERNEL_CALLS))
@pytest.mark.parametrize("err", [1, 700])
def test_new_wrappers_raise_when_launch_fails(fake_kernels, monkeypatch, which, err):
    lib = _FakeKernels(err)
    monkeypatch.setattr(fake_kernels, "_load_kernel_lib", lambda source: lib)
    before = dict(fake_kernels.STATS.by_kernel)
    with pytest.raises(RuntimeError, match=f"CUDA error {err}"):
        _call(fake_kernels, which)
    assert [c[0] for c in lib.calls] == [KERNEL_CALLS[which] + "_launch"]
    assert fake_kernels.STATS.by_kernel == before  # a failed launch is not counted


@pytest.mark.parametrize("which", sorted(KERNEL_CALLS))
def test_new_wrappers_raise_without_a_card(fake_kernels, monkeypatch, which):
    """A CUDA request on a machine without nvcc or a card raises; no fallback."""
    def no_nvcc(source):
        raise RuntimeError(f"compiler for {source} not found")

    monkeypatch.setattr(fake_kernels, "_load_kernel_lib", no_nvcc)
    with pytest.raises(RuntimeError, match="not found"):
        _call(fake_kernels, which)


@pytest.mark.parametrize("which", sorted(KERNEL_CALLS))
def test_new_wrappers_count_a_launch(fake_kernels, monkeypatch, which):
    lib = _FakeKernels(0)
    monkeypatch.setattr(fake_kernels, "_load_kernel_lib", lambda source: lib)
    fake_kernels.STATS.reset()
    out_s, out_i = _call(fake_kernels, which, kb=3)
    assert fake_kernels.STATS.by_kernel == {KERNEL_CALLS[which]: 1}
    tile = (8 if which.startswith("adc") else
            fake_kernels.SEGMAX_QUERY_TILE if which.startswith("segmax") else 64)
    assert out_s.shape == (1, 2, 3, tile) and out_i.dtype == torch.int32


@pytest.mark.parametrize("bad", ["dtype", "rows", "kb", "block_size", "dim", "lut_width"])
@pytest.mark.parametrize("family", ["float", "adc"])
def test_new_wrappers_reject_what_the_kernels_do_not_take(fake_kernels, monkeypatch, family,
                                                          bad):
    monkeypatch.setattr(fake_kernels, "_load_kernel_lib", lambda source: _FakeKernels(0))
    args = list(_float_operands() if family == "float" else _adc_operands())
    if bad == "dtype":
        args[1] = args[1].to(torch.float16 if family == "float" else torch.int8)
    elif bad == "rows":
        args[1], args[2] = args[1][:700], args[2][:700]
    elif bad == "kb":
        args[3] = 33
    elif bad == "block_size":  # no rows a block (any positive block is taken)
        args[4] = 0
    elif bad == "dim":  # float: a bf16 D off TMA's 8; adc: codes not M+2 wide
        if family == "float":
            args[:3] = _float_operands(torch.bfloat16, d=100)[:3]
        else:
            args[1] = torch.empty((1024, 9), dtype=args[1].dtype, device="meta")
    else:  # float: queries not a whole tile; adc: more clusters than a code byte holds
        args[0] = (torch.empty((65, 64), device="meta") if family == "float" else
                   torch.empty((8, 8, 257), dtype=torch.bfloat16, device="meta"))
    fn = fake_kernels.block_topk_float if family == "float" else fake_kernels.block_topk_adc
    with pytest.raises(ValueError):
        fn(*args)


@pytest.mark.parametrize("block_size", [1, 128, 300, 384, 640, 1000])
@pytest.mark.parametrize("which", ["float_f32", "float_bf16", "adc_residual", "adc_plain",
                                   "adc_sorted"])
def test_float_and_adc_wrappers_launch_blocks_off_the_chunk(fake_kernels, monkeypatch, which,
                                                            block_size):
    """Kernels 2 to 5 take any block_size (they took whole 256-row chunks
    only until a block's last chunk was masked past its end, as kernel 1's):
    the launcher receives the block, and the partials have one entry per
    block."""
    lib = _FakeKernels(0)
    monkeypatch.setattr(fake_kernels, "_load_kernel_lib", lambda source: lib)
    fake_kernels.STATS.reset()
    rows = 4 * block_size
    if which.startswith("float"):
        dtype = torch.float32 if which == "float_f32" else torch.bfloat16
        args = list(_float_operands(dtype=dtype, rows=rows))
        fn, at = fake_kernels.block_topk_float, 7
    elif which == "adc_sorted":
        args = list(_sorted_operands(rows=rows, tiles=2))
        fn, at = fake_kernels.block_topk_adc_sorted, 9
    else:
        args = list(_adc_operands(residual=which == "adc_residual", rows=rows))
        fn, at = fake_kernels.block_topk_adc, 8
    args[4] = block_size
    out_s, _ = fn(*args)
    assert fake_kernels.STATS.by_kernel == {KERNEL_CALLS[which]: 1}
    assert out_s.shape[1] == 4
    assert lib.calls[0][1][at - 1:at + 1] == (4, block_size)


@pytest.mark.parametrize("bad", ["group", "wbase", "width", "rows", "kb", "dtype"])
def test_sorted_wrapper_rejects_what_the_kernel_does_not_take(fake_kernels, monkeypatch, bad):
    monkeypatch.setattr(fake_kernels, "_load_kernel_lib", lambda source: _FakeKernels(0))
    args = list(_sorted_operands())
    if bad == "group":  # two blocks do not split into tiles of 3
        args[8] = 3
    elif bad == "wbase":  # one base per tile of 2 blocks: 1, not 2
        args[7] = torch.empty((2,), dtype=torch.int32, device="meta")
    elif bad == "width":  # the table lacks its 256 zero columns' multiple
        args[5] = args[6] = torch.empty((8, 700), dtype=torch.bfloat16, device="meta")
    elif bad == "rows":
        args[1], args[2] = args[1][:700], args[2][:700]
    elif bad == "kb":
        args[3] = 0
    else:
        args[7] = torch.empty((1,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        fake_kernels.block_topk_adc_sorted(*args)


@pytest.mark.parametrize("bad", ["kseg", "block_size", "rows", "queries", "dtype"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_segmax_wrappers_reject_what_the_kernels_do_not_take(fake_kernels, monkeypatch, dtype,
                                                             bad):
    monkeypatch.setattr(fake_kernels, "_load_kernel_lib", lambda source: _FakeKernels(0))
    args = list(_segmax_operands(dtype=dtype))
    iv, ik, ib = (2, 5, 6) if dtype == torch.int8 else (1, 3, 4)
    if bad == "kseg":  # more picks than a block of 512 has segments
        args[ik] = 5
    elif bad == "block_size":  # not whole 128-row segments
        args[ib] = 320
    elif bad == "rows":  # the corpus is not whole blocks
        args[iv] = torch.empty((1000, 64), dtype=dtype, device="meta")
        if dtype == torch.int8:
            args[3] = torch.empty((1000,), device="meta")
    elif bad == "queries":
        args[0] = torch.empty((fake_kernels.SEGMAX_QUERY_TILE + 1, 64), dtype=dtype,
                              device="meta")
    else:
        args[iv] = args[iv].to(torch.float16)
    fn = fake_kernels.block_topk_segmax_int8 if dtype == torch.int8 else \
        fake_kernels.block_topk_segmax
    with pytest.raises(ValueError):
        fn(*args)


def test_segmax_bf16_wrapper_rejects_a_width_off_tma_s_multiple(fake_kernels, monkeypatch):
    """The one width refusal left: bf16 D off 8 (TMA's 16-byte row stride);
    ``scan_topk_segmax`` zero-pads a bf16 corpus to it, as ``scan_topk``."""
    monkeypatch.setattr(fake_kernels, "_load_kernel_lib", lambda source: _FakeKernels(0))
    q = torch.empty((fake_kernels.SEGMAX_QUERY_TILE, 100), dtype=torch.bfloat16, device="meta")
    vecs = torch.empty((1024, 100), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        fake_kernels.block_topk_segmax(q, vecs, 1000, 2, 512)


# the shapes the segment-max wrappers refused until kernels 6 and 7 took any
# D and any block of whole segments: (rows, D, block_size)
SEGMAX_ONCE_REFUSED = {"block_size": (1536, 64, 384), "big_block": (8192, 64, 8192),
                       "dim": (1024, 40, 512), "dim_100": (1024, 100, 512),
                       "dim_4104": (1024, 4104, 512), "block_16384": (16384, 64, 16384)}


@pytest.mark.parametrize("case", sorted(SEGMAX_ONCE_REFUSED))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["fp32", "bf16", "int8"])
def test_segmax_wrappers_launch_what_they_once_refused(fake_kernels, monkeypatch, dtype, case):
    """Each shape launches its kernel once (counted) with the arguments the C
    launcher takes; past 64 segments a block the winners get a device
    scratch of [CUDA blocks][segments][128] f32 + int32 (block 16,384, 128
    segments), below it none (0: shared memory)."""
    lib = _FakeKernels(0)
    monkeypatch.setattr(fake_kernels, "_load_kernel_lib", lambda source: lib)
    asked = []
    real = fake_kernels.scratch
    monkeypatch.setattr(fake_kernels, "scratch",
                        lambda dev, stream, name, numel, dtype, zero=False:
                        asked.append((name, numel)) or real(dev, stream, name, numel, dtype, zero))
    rows, d, block_size = SEGMAX_ONCE_REFUSED[case]
    if dtype == torch.bfloat16:
        d = -(-d // 8) * 8  # scan_topk_segmax's zero padding
    tile = fake_kernels.SEGMAX_QUERY_TILE
    q = torch.empty((2 * tile, d), dtype=dtype, device="meta")
    vecs = torch.empty((rows, d), dtype=dtype, device="meta")
    fake_kernels.STATS.reset()
    if dtype == torch.int8:
        out_s, _ = fake_kernels.block_topk_segmax_int8(
            q, torch.empty((2 * tile,), device="meta"), vecs, torch.empty((rows,), device="meta"),
            rows - 5, 3, block_size)
        kernel = "segmax_scan_topk_int8"
    else:
        out_s, _ = fake_kernels.block_topk_segmax(q, vecs, rows - 5, 3, block_size)
        kernel = "segmax_scan_topk_f32" if dtype == torch.float32 else "segmax_scan_topk_bf16"
    nblocks = rows // block_size
    assert fake_kernels.STATS.by_kernel == {kernel: 1}
    assert out_s.shape == (2, nblocks, 3, tile)
    name, args = lib.calls[0]
    assert name == kernel + "_launch"
    assert args[7:13] == (2, nblocks, block_size, d, 3, rows - 5)
    nseg = block_size // 128
    if nseg > fake_kernels.MAX_SMEM_SEGMENTS:
        assert asked == [("segmax_segments", nblocks * nseg * 256)]  # one CUDA block: 2 tiles
    else:
        assert asked == [] and args[6] == 0


def _c_functions(source: str) -> dict:
    """{function: (its return type, its parameters as "P" (pointer), "I"
    (int), "F" (float))} from the ``extern "C"`` functions of a CUDA source."""
    import re

    text = (REPO / "crs_tpu_torch" / "csrc" / source).read_text()
    text = text[text.index('extern "C"'):]
    kinds = {}
    for ret, name, params in re.findall(r'(?:^|extern "C" )(int|long long)\s+(\w+)\s*\(([^)]*)\)',
                                        text, re.MULTILINE):
        kinds[name] = (ret, ["P" if "*" in p or "cudaStream_t" in p else "F" if "float" in p
                             else "I" for p in params.split(",") if p.strip()])
    return kinds


def _c_launchers(source: str) -> dict:
    """{launcher: its parameters} of a CUDA source's ``*_launch`` functions."""
    return {name: params for name, (_, params) in _c_functions(source).items()
            if name.endswith("_launch")}


def test_scan_launcher_types_match_the_c_signatures():
    """A launcher typed with a wrong argument list reads the stream from the
    wrong slot and crashes on the card; hold every scan kernel's ctypes
    types against its C signature."""
    import ctypes

    from crs_tpu_torch.ops import scan

    kind = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F"}
    for kernel, (source, argtypes) in scan._KERNELS.items():
        assert [kind[t] for t in argtypes] == _c_launchers(source)[f"{kernel}_launch"], kernel


def test_build_lists_every_kernel_source():
    from crs_tpu_torch import _build

    assert set(_build.CUDA_SOURCES) == {"int8_scan_topk.cu", "scan_topk_f32_bf16.cu",
                                        "pq_adc_scan_topk.cu", "segmax_scan_topk.cu",
                                        "q4_matmul.cu", "decode_attention_int8.cu",
                                        "fused_mlp_int8.cu", "gemv_probe.cu"}
    on_disk = {p.name for p in (REPO / "crs_tpu_torch" / "csrc").glob("*.cu")}
    assert on_disk == set(_build.CUDA_SOURCES)
    cmd = _build.compile_command("x.cu", "libx.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    with pytest.raises(ValueError):
        _build.build_cuda("not_a_kernel.cu")


# -- the generator's kernels: q4 / NF4 matmul and int8 decode attention -------

def _q4_operands(nf4=False, r=8, k=512, n=256, device="meta"):
    x = torch.empty((r, k), dtype=torch.bfloat16, device=device)
    codes = torch.empty((k // 2, n), dtype=torch.uint8 if nf4 else torch.int8, device=device)
    scales = torch.empty((k // 128, n), dtype=torch.float32, device=device)
    return x, codes, scales


def _attn_operands(b=2, hkv=2, g=2, s=256, hd=128, device="meta"):
    return (torch.empty((b, hkv, g, hd), dtype=torch.float32, device=device),
            torch.empty((b, hkv, s, hd), dtype=torch.int8, device=device),
            torch.empty((b, hkv, s), dtype=torch.float32, device=device),
            torch.empty((b, hkv, s, hd), dtype=torch.int8, device=device),
            torch.empty((b, hkv, s), dtype=torch.float32, device=device),
            torch.empty((b, s), dtype=torch.bool, device=device))


@pytest.fixture
def fake_generator_kernels(monkeypatch):
    """Non-CPU tensors reach the kernels; the plain versions must not run."""
    from crs_tpu_torch.ops import decode_attention, launch, qgemm

    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("the wrapper fell back to the plain version")

    for mod, name in ((qgemm, "emulate_q4_matmul"), (qgemm, "emulate_nf4_matmul"),
                      (decode_attention, "emulate_decode_attention_int8")):
        monkeypatch.setattr(mod, name, plain_must_not_run)
    for mod in (qgemm, decode_attention):
        monkeypatch.setattr(mod, "stream_handle", lambda device: 0)
        monkeypatch.setattr(mod, "sm_count", lambda dev: 132)
    return qgemm, decode_attention, launch


GEN_CALLS = {"q4_matmul": "q4_mma_launch", "nf4_matmul": "q4_mma_launch",
             "decode_attention_int8": "decode_attention_int8_launch"}


def test_generator_launcher_types_match_the_c_signatures(monkeypatch):
    """The generator kernels' ctypes types against their C signatures."""
    import ctypes

    from crs_tpu_torch.ops import decode_attention, fused_mlp, qgemm

    kind = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F"}
    returns = {ctypes.c_int: "int", ctypes.c_longlong: "long long"}
    seen = {}
    for mod in (qgemm, decode_attention, fused_mlp):
        monkeypatch.setattr(mod, "load_library", lambda source, launchers, restypes=None:
                            seen.setdefault(source, (launchers, restypes or {})))
        mod._load()
    assert set(seen) == {"q4_matmul.cu", "decode_attention_int8.cu", "fused_mlp_int8.cu"}
    for source, (launchers, restypes) in seen.items():
        c_side = _c_functions(source)
        assert set(launchers) <= set(c_side), source
        for name, argtypes in launchers.items():
            ret, params = c_side[name]
            assert [kind[t] for t in argtypes] == params, name
            assert returns[restypes.get(name, ctypes.c_int)] == ret, name


def _gen_call(mods, which, **kw):
    qgemm, attn, _ = mods
    if which == "decode_attention_int8":
        return attn.decode_attention_int8(*_attn_operands(**kw))
    nf4 = which == "nf4_matmul"
    return getattr(qgemm, which)(*_q4_operands(nf4=nf4, **kw))


def _patch_lib(mods, monkeypatch, lib):
    qgemm, attn, _ = mods
    for mod in (qgemm, attn):
        monkeypatch.setattr(mod, "load_library", lambda source, launchers: lib)


@pytest.mark.parametrize("which", sorted(GEN_CALLS))
@pytest.mark.parametrize("err", [1, 700])
def test_generator_wrappers_raise_when_launch_fails(fake_generator_kernels, monkeypatch, which,
                                                    err):
    lib = _FakeKernels(err)
    _patch_lib(fake_generator_kernels, monkeypatch, lib)
    stats = (fake_generator_kernels[1] if which.startswith("decode")
             else fake_generator_kernels[0]).STATS
    before = dict(stats.by_kernel)
    with pytest.raises(RuntimeError, match=f"CUDA error {err}"):
        _gen_call(fake_generator_kernels, which)
    assert [c[0] for c in lib.calls] == [GEN_CALLS[which]]
    assert stats.by_kernel == before  # a failed launch is not counted


@pytest.mark.parametrize("which", sorted(GEN_CALLS))
def test_generator_wrappers_raise_without_a_card(fake_generator_kernels, monkeypatch, which):
    def no_nvcc(source, launchers):
        raise RuntimeError(f"compiler for {source} not found")

    for mod in fake_generator_kernels[:2]:
        monkeypatch.setattr(mod, "load_library", no_nvcc)
    with pytest.raises(RuntimeError, match="not found"):
        _gen_call(fake_generator_kernels, which)


@pytest.mark.parametrize("which", sorted(GEN_CALLS))
def test_generator_wrappers_count_a_launch(fake_generator_kernels, monkeypatch, which):
    lib = _FakeKernels(0)
    _patch_lib(fake_generator_kernels, monkeypatch, lib)
    qgemm, attn, _ = fake_generator_kernels
    qgemm.STATS.reset()
    attn.STATS.reset()
    out = _gen_call(fake_generator_kernels, which)
    stats = attn.STATS if which.startswith("decode") else qgemm.STATS
    assert stats.by_kernel == {which: 1} and stats.launches == 1
    assert out.dtype == torch.float32
    args = lib.calls[0][1]
    if which == "decode_attention_int8":
        assert out.shape == (2, 2, 2, 128)
        bh, hkv, g, s, rows, nchunk = args[11:17]
        assert (bh, hkv, g, s) == (4, 2, 2, 256)
        assert (rows, nchunk) == attn.split_plan(4, 256, 132) and rows * nchunk >= s
    else:  # int4 and NF4: one kernel and plan, each kind's own table
        assert out.shape == (8, 256)
        r, k2, n, gs2, split, slice_rows, width, warps_n = args[5:13]
        assert (r, k2, n, gs2) == (8, 256, 256, 64)
        plan = qgemm.nf4_plan(8, 256, 256, 64, 132)
        assert (split, slice_rows, width, warps_n) == (plan.ksplit, plan.slice_rows, plan.width,
                                                       plan.warps_n)
        kind = "nf4" if which == "nf4_matmul" else "int4"
        assert (torch.device("meta"), kind) in qgemm._tables  # the kind's own table


@pytest.mark.parametrize("bad", ["dtype", "shape", "rows", "width", "contiguous"])
@pytest.mark.parametrize("which", ["q4_matmul", "nf4_matmul"])
def test_q4_wrappers_reject_what_the_kernel_does_not_take(fake_generator_kernels, monkeypatch,
                                                          which, bad):
    _patch_lib(fake_generator_kernels, monkeypatch, _FakeKernels(0))
    nf4 = which == "nf4_matmul"
    x, codes, scales = _q4_operands(nf4=nf4)
    if bad == "dtype":  # int4 codes are int8, NF4 codes uint8
        codes = codes.view(torch.int8 if nf4 else torch.uint8)
    elif bad == "shape":
        scales = scales[:, :128]
    elif bad == "rows":  # past the decode-sized rows
        x = torch.empty((65, 512), dtype=torch.bfloat16, device="meta")
    elif bad == "width":  # N not a multiple of 128
        codes, scales = codes[:, :200], scales[:, :200]
    else:
        codes = torch.empty((256, 256), dtype=codes.dtype, device="meta").T
    with pytest.raises(ValueError):
        getattr(fake_generator_kernels[0], which)(x, codes, scales)


@pytest.mark.parametrize("which", ["q4_matmul", "nf4_matmul"])
def test_nf4_wrapper_rejects_groups_off_the_kernels_step(fake_generator_kernels, monkeypatch,
                                                         which):
    """Groups off the kernel's 16-row k step launch (since the kernel reads
    each packed row's own scale): groups of 8 and 24 rows (4 and 12 packed
    rows, a step across two groups and a group across two steps) and of 2,
    each with a plan of whole groups and whole steps; 16 as before."""
    lib = _FakeKernels(0)
    _patch_lib(fake_generator_kernels, monkeypatch, lib)
    qgemm = fake_generator_kernels[0]
    nf4 = which == "nf4_matmul"
    for k, group in ((512, 8), (768, 24), (512, 2), (512, 16)):
        x, codes, _ = _q4_operands(nf4=nf4, k=k)
        getattr(qgemm, which)(x, codes, torch.empty((k // group, 256), device="meta"))
        gs2, split, slice_rows = lib.calls[-1][1][8:11]
        assert gs2 == group // 2 and slice_rows % gs2 == 0 and slice_rows % 8 == 0
        assert (split - 1) * slice_rows < k // 2 <= split * slice_rows
    assert [c[0] for c in lib.calls] == ["q4_mma_launch"] * 4


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "group", "seq", "shape", "contiguous"])
def test_decode_attention_wrapper_rejects_what_the_kernel_does_not_take(
        fake_generator_kernels, monkeypatch, bad):
    _patch_lib(fake_generator_kernels, monkeypatch, _FakeKernels(0))
    ops = list(_attn_operands())
    if bad == "dtype":
        ops[1] = ops[1].float()
    elif bad == "head_dim":
        ops = list(_attn_operands(hd=64))
    elif bad == "group":  # no query head (any positive count is taken)
        ops = list(_attn_operands(g=0))
    elif bad == "seq":
        ops = list(_attn_operands(s=200))
    elif bad == "shape":
        ops[5] = torch.empty((2, 128), dtype=torch.bool, device="meta")
    else:
        ops[3] = torch.empty((2, 2, 128, 256), dtype=torch.int8, device="meta").transpose(2, 3)
    with pytest.raises(ValueError):
        fake_generator_kernels[1].decode_attention_int8(*ops)


# -- kernel 11: the fused MLP -------------------------------------------------------

def _mlp_operands(b=8, h=256, inter=512, chunk=128, device="meta"):
    return (torch.empty((b, h), dtype=torch.float32, device=device),
            torch.empty((h,), dtype=torch.float32, device=device),
            torch.empty((inter, h), dtype=torch.int8, device=device),
            torch.empty((inter // chunk, chunk), dtype=torch.float32, device=device),
            torch.empty((inter, h), dtype=torch.int8, device=device),
            torch.empty((inter // chunk, chunk), dtype=torch.float32, device=device),
            torch.empty((inter, h), dtype=torch.int8, device=device),
            torch.empty((h,), dtype=torch.float32, device=device))


@pytest.fixture
def fake_mlp_kernel(monkeypatch):
    """Non-CPU tensors reach the kernel; the plain version must not run."""
    from crs_tpu_torch.ops import fused_mlp

    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("the wrapper fell back to the plain version")

    monkeypatch.setattr(fused_mlp, "emulate_fused_mlp_int8", plain_must_not_run)
    monkeypatch.setattr(fused_mlp, "stream_handle", lambda device: 0)
    return fused_mlp


@pytest.mark.parametrize("err", [1, 700])
def test_fused_mlp_wrapper_raises_when_launch_fails(fake_mlp_kernel, monkeypatch, err):
    lib = _FakeKernels(err)
    monkeypatch.setattr(fake_mlp_kernel, "load_library",
                        lambda source, launchers, restypes=None: lib)
    before = dict(fake_mlp_kernel.STATS.by_kernel)
    with pytest.raises(RuntimeError, match=f"CUDA error {err}"):
        fake_mlp_kernel.fused_mlp_int8(*_mlp_operands(), chunk=128)
    assert [c[0] for c in lib.calls] == ["fused_mlp_int8_launch"]
    assert fake_mlp_kernel.STATS.by_kernel == before  # a failed launch is not counted


def test_fused_mlp_wrapper_raises_without_a_card(fake_mlp_kernel, monkeypatch):
    def no_nvcc(source, launchers, restypes=None):
        raise RuntimeError(f"compiler for {source} not found")

    monkeypatch.setattr(fake_mlp_kernel, "load_library", no_nvcc)
    with pytest.raises(RuntimeError, match="not found"):
        fake_mlp_kernel.fused_mlp_int8(*_mlp_operands(), chunk=128)


@pytest.mark.parametrize("chunk", [128, 256])
def test_fused_mlp_wrapper_counts_a_launch(fake_mlp_kernel, monkeypatch, chunk):
    lib = _FakeKernels(0)
    monkeypatch.setattr(fake_mlp_kernel, "load_library",
                        lambda source, launchers, restypes=None: lib)
    fake_mlp_kernel.STATS.reset()
    out, codes = fake_mlp_kernel.fused_mlp_int8(*_mlp_operands(b=3, chunk=chunk), chunk=chunk,
                                                return_codes=True)
    assert fake_mlp_kernel.STATS.by_kernel == {"fused_mlp_int8": 1}
    assert out.shape == (3, 256) and out.dtype == torch.float32
    assert codes.hq.shape == (3, 512) and codes.hs.shape == (3, 512 // chunk)
    args = lib.calls[0][1]
    assert args[15:19] == (3, 256, 512, chunk)
    assert all(p is not None for p in args[11:15])  # the codes' buffers


@pytest.mark.parametrize("b", range(1, 9))
def test_fused_mlp_is_one_launch_on_what_the_kernel_reads(fake_mlp_kernel, monkeypatch, b):
    """One launch a call at every row count: the operands, the chunks' terms
    of y ([chunks, B, H] f32) and the 8 ranks' counters (zeroed once) are all
    it is given; the codes' buffers only with ``return_codes``."""
    lib = _FakeKernels(0)
    monkeypatch.setattr(fake_mlp_kernel, "load_library",
                        lambda source, launchers, restypes=None: lib)
    asked = []
    real = fake_mlp_kernel.scratch
    monkeypatch.setattr(fake_mlp_kernel, "scratch",
                        lambda dev, stream, name, numel, dtype, zero=False:
                        asked.append((name, numel, dtype, zero))
                        or real(dev, stream, name, numel, dtype, zero))
    h, inter, chunk = 256, 512, 128
    fake_mlp_kernel.STATS.reset()
    out = fake_mlp_kernel.fused_mlp_int8(*_mlp_operands(b=b, h=h, inter=inter, chunk=chunk),
                                         chunk=chunk)
    assert out.shape == (b, h)
    assert fake_mlp_kernel.STATS.by_kernel == {"fused_mlp_int8": 1}
    assert [c[0] for c in lib.calls] == ["fused_mlp_int8_launch"]
    args = lib.calls[0][1]
    assert len(args) == 21 and args[15:19] == (b, h, inter, chunk)
    assert args[11:15] == (None,) * 4  # no codes asked for: none written
    assert asked == [("mlp_part", inter // chunk * b * h, torch.float32, False),
                     ("mlp_counters", fake_mlp_kernel.CLUSTER, torch.int32, True)]


@pytest.mark.parametrize("h", [4096, 16384, 27136, 28672, 32768])
@pytest.mark.parametrize("b", [1, 8])
def test_fused_mlp_launches_every_gated_width(fake_mlp_kernel, monkeypatch, h, b):
    """Every H % 128 that ``fused_mlp_supported`` admits reaches the one
    launch, past H 27,136 too, where the kernel keeps xq's rows in the first
    B·H bytes of the chunk's [B, H] f32 slab of the terms' buffer instead of
    shared memory (``chip_smoke.py``'s faults phase runs those widths on the
    card)."""
    from crs_tpu_torch.ops.fused_mlp import fused_mlp_supported

    lib = _FakeKernels(0)
    monkeypatch.setattr(fake_mlp_kernel, "load_library",
                        lambda source, launchers, restypes=None: lib)
    asked = {}
    real = fake_mlp_kernel.scratch
    monkeypatch.setattr(fake_mlp_kernel, "scratch",
                        lambda dev, stream, name, numel, dtype, zero=False:
                        asked.setdefault(name, (numel, dtype))
                        and real(dev, stream, name, numel, dtype, zero))
    inter, chunk = 2048, 1024
    assert fused_mlp_supported(b, h, inter, chunk)
    out = fake_mlp_kernel.fused_mlp_int8(*_mlp_operands(b=b, h=h, inter=inter, chunk=chunk),
                                         chunk=chunk)
    assert out.shape == (b, h)
    assert [c[0] for c in lib.calls] == ["fused_mlp_int8_launch"]
    assert lib.calls[0][1][15:19] == (b, h, inter, chunk)
    numel, dtype = asked["mlp_part"]
    assert dtype == torch.float32 and numel == inter // chunk * b * h  # a slab of B·H f32 a chunk


@pytest.mark.parametrize("chunk", [32, 40, 64, 96, 24576])
@pytest.mark.parametrize("b", [1, 8])
def test_fused_mlp_launches_every_gated_chunk(fake_mlp_kernel, monkeypatch, chunk, b):
    """Every chunk that ``fused_mlp_supported`` admits reaches the one
    launch (the kernel once took multiples of 128 up to 16,384 only): off
    128 a CTA's last tile runs past the chunk and is masked; past what
    shared memory holds (24,576 rows at H 128) the kernel keeps each chunk's
    hq [B][8·rows] int8 and hmid [B][8·rows] f32 in a slab of ``part`` after
    the terms, rows = ⌈chunk / 8⌉ in whole 16-row tiles (``chip_smoke.py``'s
    faults phase runs chunks 64, 96 and 24,576 on the card)."""
    from crs_tpu_torch.ops.fused_mlp import fused_mlp_supported

    lib = _FakeKernels(0)
    monkeypatch.setattr(fake_mlp_kernel, "load_library",
                        lambda source, launchers, restypes=None: lib)
    asked = {}
    real = fake_mlp_kernel.scratch
    monkeypatch.setattr(fake_mlp_kernel, "scratch",
                        lambda dev, stream, name, numel, dtype, zero=False:
                        asked.setdefault(name, (numel, dtype))
                        and real(dev, stream, name, numel, dtype, zero))
    h, inter = 128, 2 * chunk
    assert fused_mlp_supported(b, h, inter, chunk)
    fake_mlp_kernel.STATS.reset()
    out = fake_mlp_kernel.fused_mlp_int8(*_mlp_operands(b=b, h=h, inter=inter, chunk=chunk),
                                         chunk=chunk)
    assert out.shape == (b, h)
    assert fake_mlp_kernel.STATS.by_kernel == {"fused_mlp_int8": 1}
    assert [c[0] for c in lib.calls] == ["fused_mlp_int8_launch"]
    assert lib.calls[0][1][15:19] == (b, h, inter, chunk)
    rows = (-(-chunk // 8) + 15) // 16 * 16
    slab = 5 * b * 8 * rows // 4 if chunk > 16384 else 0
    assert asked["mlp_part"] == (2 * (b * h + slab), torch.float32)


@pytest.mark.parametrize("bad", ["dtype", "rows", "hidden", "chunk", "shape", "contiguous"])
def test_fused_mlp_wrapper_rejects_what_the_kernel_does_not_take(fake_mlp_kernel, monkeypatch,
                                                                 bad):
    monkeypatch.setattr(fake_mlp_kernel, "load_library",
                        lambda source, launchers, restypes=None: _FakeKernels(0))
    ops = list(_mlp_operands())
    chunk = 128
    if bad == "dtype":
        ops[2] = ops[2].view(torch.uint8)
    elif bad == "rows":  # past the decode-sized rows
        ops[0] = torch.empty((9, 256), dtype=torch.float32, device="meta")
    elif bad == "hidden":  # H not a multiple of 128
        ops = list(_mlp_operands(h=200))
    elif bad == "chunk":  # I not a multiple of the chunk
        chunk = 384
    elif bad == "shape":
        ops[7] = torch.empty((128,), dtype=torch.float32, device="meta")
    else:
        ops[6] = torch.empty((256, 512), dtype=torch.int8, device="meta").T
    with pytest.raises(ValueError):
        fake_mlp_kernel.fused_mlp_int8(*ops, chunk=chunk)
