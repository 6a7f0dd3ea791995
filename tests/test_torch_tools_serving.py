"""The port's serving tools and quickstart (``crs_tpu_torch/examples/quickstart.py``,
``crs_tpu_torch/tools/bench_decode.py``, ``bench_prefill_mfu.py``,
``bench_fused_mlp.py``) against the JAX scripts ``examples/quickstart.py``,
``tools/bench_decode.py``, ``tools/bench_prefill_mfu.py`` and
``tools/bench_fused_mlp.py``.

The JAX tools are imported by path and run as they are; the fused-MLP
tool's two steps are closures inside its ``main()``, so they are restated
here from ``tools/bench_fused_mlp.py:49-87`` with ``crs_tpu``'s own
functions (its Pallas kernel in interpret mode), and chained once as its
jitted ``lax.scan`` chains them. The JAX generates and the JAX prefill tool
run in a child process of their own (``JAX_SIDE``): after a ``crs_tpu``
int4 forward (its Pallas q4 kernel in interpret mode), XLA refuses the
second call of some jitted programs in the same process ("Execution
supplied 4 buffers but compiled program expected 5"), and the test workers
run several files in one process. Each script also runs once as a child
process with ``--device cpu``, and each raises without CUDA unless the CPU
was asked for.

Tolerances:
- ``build_random_quant_params``: bit for bit (the same numpy stream);
- bench_decode's greedy tokens at ``tiny``: equal;
- bench_prefill_mfu: the same JSON keys, batch and length, and the same
  FLOPs a token and peak (relative 1e-9: ratios of host-clock numbers);
- the fused-MLP draw: bit for bit; the chains (H 256, I 1,024, chunk 256, L
  2, one repetition): |port − JAX| ≤ 1e-5·max|JAX|, as
  ``tests/test_torch_fused_mlp.py`` holds one block. The int8 products are
  exact in both; XLA's f32 ``exp``, ``rsqrt`` and sums differ from torch's
  in the last ulps (observed ≤ 1.2e-7 relative); an activation code moved
  by one step would show as ~1e-3;
- the quickstart child: the chunk count of ``crs_tpu``'s text layer on the
  same PDF and config, equal.
"""

import dataclasses
import importlib
import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = pathlib.Path(__file__).resolve().parent.parent
CHAIN = {"h": 256, "inter": 1024, "layers": 2, "b": 1, "chunk": 256}
CHAIN_RTOL = 1e-5
RATIO_RTOL = 1e-9
DECODE_CASES = [(4, 8, False), (8, 16, True)]  # (bits, kv_bits, fuse)
PREFILL_ARGS = ["--config", "tiny", "--type", "int8", "--batch", "2", "--seq", "32",
                "--runs", "1"]
QUICKSTART_TOKENS = 8  # the child's rag.generation.max_new_tokens (256 by default)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _load_jax_script(path: str):
    """A JAX script of ``tools/`` or ``examples/`` as a module."""
    spec = importlib.util.spec_from_file_location(f"_jax_{pathlib.Path(path).stem}", REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jd():
    return _load_jax_script("tools/bench_decode.py")


# the JAX side that runs jitted programs more than once: greedy generates
# through tools/bench_decode.py's params, and tools/bench_prefill_mfu.py's main
JAX_SIDE = """
import contextlib, dataclasses, importlib.util, io, json, sys
import numpy as np
import jax, jax.numpy as jnp
cases, prefill_args, pdf = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]

def load(path):
    spec = importlib.util.spec_from_file_location(path.replace("/", "_")[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

jd = load("tools/bench_decode.py")
from crs_tpu.models import sampling as S
from crs_tpu.models.transformer import CONFIGS, fuse_qkv_params
out = {"greedy": {}}
for bits, kv_bits, fuse in cases:
    cfg = dataclasses.replace(CONFIGS["tiny"], kv_bits=kv_bits)
    params = jd.build_random_quant_params(cfg, bits)
    if fuse:
        params = fuse_qkv_params(params)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    toks, _ = S.generate_tokens(params, cfg, jnp.asarray(ids, jnp.int32),
                                jnp.ones(ids.shape, jnp.bool_), jax.random.PRNGKey(0),
                                S.SamplingParams(max_new_tokens=8, temperature=0.0, eos_id=-1))
    out["greedy"][f"{bits}-{kv_bits}-{fuse}"] = np.asarray(toks).tolist()
jp = load("tools/bench_prefill_mfu.py")
sys.argv = ["bench_prefill_mfu.py", *prefill_args]
with contextlib.redirect_stdout(io.StringIO()) as buf:
    jp.main()
out["prefill"] = json.loads(buf.getvalue().strip().splitlines()[-1])
# the chunks crs_tpu's pipeline makes of the PDF with the quickstart's config (the
# hashed embedding: the count does not depend on it)
from crs_tpu import ConfigLoader, RAGPipeline
cfg = ConfigLoader()
cfg.update_config("rag.chunking.chunk_size", 160)
cfg.update_config("rag.vector_store.format", "int8")
cfg.update_config("rag.embedding.backend", "hashed")
pipe = RAGPipeline(cfg.get_rag_config()).setup(None)
pipe.index_documents(pdf)
out["chunks"] = pipe.store.n
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def pdf(tmp_path_factory):
    path = tmp_path_factory.mktemp("quickstart") / "doc.pdf"
    _text_pdf(path, PAGES)
    return path


@pytest.fixture(autouse=True, scope="module")
def _jax_side_proc(pdf):
    """The JAX side's child, started with the file's first test."""
    proc = subprocess.Popen([sys.executable, "-c", JAX_SIDE, json.dumps(DECODE_CASES),
                             json.dumps(PREFILL_ARGS), str(pdf)], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(REPO)))
    yield proc
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_side(_jax_side_proc):
    out, err = _jax_side_proc.communicate(timeout=300)
    assert _jax_side_proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1])


# -- bench_decode ---------------------------------------------------------------------------

def _leaves(tree, path=""):
    """(path, leaf) pairs of a params tree, QuantizedTensors as their fields."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif hasattr(tree, "codes"):
        for f in ("codes", "scales", "bits", "group_size", "shape"):
            yield f"{path}.{f}", getattr(tree, f)
    else:
        yield path, tree


def _bits(a):
    """An array's bytes as integers (bf16 held as its bits)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("bits", [4, 8])
def test_random_quant_params_equal_bit_for_bit(jd, bits):
    from crs_tpu.models.transformer import CONFIGS as JAX_CONFIGS
    from crs_tpu_torch.models.transformer import CONFIGS
    from crs_tpu_torch.tools import bench_decode as bd

    want = list(_leaves(jd.build_random_quant_params(JAX_CONFIGS["tiny"], bits)))
    got = list(_leaves(bd.build_random_quant_params(CONFIGS["tiny"], bits)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        if isinstance(w, (int, str, tuple)):
            assert g == w, path
        else:
            gb, wb = _bits(g), _bits(w)
            assert gb.dtype == wb.dtype and gb.shape == wb.shape, path
            np.testing.assert_array_equal(gb, wb, err_msg=path)


@pytest.mark.parametrize("bits,kv_bits,fuse", DECODE_CASES)
def test_decode_greedy_tokens_equal_crs_tpu(jax_side, bits, kv_bits, fuse):
    from crs_tpu_torch.models.sampling import SamplingParams, generate_tokens
    from crs_tpu_torch.models.transformer import CONFIGS, fuse_qkv_params
    from crs_tpu_torch.tools import bench_decode as bd

    cfg = dataclasses.replace(CONFIGS["tiny"], kv_bits=kv_bits)
    params = bd.build_random_quant_params(cfg, bits)
    if fuse:
        params = fuse_qkv_params(params)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    got, _ = generate_tokens(params, cfg, torch.from_numpy(ids),
                             torch.ones(ids.shape, dtype=torch.bool),
                             torch.Generator().manual_seed(0),
                             SamplingParams(max_new_tokens=8, temperature=0.0, eos_id=-1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_side["greedy"][
        f"{bits}-{kv_bits}-{fuse}"]))


# -- bench_prefill_mfu ----------------------------------------------------------------------

def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_prefill_mfu_matches_the_jax_tool(jax_side, capsys):
    from crs_tpu_torch.tools import bench_prefill_mfu as bp

    want = jax_side["prefill"]
    assert bp.main(["--device", "cpu", *PREFILL_ARGS]) == 0
    got = _last_json(capsys.readouterr().out)
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    for key in ("prefill_batch", "prefill_seq_len", "config", "type"):
        assert got[key] == want[key], key

    def ratio(out, num, den):
        return out[num] / out[den]

    for num, den in (("prefill_tflops_achieved", "prefill_tokens_per_sec"),  # FLOPs a token
                     ("prefill_mfu_percent", "prefill_tflops_achieved")):  # 100 / peak
        assert ratio(got, num, den) == pytest.approx(ratio(want, num, den), rel=RATIO_RTOL)


# -- bench_fused_mlp ------------------------------------------------------------------------

def _jax_chains():
    """``tools/bench_fused_mlp.py``'s draw and its two steps, one repetition
    of the chain each, jitted as the tool jits it: (the numpy draw, {step: x})."""
    from crs_tpu.models.quantized import _int8_act_matmul
    from crs_tpu.ops.fused_mlp import fused_mlp_int8

    h, inter, L, chunk = CHAIN["h"], CHAIN["inter"], CHAIN["layers"], CHAIN["chunk"]
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal((CHAIN["b"], h))
    x0 = jnp.asarray(x_np, jnp.float32) * 0.3
    nchunks = inter // chunk

    def qw(k, n):
        codes = rng.integers(-127, 128, (L, k, n), dtype=np.int8)
        scales = np.full((L, n), 1e-2 / k ** 0.5, np.float32)
        return codes, scales

    gate_c, gate_s = qw(h, inter)
    up_c, up_s = qw(h, inter)
    down_c, down_s = qw(inter, h)
    norm = np.ones((L, h), np.float32)
    ws_xla = {"gate_c": gate_c, "gate_s": gate_s, "up_c": up_c, "up_s": up_s,
              "down_c": down_c, "down_s": down_s, "norm": norm}
    ws_fused = {"gate_t": gate_c.transpose(0, 2, 1).copy(),
                "gate_s2": gate_s.reshape(L, nchunks, chunk),
                "up_t": up_c.transpose(0, 2, 1).copy(), "up_s2": up_s.reshape(L, nchunks, chunk),
                "down_c": down_c, "down_s": down_s, "norm": norm}

    def step_xla(x, w):
        xn = x * jax.lax.rsqrt(jnp.mean(jnp.square(x), axis=1, keepdims=True) + 1e-5)
        xn = xn * w["norm"][None, :]
        g = _int8_act_matmul(xn, w["gate_c"], w["gate_s"])
        u = _int8_act_matmul(xn, w["up_c"], w["up_s"])
        return x + _int8_act_matmul(jax.nn.silu(g) * u, w["down_c"], w["down_s"])

    def step_fused(x, w):
        return fused_mlp_int8(x, w["norm"], w["gate_t"], w["gate_s2"], w["up_t"], w["up_s2"],
                              w["down_c"], w["down_s"], chunk=chunk)

    def chained(step, ws):
        @jax.jit
        def f(x, ws):
            def layer(xc, w):
                return step(xc, w), None

            x, _ = jax.lax.scan(layer, x, ws)
            return x * jax.lax.rsqrt(jnp.mean(jnp.square(x)) + 1e-6)

        return np.asarray(f(x0, {k: jnp.asarray(v) for k, v in ws.items()}))

    draw = {"x0": np.asarray(x0), **{f"xla.{k}": v for k, v in ws_xla.items()},
            **{f"fused.{k}": v for k, v in ws_fused.items()}}
    return draw, {"xla_int8": chained(step_xla, ws_xla), "fused": chained(step_fused, ws_fused)}


@pytest.fixture(scope="module")
def jax_chains():
    return _jax_chains()


def test_fused_mlp_draw_equals_the_jax_tool(jax_chains):
    from crs_tpu_torch.tools import bench_fused_mlp as bfm

    x0, ws_xla, ws_fused = bfm.draw_weights(CHAIN["h"], CHAIN["inter"], CHAIN["layers"],
                                            CHAIN["b"], CHAIN["chunk"], torch.device("cpu"))
    got = {"x0": x0, **{f"xla.{k}": v for k, v in ws_xla.items()},
           **{f"fused.{k}": v for k, v in ws_fused.items()}}
    want = jax_chains[0]
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("step", ["xla_int8", "fused"])
def test_fused_mlp_chain_matches_the_jax_chain(jax_chains, step):
    from crs_tpu_torch.tools import bench_chain_gemv as bcg
    from crs_tpu_torch.tools import bench_fused_mlp as bfm

    x0, ws_xla, ws_fused = bfm.draw_weights(CHAIN["h"], CHAIN["inter"], CHAIN["layers"],
                                            CHAIN["b"], CHAIN["chunk"], torch.device("cpu"))
    fn, ws = ((bfm.step_xla, ws_xla) if step == "xla_int8"
              else (bfm.fused_step(CHAIN["chunk"]), ws_fused))
    layers = [{k: v[i] for k, v in ws.items()} for i in range(CHAIN["layers"])]
    got = bcg.chain(fn, layers, x0, 1).numpy()
    want = jax_chains[1][step]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= CHAIN_RTOL * np.abs(want).max()


def test_a_failed_fused_mlp_step_exits_non_zero(monkeypatch, capsys):
    from crs_tpu_torch.tools import bench_fused_mlp as bfm

    def failing(chunk):
        def step(x, w):
            raise RuntimeError("the kernel refused")

        return step

    monkeypatch.setattr(bfm, "fused_step", failing)
    args = ["--h", "256", "--inter", "1024", "--chunk", "256", "--layers", "2", "--reps", "1"]
    assert bfm.main(["--device", "cpu", *args]) == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("fused") and "FAILED RuntimeError" in line for line in out)
    assert set(json.loads(out[-1])) == {"device", "xla_int8"}  # the other step still reported


# -- the scripts as children ----------------------------------------------------------------

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


PAGES = [" ".join(f"Quantization step {p}.{i} keeps the recall of the compressed index high "
                  f"while the weights shrink to {4 + i % 5} bits." for i in range(4))
         for p in range(2)]


def _child(code: str, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _tool_child(module: str, *args):
    return _child(f"import sys; from crs_tpu_torch.tools.{module} import main; "
                  "sys.exit(main(sys.argv[1:]))", "--device", "cpu", *args)


def test_scripts_run_as_children(jax_side, pdf, tmp_path):
    results, ft = tmp_path / "results", tmp_path / "ft"
    quickstart = _child(
        "import sys\n"
        "from crs_tpu_torch.utils import config\n"
        f"config.DEFAULT_CONFIG['rag']['generation']['max_new_tokens'] = {QUICKSTART_TOKENS}\n"
        "from crs_tpu_torch.examples.quickstart import main\n"
        f"sys.exit(main(sys.argv[1:], results_dir={str(results)!r}, ft_dir={str(ft)!r}))",
        str(pdf), "--device", "cpu")
    tools = {  # tool → (child, the JAX tool's JSON keys)
        "bench_decode": (_tool_child("bench_decode", "--config", "tiny", "--bits", "4",
                                     "--kv-bits", "8", "--prefill", "16", "--n1", "2",
                                     "--n2", "4", "--runs", "1"),
                         {"config", "bits", "kv_bits", "batch", "prefill",
                          "decode_ms_per_token", "tokens_per_sec", "t_n1_s", "t_n2_s"}),
        "bench_prefill_mfu": (_tool_child("bench_prefill_mfu", *PREFILL_ARGS),
                              {"prefill_mfu_percent", "prefill_tflops_achieved",
                               "prefill_batch", "prefill_seq_len", "prefill_tokens_per_sec",
                               "config", "type"}),
        "bench_fused_mlp": (_tool_child("bench_fused_mlp", "--h", "256", "--inter", "1024",
                                        "--chunk", "256", "--layers", "2", "--reps", "1"),
                            {"xla_int8", "fused"}),
    }
    want_chunks = jax_side["chunks"]
    for name, (proc, keys) in tools.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, out, err)
        assert "device=cpu" in err, (name, err)
        last = _last_json(out)
        assert set(last) == keys | {"device"} and last["device"] == "cpu", (name, last)
    out, err = quickstart.communicate(timeout=300)
    assert quickstart.returncode == 0, (out, err)
    indexed = re.search(r"^indexed (\d+) chunks in", out, re.M)
    assert indexed and int(indexed.group(1)) == want_chunks > 1, (out, want_chunks)
    for line in ("answer:", "retrieval metrics: {'avg_retrieval_time_ms'", "finetune: loss "):
        assert line in out, (line, out)
    assert (results / "retrieval_results.json").exists() or any(results.iterdir())
    assert any(ft.iterdir())


# -- the device rule ------------------------------------------------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("module", ["crs_tpu_torch.examples.quickstart",
                                    "crs_tpu_torch.tools.bench_decode",
                                    "crs_tpu_torch.tools.bench_prefill_mfu",
                                    "crs_tpu_torch.tools.bench_fused_mlp"])
def test_scripts_raise_without_cuda_unless_cpu_is_asked(no_cuda, module):
    mod = importlib.import_module(module)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
