"""The port's scale tools (``crs_tpu_torch/tools/bench_scale.py``,
``bench_pq_serving.py``) and PQ serving example
(``crs_tpu_torch/examples/pq_serving.py``) against the JAX scripts
``tools/bench_scale.py``, ``tools/bench_pq_serving.py`` and
``examples/pq_serving.py``.

The JAX scripts are imported by path. ``tools/bench_pq_serving.py`` runs
whole (its ``main()``, ``--cpu``) with its ``CHUNK`` set to 4,096 rows, its
Pallas scans in interpret mode: the port's truth, serving scan and host
rescore are then fed that run's corpus (drawn by its ``_gen_chunk`` from
its keys) and its trained codebooks and codes (its ``--codes-cache``),
since torch cannot reproduce ``jax.random``. The scan tool's draw and loop
are restated from ``tools/bench_scale.py:62-87`` with ``crs_tpu``'s own
scans; the example's loop from ``examples/pq_serving.py:49-85`` at 1,024
rows. The JAX tool's runs, its corpus and the example's JAX stores run in
child processes of their own (``JAX_PQ_SIDE``, ``JAX_EXAMPLE_SIDE``):
after a ``crs_tpu`` int4 forward (its Pallas q4 kernel in interpret mode),
XLA refuses the second call of some jitted programs in the same process
("Execution supplied 4 buffers but compiled program expected 5"), and the
test workers run several files in one process; the scans here run each
JAX program once.
Each script also runs once as a child process with ``--device cpu``
(the PQ tool and the example at small sizes through their module
constants), and each raises without CUDA unless the CPU was asked for.

Tolerances:
- the scan tool's draw: bit for bit; its ids equal to ``pallas_topk_int8``'s
  and ``int8_topk``'s, its scores within 1e-6 relative (exact int32
  products, one f32 scale product in another order), the folded two-scan sum
  within 1e-6 relative;
- the PQ tool: the truth ids equal; the serving ids equal to the Pallas
  scans' (both layouts), ADC scores within 1e-5 relative (torch and XLA
  may sum the LUT products in other orders; observed equal); the host
  rescore equal; the three recalls equal to the JAX run's JSON;
- the example: ``make_corpus`` bit for bit; each mode's recall@10 within
  0.05 of ``crs_tpu``'s: the codebooks train from other random streams (at
  1,024 rows the port reads 0.994 / 0.994 / 0.925 and ``crs_tpu`` 0.994 /
  0.994 / 0.938; at 20,000 rows 0.956 / 0.956 in both rescored modes and
  0.637 / 0.597 ADC-only);
- a codes cache without the generator's name is refused.
"""

import importlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SCAN = {"rows": 16384, "dim": 128, "batch": 8, "k": 16, "block_size": 4096, "rescore_k": 32}
SCORE_RTOL = 1e-6
PQ_CHUNK = 4096
PQ = {"rows": 8192, "dim": 64, "subspaces": 4, "coarse": 256, "centers": 32, "batch": 8,
      "cand": 50, "k": 10, "sigma": 0.35, "block_size": 2048}
PQ_ARGS = ["--rows", str(PQ["rows"]), "--dim", str(PQ["dim"]), "--subspaces", str(PQ["subspaces"]),
           "--coarse", str(PQ["coarse"]), "--centers", str(PQ["centers"]),
           "--batch", str(PQ["batch"]), "--cand", str(PQ["cand"])]
ADC_RTOL = 1e-5
EXAMPLE_N = 1024
RECALL_ATOL = 0.05


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


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


# -- bench_scale ----------------------------------------------------------------------------

def _jax_draw(n, d, b):
    """``tools/bench_scale.py:62-69``: codes, scales, then the queries."""
    rng = np.random.default_rng(0)
    codes = rng.integers(-127, 128, (n, d), dtype=np.int8)
    scales = (rng.random(n).astype(np.float32) * 0.5 + 0.5) / 127.0
    return codes, scales, rng.standard_normal((b, d)).astype(np.float32)


@pytest.fixture(scope="module")
def scan_case():
    from crs_tpu_torch.tools import bench_scale as bs

    want = _jax_draw(SCAN["rows"], SCAN["dim"], SCAN["batch"])
    return want, bs.draw(SCAN["rows"], SCAN["dim"], SCAN["batch"], CPU)


def test_scale_draw_equals_the_jax_tool(scan_case):
    want, got = scan_case
    for w, g in zip(want, got):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_scale_scan_matches_the_jax_scan(scan_case, engine):
    from crs_tpu.ops.pallas_scan import pallas_topk_int8
    from crs_tpu.ops.quant import int8_topk
    from crs_tpu_torch.tools import bench_scale as bs

    (codes, scales, q), (tc, ts, tq) = scan_case
    n, k = SCAN["rows"], SCAN["k"]

    def jax_scan(qc):
        if engine == "pallas":
            return pallas_topk_int8(jnp.asarray(codes), jnp.asarray(scales), qc, k, n,
                                    block_size=SCAN["block_size"], kb=0)
        return int8_topk(jnp.asarray(codes), jnp.asarray(scales), qc, k, n,
                         rescore_k=SCAN["rescore_k"])

    @jax.jit
    def folded(q0):  # the tool's jitted loop of two repetitions (tools/bench_scale.py:71-87)
        def body(i, carry):
            acc, qc = carry
            s, _ = jax_scan(qc)
            return acc + s.sum(), qc + 1e-6 * s[:, :1]

        return jax.lax.fori_loop(0, 2, body, (jnp.float32(0.0), q0))[0]

    # each JAX program runs once: after a crs_tpu generate in the same process, a second
    # call of the same jitted scan is refused by XLA ("supplied 4 buffers ... expected 5")
    scan = bs.engine_scan(engine, tc, ts, k, SCAN["block_size"], 0, SCAN["rescore_k"])
    want_s, want_i = jax_scan(jnp.asarray(q))
    got_s, got_i = scan(tq)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=SCORE_RTOL, atol=0)
    want_acc = float(folded(jnp.asarray(q)))
    assert float(bs.repeated(scan, tq, 2)) == pytest.approx(want_acc, rel=SCORE_RTOL)


# -- bench_pq_serving -----------------------------------------------------------------------

# the JAX side that runs jitted programs more than once, in two children started together:
# tools/bench_pq_serving.py's main at 4,096-row chunks, unsorted then sorted from its codes
# cache, and its corpus (main's keys, centers and mix: tools/bench_pq_serving.py:106-121);
# the example's stores (examples/pq_serving.py:59-77) through crs_tpu's VectorStore
JAX_PQ_SIDE = """
import contextlib, importlib.util, io, json, sys
import numpy as np
import jax, jax.numpy as jnp
pq, chunk, pq_args, cache, arrays = json.loads(sys.argv[1])
spec = importlib.util.spec_from_file_location("jax_bench_pq_serving", "tools/bench_pq_serving.py")
jt = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jt)
jt.CHUNK = chunk
runs = {}
for layout, extra in (("unsorted", []), ("sorted", ["--sorted-coarse"])):
    sys.argv = ["bench_pq_serving.py", *pq_args, "--cpu", "--codes-cache", cache, *extra]
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        jt.main()
    runs[layout] = json.loads(buf.getvalue().strip().splitlines()[-1])
d, nchunks = pq["dim"], pq["rows"] // chunk
ck, qk, tk, mk = jax.random.split(jax.random.PRNGKey(0), 4)
spec = jnp.exp(-jnp.arange(d, dtype=jnp.float32) / 20.0)
mix = jax.random.normal(mk, (d, d), jnp.float32) * spec[None, :] / d ** 0.5
centers = jax.random.normal(ck, (pq["centers"], d), jnp.float32) @ mix * 3.0
centers = centers / jnp.linalg.norm(centers, axis=1, keepdims=True)
chunk_keys = jax.random.split(tk, nchunks)
gen = jax.jit(lambda key: jt._gen_chunk(key, centers, mix, d, pq["sigma"]))
chunks = [np.asarray(gen(chunk_keys[ci])) for ci in range(nchunks)]
queries = chunks[0][:pq["batch"]] + 0.05 * jax.random.normal(qk, (pq["batch"], d), jnp.float32)
queries = np.asarray(queries / jnp.linalg.norm(queries, axis=1, keepdims=True))
np.savez(arrays, queries=queries, **{f"chunk{ci}": x for ci, x in enumerate(chunks)})
print(json.dumps(runs))
"""
JAX_EXAMPLE_SIDE = """
import json, sys
import numpy as np
from crs_tpu.rag.index import VectorStore
from crs_tpu_torch.examples import pq_serving as port
n = int(sys.argv[1])
dim, topk, nq = port.DIM, port.TOPK, port.QUERIES
x = port.make_corpus(n, dim)
rng = np.random.default_rng(42)
qi = rng.choice(n, nq, replace=False)
q = x[qi] + 0.02 * rng.standard_normal((nq, dim)).astype(np.float32)
q /= np.linalg.norm(q, axis=1, keepdims=True)
exact = np.argsort(-(q @ x.T), axis=1)[:, :topk]
out = {}
for mode in port.MODES:
    store = VectorStore(port.store_config(mode))
    store.create_index([f"doc-{i}" for i in range(n)], x)
    ids = np.asarray(store.search_batch(q, top_k=topk)[1])
    out[mode] = {
        "recall": float(np.mean([len(set(ids[i]) & set(exact[i])) / topk for i in range(nq)])),
        "host_mirror_bytes": int(store.get_stats().get("host_mirror_bytes", 0))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    base = tmp_path_factory.mktemp("pq")
    return str(base / "codes.npz"), str(base / "corpus.npz")


def _jax_child(code: str, *args):
    return subprocess.Popen([sys.executable, "-c", code, *args], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(REPO)))


@pytest.fixture(autouse=True, scope="module")
def _jax_side_procs(jax_files):
    """The JAX side's two children, started with the file's first test."""
    procs = {"pq": _jax_child(JAX_PQ_SIDE, json.dumps([PQ, PQ_CHUNK, PQ_ARGS, *jax_files])),
             "example": _jax_child(JAX_EXAMPLE_SIDE, str(EXAMPLE_N))}
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.communicate()


def _result(proc) -> dict:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_pq(_jax_side_procs, jax_files):
    """({layout: the JAX tool's JSON}, its chunks, queries, its codes cache's arrays)."""
    runs = _result(_jax_side_procs["pq"])
    cache, arrays = jax_files
    corpus = np.load(arrays)
    chunks = [corpus[f"chunk{ci}"] for ci in range(PQ["rows"] // PQ_CHUNK)]
    return runs, chunks, np.array(corpus["queries"]), dict(np.load(cache))


def _port_rpq(data):
    from crs_tpu_torch.ops.pq import PQCodebook, ResidualPQ

    return ResidualPQ(rotation=torch.from_numpy(data["rotation"]),
                      coarse=torch.from_numpy(data["coarse"]),
                      codebook=PQCodebook(torch.from_numpy(data["centroids"])))


def _jax_truth(chunks, queries, k):
    """The JAX tool's fp32 truth (``tools/bench_pq_serving.py:246-264``)."""
    best_s = np.full((queries.shape[0], 0), -np.inf, np.float32)
    best_i = np.zeros((queries.shape[0], 0), np.int64)
    for ci, x in enumerate(chunks):
        s_c, i_c = jax.lax.top_k(jnp.dot(queries, x.T, preferred_element_type=jnp.float32), k)
        best_s = np.concatenate([best_s, np.asarray(s_c)], axis=1)
        best_i = np.concatenate([best_i, np.asarray(i_c, np.int64) + ci * PQ_CHUNK], axis=1)
        if best_s.shape[1] > 4 * k:
            sel = np.argsort(-best_s, axis=1)[:, :k]
            best_s = np.take_along_axis(best_s, sel, axis=1)
            best_i = np.take_along_axis(best_i, sel, axis=1)
    return np.take_along_axis(best_i, np.argsort(-best_s, axis=1)[:, :k], axis=1)


def _jax_scan(data, queries, sorted_coarse):
    """The JAX tool's serving scan (``tools/bench_pq_serving.py:268-307``)."""
    from crs_tpu.ops import pallas_scan as ps
    from crs_tpu.ops.pq import sort_codes_by_coarse

    n, m2 = PQ["rows"], PQ["subspaces"] + 2
    args = (jnp.asarray(data["rotation"]), jnp.asarray(data["coarse"]),
            jnp.asarray(data["centroids"]))
    if not sorted_coarse:
        return ps.pallas_topk_residual_pq_adc(*args, jnp.asarray(data["ext"]), queries,
                                              PQ["cand"], n, PQ["block_size"])
    ext, perm, counts = sort_codes_by_coarse(data["ext"], PQ["coarse"])
    group = ps.adc_auto_group(n, PQ["batch"], PQ["block_size"], m2)
    wbase = ps.plan_sorted_coarse_windows(counts, n, PQ["block_size"], group)
    s, i = ps.pallas_topk_residual_pq_adc_sorted(*args, jnp.asarray(ext), jnp.asarray(wbase),
                                                 queries, PQ["cand"], n, PQ["block_size"],
                                                 group=group)
    return s, jnp.where(i >= 0, jnp.asarray(perm)[i], -1)


def test_pq_truth_equals_the_jax_tool(jax_pq):
    from crs_tpu_torch.tools import bench_pq_serving as bps

    _, chunks, queries, _ = jax_pq
    got = bps.ground_truth(lambda ci: torch.from_numpy(chunks[ci]), len(chunks), PQ_CHUNK,
                           torch.from_numpy(queries), PQ["k"])
    np.testing.assert_array_equal(got, _jax_truth(chunks, jnp.asarray(queries), PQ["k"]))


@pytest.mark.parametrize("layout", ["unsorted", "sorted"])
def test_pq_serving_and_host_rescore_equal_the_jax_tool(jax_pq, layout):
    from crs_tpu_torch.tools import bench_pq_serving as bps

    runs, chunks, queries, data = jax_pq
    n, k = PQ["rows"], PQ["k"]
    sorted_coarse = layout == "sorted"
    scan, nbytes = bps.make_scan(_port_rpq(data), data["ext"], n, PQ["cand"], PQ["block_size"],
                                 CPU, sorted_coarse, PQ["coarse"], PQ["batch"])
    assert nbytes == n * (PQ["subspaces"] + 2)
    got_s, got_i = (t.numpy() for t in scan(torch.from_numpy(queries)))
    want_s, want_i = (np.asarray(t) for t in _jax_scan(data, jnp.asarray(queries), sorted_coarse))
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=ADC_RTOL, atol=ADC_RTOL)
    # the host rescore (tools/bench_pq_serving.py:338-344) on the JAX scan's candidates
    mirror, mscales = data["mirror"], data["mirror_scales"]
    rows = np.clip(want_i, 0, n - 1)
    exact = np.einsum("bd,bcd->bc", queries,
                      mirror[rows].astype(np.float32) * mscales[rows][..., None])
    exact = np.where(want_s <= -1e29, -1e30, exact)
    want_host = np.take_along_axis(want_i, np.argsort(-exact, axis=1)[:, :k], axis=1)
    got_host = bps.host_rescore(mirror, mscales, queries, want_s, want_i, k, n)
    np.testing.assert_array_equal(got_host, want_host)
    # the three recalls of the JAX run's JSON
    truth = bps.ground_truth(lambda ci: torch.from_numpy(chunks[ci]), len(chunks), PQ_CHUNK,
                             torch.from_numpy(queries), k)
    want = runs[layout]
    assert bps.recall(got_i, truth, k) == want["recall_at_k_none"]
    assert bps.recall(got_i, truth, k, width=PQ["cand"]) == want["recall_k_in_cand"]
    assert bps.recall(got_host, truth, k) == want["recall_at_k_host"]
    assert want["sorted_coarse"] == sorted_coarse


def test_pq_cache_without_the_generator_is_refused(jax_pq, tmp_path):
    from crs_tpu_torch.tools import bench_pq_serving as bps

    data = jax_pq[3]  # the JAX tool's own cache: no generator key
    jax_cache = tmp_path / "jax.npz"
    np.savez(jax_cache, **data)
    with pytest.raises(ValueError, match="corpus_generator"):
        bps.load_cache(str(jax_cache), PQ["rows"], PQ["subspaces"], None, CPU)
    other = tmp_path / "other.npz"
    np.savez(other, **data, corpus_generator="another generator")
    with pytest.raises(ValueError, match="holds the corpus of 'another generator'"):
        bps.load_cache(str(other), PQ["rows"], PQ["subspaces"], None, CPU)
    mine = tmp_path / "mine.npz"
    np.savez(mine, **data, corpus_generator=bps.generator_name(CPU))
    _, rpq = bps.load_cache(str(mine), PQ["rows"], PQ["subspaces"], None, CPU)
    np.testing.assert_array_equal(rpq.coarse.numpy(), data["coarse"])
    with pytest.raises(ValueError, match="asked rows"):
        bps.load_cache(str(mine), 2 * PQ["rows"], PQ["subspaces"], None, CPU)


# -- the pq_serving example -----------------------------------------------------------------

def test_example_corpus_equals_the_jax_example():
    from crs_tpu_torch.examples import pq_serving as port

    je = _load_jax_script("examples/pq_serving.py")
    for args in ((EXAMPLE_N, 128), (300, 64, 16, 3)):
        np.testing.assert_array_equal(port.make_corpus(*args), je.make_corpus(*args))


def test_example_recalls_match_crs_tpu(_jax_side_procs):
    from crs_tpu_torch.examples import pq_serving as port

    n, d, topk, nq = EXAMPLE_N, port.DIM, port.TOPK, port.QUERIES
    x = port.make_corpus(n, d)
    rng = np.random.default_rng(42)
    qi = rng.choice(n, nq, replace=False)
    q = x[qi] + 0.02 * rng.standard_normal((nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    exact = np.argsort(-(q @ x.T), axis=1)[:, :topk]
    got = port.serve_modes(x, q, exact, topk, CPU, report=lambda line: None)
    assert set(got) == set(port.MODES)
    jax_side = _result(_jax_side_procs["example"])
    for mode in port.MODES:
        want = jax_side[mode]
        assert abs(got[mode]["recall"] - want["recall"]) <= RECALL_ATOL, (mode, got[mode], want)
        assert got[mode]["host_mirror_bytes_per_vec"] == want["host_mirror_bytes"] / n, mode


# -- the scripts as children ----------------------------------------------------------------

def _child(code: str, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


SCALE_KEYS = {"rows", "dim", "batch", "k", "engine", "block_size", "kb", "scan_ms",
              "ms_per_query", "effective_gbps"}
PQ_KEYS = {"rows", "dim", "bytes_per_vec_hbm", "hbm_gb", "scan_ms", "ms_per_query",
           "recall_at_k_none", "recall_k_in_cand", "cand", "k", "sorted_coarse",
           "host_rescore_ms", "recall_at_k_host", "host_mirror_gb"}


def test_scripts_run_as_children(tmp_path):
    cache = str(tmp_path / "codes.npz")
    pq_code = ("import sys\nfrom crs_tpu_torch.tools import bench_pq_serving as t\n"
               f"t.CHUNK = {PQ_CHUNK}\nsys.exit(t.main(sys.argv[1:]))")
    scale_code = "import sys\nfrom crs_tpu_torch.tools.bench_scale import main\n" \
                 "sys.exit(main(sys.argv[1:]))"
    scale_args = ["--device", "cpu", "--rows", "20000", "--dim", "128", "--batch", "8",
                  "--k", "16", "--reps", "1", "--n2", "2"]
    runs = {  # name → (child, the JAX script's JSON keys or None)
        "scale_pallas": (_child(scale_code, *scale_args), SCALE_KEYS),
        "scale_xla": (_child(scale_code, *scale_args, "--engine", "xla"), SCALE_KEYS),
        "example": (_child("import sys\nfrom crs_tpu_torch.examples import pq_serving as e\n"
                           f"e.N = {EXAMPLE_N}\nsys.exit(e.main(sys.argv[1:]))",
                           "--device", "cpu"), None),
        "pq": (_child(pq_code, *PQ_ARGS, "--device", "cpu", "--codes-cache", cache), PQ_KEYS),
    }
    results = {}
    for name, (proc, keys) in runs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, out, err)
        results[name] = out
        if keys is not None:
            assert "device=cpu" in err, (name, err)
            last = _last_json(out)
            assert set(last) == keys | {"host_scan_ms", "device"} and last["device"] == "cpu"
            assert last["scan_ms"] > 0, (name, last)
    assert _last_json(results["scale_xla"])["engine"] == "xla"
    lines = results["example"].strip().splitlines()
    assert [line.split()[0] for line in lines] == [f"pq_rescore={m}" for m in ("int8", "host")] \
        + ["pq_rescore=none"] and all("recall@10=" in line for line in lines), lines
    # the sorted layout from the first run's cache: no second encode
    proc = _child(pq_code, *PQ_ARGS, "--device", "cpu", "--codes-cache", cache,
                  "--sorted-coarse")
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0 and "loaded codes cache" in err, (out, err)
    sorted_run, unsorted_run = _last_json(out), _last_json(results["pq"])
    assert sorted_run["sorted_coarse"] and not unsorted_run["sorted_coarse"]
    assert sorted_run["hbm_gb"] == unsorted_run["hbm_gb"] and 0 < sorted_run["recall_at_k_host"] <= 1


# -- the device rule ------------------------------------------------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("module", ["crs_tpu_torch.tools.bench_scale",
                                    "crs_tpu_torch.tools.bench_pq_serving",
                                    "crs_tpu_torch.examples.pq_serving"])
def test_scripts_raise_without_cuda_unless_cpu_is_asked(no_cuda, module):
    mod = importlib.import_module(module)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
