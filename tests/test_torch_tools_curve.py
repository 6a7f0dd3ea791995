"""The port's PQ recall-curve tools (``crs_tpu_torch/tools/pq_recall_curve.py``,
``curve_report.py``, ``plot_pq_curve.py``) against the JAX scripts
``tools/pq_recall_curve.py``, ``tools/curve_report.py`` and
``tools/plot_pq_curve.py``.

The JAX curve runs whole (its ``main()``, ``--cpu``) in a child process,
once per engine (``pallas`` and ``pallas_sorted`` with its Pallas scans in
interpret mode, ``xla``), on 8,192 rows in chunks of 4,096 (the chunk size
of ``tools/bench_pq_serving.py`` set for the run), one (M, coarse) and two
candidate depths, its caches in a temporary directory. The child also draws
that run's corpus again (the curve's keys, centers and mix) and scans it
with the curve's own scan code at each depth. Torch cannot reproduce
``jax.random``, so the port's truth, scans, host mirror, rescore and
recalls are fed that corpus and the codebooks and codes of the JAX run's
cache. The JAX side runs in a child because XLA on the CPU refuses the
second call of some jitted programs in a process that ran a ``crs_tpu`` int4
forward before (the test workers run several files in one process).
``curve_report`` runs in this process on the committed curve files (read
only); ``plot_pq_curve`` too, its figure's lines compared with the JAX
tool's. Each script also runs once as a child with ``--device cpu`` and
its outputs in a temporary directory, and raises without CUDA unless the
CPU was asked for.

Tolerances:
- the truth ids, the scan ids (each engine, each depth), the host mirror
  (codes and scales) and the host-rescored ids: equal;
- the ADC scores within 1e-5 relative (torch and XLA may sum the LUT terms
  in other orders);
- the three recalls of each row: equal to the JAX run's rows (both rounded
  to 4 digits);
- ``curve_report``: its standard output equal byte for byte;
- the plot: each line's x and y data, colour, marker and line style, and
  each label's text and position, equal.
"""

import contextlib
import hashlib
import importlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
CHUNK = 4096
CURVE = {"rows": 8192, "dim": 64, "centers": 32, "batch": 8, "k": 10, "sigma": 0.35, "m": 4,
         "coarse": 256, "cands": (50, 100), "block_size": 2048}
CURVE_ARGS = ["--rows", str(CURVE["rows"]), "--dim", str(CURVE["dim"]),
              "--centers", str(CURVE["centers"]), "--batch", str(CURVE["batch"]),
              "--ms", str(CURVE["m"]), "--coarses", str(CURVE["coarse"]),
              "--cands", ",".join(map(str, CURVE["cands"]))]
ENGINES = ("pallas", "pallas_sorted", "xla")
ADC_RTOL = 1e-5
CURVE_FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "results" / "pq_recall").glob(
    "curve_*.json"))
TPU_FILES = ["results/pq_recall/curve_tpu_4m.json", "results/pq_recall/curve_tpu_4m_aniso.json"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _load_jax_script(path: str):
    spec = importlib.util.spec_from_file_location(f"_jax_{pathlib.Path(path).stem}", REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the JAX side: tools/pq_recall_curve.py's main once per engine (one cache directory), then
# its corpus drawn again (its keys, centers and mix: tools/pq_recall_curve.py:93-112) and each
# engine's scan at each depth (its scan code: tools/pq_recall_curve.py:218-274) over the
# codebooks and codes of its cache
JAX_CURVE_SIDE = """
import contextlib, importlib.util, io, json, sys
from pathlib import Path
import numpy as np
import jax, jax.numpy as jnp
cfg, chunk, curve_args, cache_dir, outs, arrays = json.loads(sys.argv[1])
def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
bps = load("bench_pq_serving", "tools/bench_pq_serving.py")  # the name the curve imports
bps.CHUNK = chunk
curve = load("jax_pq_recall_curve", "tools/pq_recall_curve.py")
runs = {}
for engine, out in outs.items():
    sys.argv = ["pq_recall_curve.py", *curve_args, "--cpu", "--engine", engine,
                "--cache-dir", cache_dir, "--out", out]
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        curve.main()
    runs[engine] = [json.loads(line) for line in buf.getvalue().strip().splitlines()]
n, d, b = cfg["rows"], cfg["dim"], cfg["batch"]
nchunks = n // chunk
ck, qk, tk, mk = jax.random.split(jax.random.PRNGKey(0), 4)
spec = jnp.exp(-jnp.arange(d, dtype=jnp.float32) / 20.0)
mix = jax.random.normal(mk, (d, d), jnp.float32) * spec[None, :] / d ** 0.5
centers = jax.random.normal(ck, (cfg["centers"], d), jnp.float32) @ mix * 3.0
centers = centers / jnp.linalg.norm(centers, axis=1, keepdims=True)
chunk_keys = jax.random.split(tk, nchunks)
gen = jax.jit(lambda key: bps._gen_chunk(key, centers, mix, d, cfg["sigma"])[:chunk])
chunks = [np.asarray(gen(chunk_keys[ci])) for ci in range(nchunks)]
qn = jax.random.normal(qk, (b, d), jnp.float32)
queries = chunks[0][:b] + 0.05 * qn
queries = queries / jnp.linalg.norm(queries, axis=1, keepdims=True)
from crs_tpu.ops import pallas_scan as ps
from crs_tpu.ops.pq import PQCodebook, ResidualPQ, residual_pq_adc_topk, sort_codes_by_coarse
data = np.load(Path(cache_dir) / f"codes_{n}_m{cfg['m']}_c{cfg['coarse']}.npz")
rpq = ResidualPQ(rotation=jnp.asarray(data["rotation"]), coarse=jnp.asarray(data["coarse"]),
                 codebook=PQCodebook(jnp.asarray(data["centroids"])))
ext = jnp.asarray(data["ext"])
scans = {}
for cand in cfg["cands"]:
    scans[f"pallas_{cand}"] = ps.pallas_topk_residual_pq_adc(
        rpq.rotation, rpq.coarse, rpq.codebook.centroids, ext, queries, cand, n,
        cfg["block_size"])
    sorted_ext, perm, counts = sort_codes_by_coarse(data["ext"], cfg["coarse"])
    group = ps.adc_auto_group(n, b, cfg["block_size"], cfg["m"] + 2)
    wbase = ps.plan_sorted_coarse_windows(counts, n, cfg["block_size"], group)
    s, i = ps.pallas_topk_residual_pq_adc_sorted(
        rpq.rotation, rpq.coarse, rpq.codebook.centroids, jnp.asarray(sorted_ext),
        jnp.asarray(wbase), queries, cand, n, cfg["block_size"], group=group)
    scans[f"pallas_sorted_{cand}"] = (s, jnp.where(i >= 0, jnp.asarray(perm)[i], -1))
    cids = ext[:, 0].astype(jnp.int32) * 256 + ext[:, 1].astype(jnp.int32)
    scans[f"xla_{cand}"] = residual_pq_adc_topk(rpq, cids, ext[:, 2:].astype(jnp.int32),
                                                queries, cand, n)
flat = {}
for name, (s, i) in scans.items():
    flat[name + "_s"], flat[name + "_i"] = np.asarray(s), np.asarray(i)
np.savez(arrays, queries=np.asarray(queries), **flat,
         **{f"chunk{ci}": x for ci, x in enumerate(chunks)})
print(json.dumps(runs))
"""


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("curve")
    outs = {e: str(base / f"jax_{e}.json") for e in ENGINES}
    return str(base / "jax_cache"), outs, str(base / "arrays.npz")


@pytest.fixture(autouse=True, scope="module")
def _jax_side_proc(jax_dirs):
    """The JAX side's child, started with the file's first test."""
    cache, outs, arrays = jax_dirs
    cfg = dict(CURVE, cands=list(CURVE["cands"]))
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_CURVE_SIDE,
         json.dumps([cfg, CHUNK, CURVE_ARGS, cache, outs, arrays])],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                 XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"))
    yield proc
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_curve(_jax_side_proc, jax_dirs):
    """(the JAX runs' rows by engine, its chunks, queries, scans, cache directory)."""
    out, err = _jax_side_proc.communicate(timeout=300)
    assert _jax_side_proc.returncode == 0, err
    cache, _, arrays = jax_dirs
    z = np.load(arrays)
    chunks = [z[f"chunk{ci}"] for ci in range(CURVE["rows"] // CHUNK)]
    scans = {k: z[k] for k in z.files if k[-2:] in ("_s", "_i")}
    return json.loads(out.strip().splitlines()[-1]), chunks, z["queries"], scans, cache


# -- curve_report ---------------------------------------------------------------------------

REPORT_ARGS = [CURVE_FILES, ["results/pq_recall/curve_cpu_1m.json"], TPU_FILES,
               [*CURVE_FILES, "--metric", "recall_none", "--target", "0.5", "--budget", "14"],
               [*TPU_FILES, "--metric", "recall_in_cand", "--budget", "26"],
               [*CURVE_FILES, "--target", "0.99", "--budget", "8"]]


@pytest.mark.parametrize("argv", REPORT_ARGS, ids=lambda a: " ".join(a)[-60:])
def test_curve_report_prints_the_jax_tools_bytes(argv, monkeypatch):
    from crs_tpu_torch.tools import curve_report

    jax_report = _load_jax_script("tools/curve_report.py")
    monkeypatch.setattr(sys, "argv", ["curve_report.py", *argv])
    with contextlib.redirect_stdout(io.StringIO()) as want:
        assert jax_report.main() == 0
    with contextlib.redirect_stdout(io.StringIO()) as got:
        assert curve_report.main([*argv, "--device", "cpu"]) == 0
    assert got.getvalue() == want.getvalue()
    assert "VERDICT criterion" in got.getvalue()


def test_curve_report_of_no_rows_exits_1(tmp_path, capsys):
    from crs_tpu_torch.tools import curve_report

    empty = tmp_path / "empty.json"
    empty.write_text("[]")
    assert curve_report.main([str(empty), "--device", "cpu"]) == 1
    assert capsys.readouterr().err == "no rows\n"


# -- plot_pq_curve --------------------------------------------------------------------------

def _lines(fig):
    (ax,) = fig.axes
    lines = [(list(map(float, ln.get_xdata())), list(map(float, ln.get_ydata())),
              ln.get_color(), ln.get_marker(), str(ln.get_linestyle()), ln.get_label())
             for ln in ax.get_lines()]
    labels = sorted((t.get_text(), tuple(map(float, t.xy))) for t in ax.texts)
    return lines, labels


@pytest.mark.parametrize("argv", [TPU_FILES, [*TPU_FILES, "--min-cand", "100"],
                                  ["results/pq_recall/curve_tpu_4m.json"]],
                         ids=lambda a: " ".join(a)[-50:])
def test_plot_draws_the_jax_tools_lines(argv, tmp_path, monkeypatch):
    import matplotlib.pyplot as plt

    from crs_tpu_torch.tools import plot_pq_curve as port

    jax_plot = _load_jax_script("tools/plot_pq_curve.py")
    plt.close("all")
    monkeypatch.setattr(sys, "argv", ["plot_pq_curve.py", *argv, "--out", str(tmp_path / "jax")])
    with contextlib.redirect_stdout(io.StringIO()) as want:
        jax_plot.main()
    want_lines = _lines(plt.gcf())
    plt.close("all")
    with contextlib.redirect_stdout(io.StringIO()) as got:
        assert port.main([*argv, "--out", str(tmp_path / "port" / "fig"), "--device", "cpu"]) == 0
    assert got.getvalue().replace(str(tmp_path / "port" / "fig"), "OUT") == \
        want.getvalue().replace(str(tmp_path / "jax"), "OUT")
    assert (tmp_path / "port" / "fig.png").stat().st_size > 0
    assert (tmp_path / "port" / "fig.pdf").stat().st_size > 0
    assert not plt.get_fignums()  # the port's main closes its figure
    rows = []
    for f in argv:
        if f.endswith(".json"):
            with open(REPO / f) as fh:
                rows.extend(json.load(fh))
    min_cand = int(argv[argv.index("--min-cand") + 1]) if "--min-cand" in argv else 200
    fig = port.draw(port.pyplot(), port.select_rows(rows, min_cand, report=lambda line: None))
    got_lines = _lines(fig)
    plt.close(fig)
    assert got_lines == want_lines and want_lines[0]


def test_plot_refuses_to_draw_nothing(tmp_path):
    from crs_tpu_torch.tools import plot_pq_curve as port

    with pytest.raises(ValueError, match="no figure was written"):
        port.main([*TPU_FILES, "--min-cand", "1000", "--out", str(tmp_path / "fig"),
                   "--device", "cpu"])
    assert not list(tmp_path.iterdir())


def test_plot_without_matplotlib_raises(monkeypatch, tmp_path):
    from crs_tpu_torch.tools import plot_pq_curve as port

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib → ImportError
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        port.main([*TPU_FILES, "--out", str(tmp_path / "fig"), "--device", "cpu"])
    assert not list(tmp_path.iterdir())


# -- the scripts as children, their defaults and the device rule ----------------------------

def _tree_digest(*dirs) -> str:
    h = hashlib.sha256()
    for d in dirs:
        for p in sorted((REPO / d).rglob("*")):
            if p.is_file():
                h.update(str(p.relative_to(REPO)).encode())
                h.update(p.read_bytes())
    return h.hexdigest()


def _child(code: str, tmp, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", TMPDIR=str(tmp))
    return subprocess.Popen([sys.executable, "-c", code, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _done(proc, what):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, (what, out, err)
    return out, err


def test_scripts_run_as_children(tmp_path):
    before = _tree_digest("results", "report")
    curve_code = ("import sys\nfrom crs_tpu_torch.tools import bench_pq_serving as b, "
                  f"pq_recall_curve as c\nb.CHUNK = {CHUNK}\nsys.exit(c.main(sys.argv[1:]))")
    main_of = "import sys\nfrom crs_tpu_torch.tools.{} import main\nsys.exit(main(sys.argv[1:]))"
    out = str(tmp_path / "curve.json")
    plot = _child(main_of.format("plot_pq_curve"), tmp_path, *TPU_FILES, "--device", "cpu")
    curve_out, curve_err = _done(_child(curve_code, tmp_path, *CURVE_ARGS, "--device", "cpu",
                                        "--out", out), "pq_recall_curve")
    rows = [json.loads(line) for line in curve_out.strip().splitlines()]
    assert [r["cand"] for r in rows] == list(CURVE["cands"]) and "device=cpu" in curve_err
    assert set(rows[0]) == {"rows", "m", "coarse", "cand", "aniso_eta", "bytes_per_vec",
                            "recall_none", "recall_in_cand", "recall_host", "scan_ms",
                            "ms_per_query", "host_scan_ms", "engine", "device"}
    # its caches went to the default directory under TMPDIR
    assert sorted(p.name for p in (tmp_path / "crs_tpu_torch" / "pq_curve").iterdir()) == [
        f"codes_{CURVE['rows']}_m{CURVE['m']}_c{CURVE['coarse']}.npz",
        f"mirror_{CURVE['rows']}.npz", f"truth_{CURVE['rows']}_{CURVE['batch']}_{CURVE['k']}.npz"]
    report_out, _ = _done(_child(main_of.format("curve_report"), tmp_path, out, "--device", "cpu",
                                 "--target", "0.5"), "curve_report")
    assert report_out.count(f"| {CURVE['rows']} | {CURVE['m']} |") == len(CURVE["cands"])
    plot_out, _ = _done(plot, "plot_pq_curve")
    figure = tmp_path / "crs_tpu_torch" / "plot_pq_curve" / "pq_curve"
    assert plot_out.strip().splitlines()[-2:] == [f"wrote {figure}.png", f"wrote {figure}.pdf"]
    assert _tree_digest("results", "report") == before


@pytest.mark.parametrize("module", ["pq_recall_curve", "curve_report", "plot_pq_curve"])
def test_default_outputs_lie_outside_the_repository(module, monkeypatch, tmp_path):
    """Every default output path lies under ``<TMPDIR>/crs_tpu_torch``."""
    import argparse

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    mod = importlib.import_module(f"crs_tpu_torch.tools.{module}")
    parsed = {}

    def capture(self, args=None, namespace=None):
        parsed.update(vars(argparse.ArgumentParser.parse_known_args(self, args, namespace)[0]))
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        mod.main([] if module == "pq_recall_curve" else ["x.json"])
    paths = {k: v for k, v in parsed.items() if k in ("out", "cache_dir") and v}
    assert module == "curve_report" or paths
    for key, value in paths.items():
        assert value.startswith(str(tmp_path / "crs_tpu_torch")), (key, value)
        assert not value.startswith("/tmp/pq_curve")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("module", ["pq_recall_curve", "curve_report", "plot_pq_curve"])
def test_scripts_raise_without_cuda_unless_cpu_is_asked(no_cuda, module):
    mod = importlib.import_module(f"crs_tpu_torch.tools.{module}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([] if module == "pq_recall_curve" else TPU_FILES)


# -- the curve against the JAX run (its child started with the first test: the tests above
# run while it works) ---------------------------------------------------------------------

def _jax_cache(cache, name):
    return dict(np.load(pathlib.Path(cache) / name))


def _port_truth(chunks, queries):
    from crs_tpu_torch.tools import bench_pq_serving as bps

    return bps.ground_truth(lambda ci: torch.from_numpy(chunks[ci]), len(chunks), CHUNK,
                            torch.from_numpy(queries), CURVE["k"])


def test_truth_and_mirror_equal_the_jax_run(jax_curve):
    from crs_tpu_torch.ops.quant import scalar_quantize

    _, chunks, queries, _, cache = jax_curve
    n = CURVE["rows"]
    want = _jax_cache(cache, f"truth_{n}_{CURVE['batch']}_{CURVE['k']}.npz")["truth"]
    np.testing.assert_array_equal(_port_truth(chunks, queries), want)
    # the host mirror the port's tool builds (scalar_quantize a chunk at a time)
    mirror = _jax_cache(cache, f"mirror_{n}.npz")
    codes, scales = zip(*(scalar_quantize(torch.from_numpy(x)) for x in chunks))
    np.testing.assert_array_equal(torch.cat(codes).numpy(), mirror["mirror"])
    np.testing.assert_array_equal(torch.cat(scales).numpy(), mirror["scales"])


@pytest.mark.parametrize("engine", ENGINES)
def test_scans_rescore_and_recalls_equal_the_jax_run(jax_curve, engine):
    from crs_tpu_torch.ops.pq import PQCodebook, ResidualPQ
    from crs_tpu_torch.tools import bench_pq_serving as bps
    from crs_tpu_torch.tools import pq_recall_curve as prc

    runs, chunks, queries, scans, cache = jax_curve
    n, k, m, coarse = CURVE["rows"], CURVE["k"], CURVE["m"], CURVE["coarse"]
    data = _jax_cache(cache, f"codes_{n}_m{m}_c{coarse}.npz")
    rpq = ResidualPQ(rotation=torch.from_numpy(data["rotation"]),
                     coarse=torch.from_numpy(data["coarse"]),
                     codebook=PQCodebook(torch.from_numpy(data["centroids"])))
    scan = bps.engine_scan(engine, rpq, data["ext"], n, coarse, CURVE["batch"],
                           CURVE["block_size"], CPU)
    truth = _port_truth(chunks, queries)
    mirror = _jax_cache(cache, f"mirror_{n}.npz")
    rows = {r["cand"]: r for r in runs[engine]}
    assert sorted(rows) == list(CURVE["cands"])
    for cand in CURVE["cands"]:
        got_s, got_i = (t.numpy() for t in scan(torch.from_numpy(queries), cand))
        want_s, want_i = scans[f"{engine}_{cand}_s"], scans[f"{engine}_{cand}_i"]
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_s, want_s, rtol=ADC_RTOL, atol=ADC_RTOL)
        # the host rescore (tools/pq_recall_curve.py:288-295) on the JAX scan's candidates
        rsel = np.clip(want_i, 0, n - 1)
        exact = np.einsum("bd,bcd->bc", queries, mirror["mirror"][rsel].astype(np.float32)
                          * mirror["scales"][rsel][..., None])
        exact = np.where(want_s <= -1e29, -1e30, exact)
        want_host = np.take_along_axis(want_i, np.argsort(-exact, axis=1)[:, :k], axis=1)
        got_host = bps.host_rescore(mirror["mirror"], mirror["scales"], queries, got_s, got_i, k,
                                    n)
        np.testing.assert_array_equal(got_host, want_host)
        row = rows[cand]
        assert round(bps.recall(got_i, truth, k), 4) == row["recall_none"]
        assert round(bps.recall(got_i, truth, k, width=cand), 4) == row["recall_in_cand"]
        assert round(bps.recall(got_host, truth, k), 4) == row["recall_host"]
        assert (row["rows"], row["m"], row["coarse"], row["bytes_per_vec"], row["engine"]) == (
            n, m, coarse, m + 2, engine)


def _port_main(monkeypatch, *args):
    from crs_tpu_torch.tools import bench_pq_serving as bps
    from crs_tpu_torch.tools import pq_recall_curve as prc

    monkeypatch.setattr(bps, "CHUNK", CHUNK)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert prc.main([*CURVE_ARGS, "--device", "cpu", *args]) == 0
    return [json.loads(line) for line in buf.getvalue().strip().splitlines()]


def test_rerun_with_the_same_out_adds_no_row_and_jax_caches_are_refused(jax_curve, tmp_path,
                                                                        monkeypatch):
    from crs_tpu_torch.tools import pq_recall_curve as prc

    cache, out = str(tmp_path / "cache"), str(tmp_path / "curve.json")
    first = _port_main(monkeypatch, "--engine", "xla", "--cache-dir", cache, "--out", out)
    assert [r["cand"] for r in first] == list(CURVE["cands"])
    assert all(r["device"] == "cpu" and r["scan_ms"] > 0 and "host_scan_ms" in r for r in first)
    with open(out) as fh:
        assert json.load(fh) == first
    assert _port_main(monkeypatch, "--engine", "xla", "--cache-dir", cache, "--out", out) == []
    with open(out) as fh:
        assert json.load(fh) == first
    # the same caches serve the kernel engine; its rows go to another --out
    again = _port_main(monkeypatch, "--engine", "pallas", "--cache-dir", cache)
    assert [r["recall_host"] for r in again] == [r["recall_host"] for r in first]
    # the JAX run's caches hold another corpus: refused, whichever the port reads first
    jax_cache = jax_curve[4]
    with pytest.raises(ValueError, match="corpus_generator"):
        _port_main(monkeypatch, "--engine", "xla", "--cache-dir", jax_cache)
    truth = pathlib.Path(jax_cache) / f"truth_{CURVE['rows']}_{CURVE['batch']}_{CURVE['k']}.npz"
    with pytest.raises(ValueError, match="corpus_generator"):
        prc.load_npz(truth, CPU)
    other = tmp_path / "other.npz"
    np.savez(other, truth=np.zeros(3), corpus_generator="another generator")
    with pytest.raises(ValueError, match="holds the corpus of 'another generator'"):
        prc.load_npz(other, CPU)
    broken = tmp_path / "broken.npz"
    broken.write_bytes(b"PK\x03\x04 truncated")
    assert prc.load_npz(broken, CPU) is None and not broken.exists()


def test_parse_eta_matches_the_jax_tool():
    from crs_tpu.ops.pq import aniso_eta_from_threshold
    from crs_tpu_torch.tools.pq_recall_curve import parse_eta

    assert parse_eta("0", 384) is None and parse_eta(" 1.0 ", 384) is None
    assert parse_eta("4.5", 384) == 4.5
    assert parse_eta("auto", 384) == pytest.approx(aniso_eta_from_threshold(0.2, 384), rel=1e-12)
