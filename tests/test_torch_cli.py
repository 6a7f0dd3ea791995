"""The port's config, logging and command line against ``crs_tpu``'s, on the CPU.

- ``ConfigLoader``: the same default tree, the same merge of
  ``config.json``, dotted lookups, section getters, updates and save.
- The logging presets: levels, handlers, a log file, quiet library loggers.
- ``python -m crs_tpu_torch`` (``main`` called in-process with
  ``--device cpu``) against the repository's ``main.py`` (also in-process,
  not edited), each on its own temporary copy of ``config.json`` and of
  ``vector_db/``: ``--no-model --query`` prints the same chunks (the same
  pages and texts, scores within 1e-3 as printed to three decimals), and
  ``--index`` writes only to the configured directory, whose index then
  answers as ``main.py``'s does. ``vector_db/`` itself is never written.
"""

import hashlib
import json
import logging
import re
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def root_logger():
    """The root logger's handlers and level, restored after the test."""
    root = logging.getLogger()
    saved = (list(root.handlers), root.level)
    yield root
    for h in list(root.handlers):
        root.removeHandler(h)
        if h not in saved[0]:
            h.close()
    for h in saved[0]:
        root.addHandler(h)
    root.setLevel(saved[1])


# -- ConfigLoader ------------------------------------------------------------------

def test_default_config_equals_crs_tpu():
    from crs_tpu.utils.config import DEFAULT_CONFIG as JDEFAULT, ConfigLoader as JLoader
    from crs_tpu_torch.utils.config import DEFAULT_CONFIG, ConfigLoader

    assert DEFAULT_CONFIG == JDEFAULT
    assert ConfigLoader().config == JLoader().config
    assert ConfigLoader().config is not DEFAULT_CONFIG  # a copy: updates never reach the default


def test_config_json_loads_like_crs_tpu(tmp_path):
    from crs_tpu.utils.config import ConfigLoader as JLoader
    from crs_tpu_torch.utils.config import ConfigLoader

    path = str(REPO / "config.json")
    got, ref = ConfigLoader(path), JLoader(path)
    assert got.config == ref.config
    for key in ("rag.embedding.backend", "rag.vector_store.block_size", "rag.retrieval.top_k",
                "model.type", "nope.missing", "rag.embedding.backend.deeper"):
        assert got.get(key) == ref.get(key)
    assert got.get("nope", 5) == 5 and got.get("rag.embedding.backend") == "lexical"
    for name in ("get_model_config", "get_rag_config", "get_evaluation_config",
                 "get_efficiency_config", "get_performance_config", "get_retrieval_config",
                 "get_finetuning_config"):
        assert getattr(got, name)() == getattr(ref, name)()
    got.update_config("rag.vector_store.persist_directory", str(tmp_path / "vdb"))
    got.update_config("new.section.value", 3)
    assert got.get("new.section.value") == 3
    with pytest.raises(TypeError):
        got.update_config("rag.embedding.backend.deeper", 1)
    out = tmp_path / "sub" / "saved.json"
    got.save_config(str(out))
    again = ConfigLoader(str(out))
    assert again.config == got.config
    with pytest.raises(ValueError):
        ConfigLoader().save_config()
    with pytest.raises(FileNotFoundError):
        ConfigLoader(str(tmp_path / "absent.json"))


# -- logging presets ----------------------------------------------------------------

def test_logging_presets(root_logger, tmp_path):
    from crs_tpu_torch.utils import logging_setup as ls

    log_file = tmp_path / "run.log"
    root = ls.setup_logging(level=logging.INFO, log_file=str(log_file))
    assert root is root_logger and root.level == logging.INFO
    assert [type(h) for h in root.handlers] == [logging.StreamHandler, logging.FileHandler]
    logging.getLogger("crs_tpu_torch.test").info("to the file")
    for h in root.handlers:
        h.flush()
    assert "to the file" in log_file.read_text()
    for name in ("torch", "torch._dynamo", "urllib3"):
        assert logging.getLogger(name).level == logging.WARNING
    assert ls.setup_for_development().level == logging.DEBUG
    assert len(root.handlers) == 1  # each call replaces the handlers
    assert ls.setup_for_production().level == logging.WARNING
    assert ls.setup_for_benchmarking().level == logging.INFO
    ls.setup_for_notebook()
    assert root.handlers[0].formatter._fmt == "%(levelname)s %(message)s"


# -- the command line ----------------------------------------------------------------

def _tree_digest(path: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(path.rglob("*")):
        h.update(str(p.relative_to(path)).encode())
        if p.is_file():
            h.update(p.read_bytes())
    return h.hexdigest()


def _config_copy(tmp_path: Path, name: str, persist: Path) -> str:
    cfg = json.loads((REPO / "config.json").read_text())
    cfg["rag"]["vector_store"]["persist_directory"] = str(persist)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


_CHUNK_LINE = re.compile(r"^  \[(-?\d+\.\d{3})\] (p-?\w+: .*)$")


def _chunks(out: str):
    lines = [_CHUNK_LINE.match(line) for line in out.splitlines()]
    return [(float(m.group(1)), m.group(2)) for m in lines if m]


def _run_port(argv, capsys):
    from crs_tpu_torch.__main__ import main

    rc = main(argv + ["--device", "cpu"])
    return rc, capsys.readouterr().out


def _run_main_py(argv, capsys):
    sys.path.insert(0, str(REPO))
    try:
        import main as main_py
    finally:
        sys.path.remove(str(REPO))
    rc = main_py.main(argv)
    return rc, capsys.readouterr().out


QUERIES = ["What is GPTQ?", "How does knowledge distillation work?", "pruning"]


def _assert_same_chunks(got, ref):
    assert [t for _, t in got] == [t for _, t in ref]
    assert all(abs(a - b) <= 1e-3 for (a, _), (b, _) in zip(got, ref))


def test_cli_query_on_vector_db_equals_main_py(tmp_path, capsys, root_logger):
    before = _tree_digest(REPO / "vector_db")
    shutil.copytree(REPO / "vector_db", tmp_path / "port_vdb")
    shutil.copytree(REPO / "vector_db", tmp_path / "ref_vdb")
    port_cfg = _config_copy(tmp_path, "port", tmp_path / "port_vdb")
    ref_cfg = _config_copy(tmp_path, "ref", tmp_path / "ref_vdb")
    for q in QUERIES:
        rc, out = _run_port(["--config", port_cfg, "--no-model", "--query", q], capsys)
        ref_rc, ref_out = _run_main_py(["--config", ref_cfg, "--no-model", "--query", q], capsys)
        assert rc == ref_rc == 0
        got = _chunks(out)
        # "pruning" is no question: both answer without retrieving
        assert (len(got) > 0) == (q != "pruning")
        _assert_same_chunks(got, _chunks(ref_out))
        assert out.rstrip().endswith("answer: None")
    assert _tree_digest(REPO / "vector_db") == before
    assert _tree_digest(tmp_path / "port_vdb") == _tree_digest(REPO / "vector_db")


def test_cli_index_writes_only_its_directory(tmp_path, capsys, root_logger):
    before = _tree_digest(REPO / "vector_db")
    corpus = str(REPO / "results" / "selftrained" / "heldout_corpus.txt")
    work = tmp_path / "work"
    work.mkdir()
    port_cfg = _config_copy(tmp_path, "port", work / "port_index")
    ref_cfg = _config_copy(tmp_path, "ref", tmp_path / "ref_index")
    rc, out = _run_port(["--config", port_cfg, "--no-model", "--index", corpus], capsys)
    assert rc == 0 and re.match(r"indexed \d+ chunks in [\d.]+s", out.strip().splitlines()[-1])
    assert sorted(p.name for p in work.rglob("*")) == [
        "index_arrays.npz", "index_meta.json", "lexical_state.npz", "port_index"]
    ref_rc, ref_out = _run_main_py(["--config", ref_cfg, "--no-model", "--index", corpus], capsys)
    assert ref_rc == 0 and out.split(" in ")[0] == ref_out.split(" in ")[0]
    for q in QUERIES[:2]:
        _, out = _run_port(["--config", port_cfg, "--no-model", "--query", q], capsys)
        _, ref_out = _run_main_py(["--config", ref_cfg, "--no-model", "--query", q], capsys)
        assert _chunks(out)
        _assert_same_chunks(_chunks(out), _chunks(ref_out))
    assert _tree_digest(REPO / "vector_db") == before


def test_cli_refuses_what_it_does_not_serve(tmp_path, capsys, root_logger):
    from crs_tpu_torch.__main__ import main, should_retrieve

    for flag in ("--evaluate", "--eval-efficiency", "--eval-performance", "--eval-retrieval"):
        with pytest.raises(NotImplementedError, match="evaluation"):
            main([flag, "--device", "cpu"])
    assert main(["--config", str(tmp_path / "absent.json"), "--device", "cpu"]) == 2
    assert "config file not found" in capsys.readouterr().err
    cfg = _config_copy(tmp_path, "empty", tmp_path / "empty_index")
    assert main(["--config", cfg, "--device", "cpu", "--no-model"]) == 1  # nothing to do: help
    rc, out = _run_port(["--config", cfg, "--no-model", "--query", "What is GPTQ?"], capsys)
    assert rc == 0 and "no index loaded" in out and not _chunks(out)
    assert should_retrieve("Explain GPTQ") and should_retrieve("gptq?")
    assert not should_retrieve("GPTQ")


def test_cli_loads_config_json_s_model_on_the_cpu(tmp_path, capsys, root_logger):
    """Without ``--no-model`` the CLI loads ``config.json``'s model (int8,
    ``small``, random init) through ``create_model_interface`` and answers."""
    shutil.copytree(REPO / "vector_db", tmp_path / "vdb")
    cfg = json.loads((REPO / "config.json").read_text())
    cfg["rag"]["vector_store"]["persist_directory"] = str(tmp_path / "vdb")
    cfg["rag"]["generation"]["max_new_tokens"] = 4
    path = tmp_path / "model.json"
    path.write_text(json.dumps(cfg))
    rc, out = _run_port(["--config", str(path), "--query", "What is GPTQ?"], capsys)
    assert rc == 0 and _chunks(out)
    answer = out.rstrip().splitlines()[-1]
    assert answer.startswith("answer:") and answer != "answer: None"
