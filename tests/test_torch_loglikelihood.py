"""The port's log-likelihood scoring, perplexity, multiple-choice tasks and
lm-eval adapter against ``crs_tpu``'s, on the CPU.

The ``tiny`` model, random init from one seed, as int8 and as int4. Its
int8 logits are bit-identical in both packages at every real position (the
XLA fusions are mirrored in ``models/transformer.py``); int4 at ≤ 64 rows
reaches ``q4_matmul`` in ``crs_tpu`` (in interpret mode here: the MLP's
down projection, K 256 → N 128) and the port's plain version, and its
logits differ by up to one bf16 step (2⁻⁶ measured). The log-softmax
differs too: XLA's ``exp`` / ``log`` and its order of sums against
torch's. So:
- a row's sum of log-probabilities: |port − crs_tpu| ≤ LL_RTOL·(1 + |sum|)
  (measured ≤ 3.1e-5 on sums of −60, below 1e-6 a token);
- ``is_greedy``: equal in every row where no scored position's top two
  logits lie within 2·d of each other, d the largest logit difference
  between the packages at the real positions (only such a tie can flip
  the argmax); at int8, d = 0 and every row is compared;
- perplexity: the same number of tokens and texts, ``avg_nll`` within
  LL_RTOL·(1 + |avg_nll|);
- multiple choice (acc, acc_norm) and the lm-eval harness scores through
  ``tests/stubs/lm_eval`` (new and old API): equal.
"""

import importlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
CORPUS = REPO / "results" / "selftrained" / "heldout_corpus.txt"
QA = REPO / "results" / "selftrained" / "heldout_qa.json"
STUBS = REPO / "tests" / "stubs"
LL_RTOL = 1e-5
SEED = 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def models():
    """{quantization: (crs_tpu's model, the port's model)} at ``tiny``."""
    from crs_tpu.models.model_interface import JaxModel

    from crs_tpu_torch.models.model_interface import TorchModel

    out = {}
    for q in ("int8", "int4"):
        conf = {"config": "tiny", "seed": SEED, "quantization": q}
        j, t = JaxModel(conf), TorchModel(conf, device="cpu")
        j.load()
        t.load()
        out[q] = (j, t)
    return out


def _close(got: float, ref: float) -> None:
    assert abs(got - ref) <= LL_RTOL * (1 + abs(ref)), (got, ref)


PAIRS = [("The quick brown fox", " jumps over the lazy dog"), ("Hello", " world, again"),
         ("", "a text scored from its second token"), ("Question: what is GPTQ?\nAnswer:",
                                                       " a post-training quantization method"),
         ("x" * 40, " y"), ("same", ""), ("Model compression", " reduces memory."),
         ("Retrieval augmented generation", " retrieves context first"),
         ("a", " b c d e f g h i j k l m n o p q r s t u v w x y z" * 2)]


def _batch(tokenizer, pairs, blen: int = 128):
    ids = np.zeros((len(pairs), blen), np.int64)
    mask = np.zeros((len(pairs), blen), bool)
    starts = np.zeros(len(pairs), np.int64)
    for row, (c, x) in enumerate(pairs):
        ctx, full = tokenizer.encode(c), tokenizer.encode(c + x)
        ids[row, :len(full)] = full
        mask[row, :len(full)] = True
        starts[row] = max(len(ctx), 1)
    return ids, mask, starts


def _clear_rows(ref_logits, got_logits, mask, starts):
    """Rows where no scored position's top-2 margin is within 2·d, d the
    largest |port − crs_tpu| logit difference at the real positions."""
    d = float(np.abs(ref_logits - got_logits).max(axis=-1)[mask].max())
    if d == 0:
        return np.ones(len(mask), bool)
    top2 = np.sort(ref_logits[:, :-1], axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    pos = np.arange(ref_logits.shape[1] - 1)[None]
    valid = (pos + 1 >= starts[:, None]) & mask[:, 1:] & mask[:, :-1]
    return ~np.any(valid & (margin <= 2 * d), axis=1)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_sequence_logprob_matches(models, quant):
    import jax.numpy as jnp

    from crs_tpu.models.model_interface import _sequence_logprob as jlp
    from crs_tpu.models.transformer import forward as jforward

    from crs_tpu_torch.models import model_interface as tmi
    from crs_tpu_torch.models.transformer import forward as tforward

    j, t = models[quant]
    ids, mask, starts = _batch(t.tokenizer, PAIRS)
    ref_lp, ref_g = (np.asarray(a) for a in jlp(j.params, j.cfg, jnp.asarray(ids, jnp.int32),
                                                 jnp.asarray(mask), jnp.asarray(starts, jnp.int32)))
    got_lp, got_g = tmi._sequence_logprob(t.params, t.cfg, torch.from_numpy(ids),
                                          torch.from_numpy(mask), torch.from_numpy(starts))
    assert got_lp.dtype == torch.float32 and got_g.dtype == torch.bool
    for g, r in zip(got_lp.tolist(), ref_lp.tolist()):
        _close(g, r)
    ref_logits = np.asarray(jforward(j.params, j.cfg, jnp.asarray(ids, jnp.int32),
                                     jnp.asarray(mask)))
    got_logits = tforward(t.params, t.cfg, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    clear = _clear_rows(ref_logits, got_logits, mask, starts)
    assert clear.all() if quant == "int8" else clear.any()
    assert np.array_equal(got_g.numpy()[clear], ref_g[clear])
    # a scalar start, and slices of rows smaller than the batch (the
    # log-sum-exp runs in slices of _LSE_ROWS rows)
    old = tmi._LSE_ROWS
    tmi._LSE_ROWS = 100
    try:
        got_s, _ = tmi._sequence_logprob(t.params, t.cfg, torch.from_numpy(ids),
                                         torch.from_numpy(mask), 3)
    finally:
        tmi._LSE_ROWS = old
    ref_s, _ = jlp(j.params, j.cfg, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
                   jnp.asarray(3, jnp.int32))
    for g, r in zip(got_s.tolist(), np.asarray(ref_s).tolist()):
        _close(g, r)


def test_is_greedy_is_the_argmax_chain(models):
    """is_greedy is True exactly for the continuation the model's argmax
    chain gives, and one changed token turns it False."""
    from crs_tpu_torch.models.model_interface import _sequence_logprob

    _, t = models["int8"]
    ids = [104, 101, 108, 108, 111]
    for _ in range(4):
        ids.append(int(t.forward(np.asarray([ids]))[0, -1].argmax()))
    arr = np.zeros((1, 32), np.int64)
    arr[0, :len(ids)] = ids
    mask = np.zeros((1, 32), bool)
    mask[0, :len(ids)] = True
    lp, greedy = _sequence_logprob(t.params, t.cfg, torch.from_numpy(arr),
                                   torch.from_numpy(mask), 5)
    assert bool(greedy[0])
    arr[0, 6] = (arr[0, 6] + 1) % t.cfg.vocab_size
    lp2, greedy2 = _sequence_logprob(t.params, t.cfg, torch.from_numpy(arr),
                                     torch.from_numpy(mask), 5)
    assert not bool(greedy2[0]) and float(lp[0]) > float(lp2[0])


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_get_loglikelihood_and_batches_match(models, quant):
    j, t = models[quant]
    for c, x in PAIRS[:4] + [("same", "")]:
        _close(t.get_loglikelihood(c, x), j.get_loglikelihood(c, x))
    got = t.get_loglikelihood_batch_scored(PAIRS)
    ref = j.get_loglikelihood_batch_scored(PAIRS)
    assert len(got) == len(ref) == len(PAIRS)
    for (gl, gg), (rl, rg) in zip(got, ref):
        _close(gl, rl)
        assert isinstance(gg, bool)
    if quant == "int8":  # identical logits: identical flags (int4's: the test above)
        assert [g for _, g in got] == [g for _, g in ref]
    assert t.get_loglikelihood_batch(PAIRS) == [ll for ll, _ in got]


def test_forward_device_stays_on_the_device(models):
    _, t = models["int8"]
    ids = np.asarray([[1, 2, 3, 4]])
    dev = t.forward_device(ids)
    assert isinstance(dev, torch.Tensor) and dev.device == t.device and dev.shape == (1, 4, 512)
    assert np.array_equal(t.forward(ids), dev.numpy())


@pytest.mark.parametrize("stride", [None, 48])
def test_perplexity_matches(models, stride):
    from crs_tpu.evaluation.performance.perplexity import PerplexityEvaluator as J

    from crs_tpu_torch.evaluation.performance.perplexity import PerplexityEvaluator as T

    j, t = models["int8"]
    cfg = {"dataset_path": str(CORPUS), "max_samples": 4, "max_length": 96, "stride": stride}
    got, ref = T(t, cfg).calculate(), J(j, cfg).calculate()
    assert got["num_tokens"] == ref["num_tokens"] and got["num_samples"] == ref["num_samples"] > 0
    assert got["mode"] == ref["mode"] and got["max_length"] == ref["max_length"]
    assert abs(got["avg_nll"] - ref["avg_nll"]) <= LL_RTOL * (1 + abs(ref["avg_nll"]))
    assert abs(got["perplexity"] / ref["perplexity"] - 1) <= 1e-4
    texts = {"texts": ["too short"], "max_length": 64}
    assert T(t, texts).calculate() == J(j, texts).calculate() == {"perplexity": None,
                                                                  "num_samples": 0}


def test_sequence_logprob_makes_no_second_logits_tensor(models, monkeypatch):
    """Scoring reads the logits through views: besides the forward's own
    [B, S, V] logits, no tensor of (B·(S−1)·V) elements or more is made
    (a non-contiguous [:, :-1] slice flattened by reshape would copy them
    all), and the sums equal those of the full log-softmax."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from crs_tpu_torch.models import model_interface as tmi

    _, t = models["int8"]
    ids, mask, starts = _batch(t.tokenizer, PAIRS[:4])
    ids, mask, starts = (torch.from_numpy(a) for a in (ids, mask, starts))
    logits = tmi.forward(t.params, t.cfg, ids, mask)
    b, s, v = logits.shape
    monkeypatch.setattr(tmi, "forward", lambda *a: logits)
    monkeypatch.setattr(tmi, "_LSE_ROWS", 8)  # slices of 8 rows, well below B·S

    class LargeTensors(TorchDispatchMode):
        made = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for x in tree_flatten(out)[0]:
                if isinstance(x, torch.Tensor) and x.numel() >= b * (s - 1) * v and \
                        x.untyped_storage().data_ptr() != logits.untyped_storage().data_ptr():
                    self.made.append(str(func))
            return out

    with LargeTensors():
        lp, greedy = tmi._sequence_logprob(t.params, t.cfg, ids, mask, starts)
    assert LargeTensors.made == []
    full = torch.log_softmax(logits[:, :-1], dim=-1).gather(2, ids[:, 1:, None])[..., 0]
    pos = torch.arange(s - 1)[None]
    valid = (pos + 1 >= starts[:, None]) & mask[:, 1:] & mask[:, :-1]
    torch.testing.assert_close(lp, (full * valid).sum(1), rtol=1e-6, atol=1e-5)
    ref_greedy = torch.where(valid, logits[:, :-1].argmax(-1) == ids[:, 1:], True).all(1)
    assert torch.equal(greedy, ref_greedy)


@pytest.mark.parametrize("fewshot", [0, 2])
def test_multiple_choice_task_matches(models, fewshot):
    from crs_tpu.evaluation.performance.tasks import build_corpus_qa_task as jb

    from crs_tpu_torch.evaluation.performance.tasks import build_corpus_qa_task as tb

    j, t = models["int8"]
    got = tb(str(QA)).evaluate(t, limit=6, num_fewshot=fewshot)
    ref = jb(str(QA)).evaluate(j, limit=6, num_fewshot=fewshot)
    assert got == ref and got["num_items"] == 6


def test_performance_benchmark_matches(models, tmp_path):
    from crs_tpu.evaluation.performance.benchmark import PerformanceBenchmark as J
    from crs_tpu.evaluation.performance.tasks import build_corpus_qa_task

    from crs_tpu_torch.evaluation.performance.benchmark import PerformanceBenchmark as T

    j, t = models["int8"]
    mc = tmp_path / "mc.json"
    mc.write_text(json.dumps(build_corpus_qa_task(str(QA)).items))
    cfg = {"perplexity": {"dataset_path": str(CORPUS), "max_samples": 2, "max_length": 64},
           "tasks": {"corpus_qa_mc": {"enabled": True, "dataset_path": str(mc)},
                     "winogrande": {"enabled": True}},  # a harness task: lm_eval absent
           "task_limit": 4}
    got, ref = T(t, cfg).run_all(), J(j, cfg).run_all()
    assert got.metrics["tasks"] == ref.metrics["tasks"]
    assert got.metrics["average_accuracy"] == ref.metrics["average_accuracy"]
    assert got.metrics["tasks"]["winogrande"]["skipped"] == "lm_eval unavailable"
    assert got.metrics["num_tokens"] == ref.metrics["num_tokens"]
    assert got.pretty().splitlines()[2:] == ref.pretty().splitlines()[2:]
    # corpus_qa_mc without data is skipped; with a qa_path it is built
    none = T(t, {"run_perplexity": False, "tasks": {"corpus_qa_mc": {"enabled": True}}}).run_all()
    assert none.metrics["tasks"]["corpus_qa_mc"]["skipped"] == "no local data"
    built = T(t, {"run_perplexity": False, "task_limit": 4,
                  "tasks": {"corpus_qa_mc": {"qa_path": str(QA)}}}).run_all()
    assert built.metrics["tasks"]["corpus_qa_mc"] == ref.metrics["tasks"]["corpus_qa_mc"]


@pytest.fixture()
def stub_lm_eval():
    """The stub lm_eval importable; sys.modules and sys.path restored after."""
    saved = {k: v for k, v in sys.modules.items() if k == "lm_eval" or k.startswith("lm_eval.")}
    for k in list(saved) + [k for k in sys.modules if "lm_eval_adapter" in k]:
        sys.modules.pop(k, None)
    sys.path.insert(0, str(STUBS))
    try:
        import lm_eval

        yield lm_eval
    finally:
        sys.path.remove(str(STUBS))
        for k in [k for k in sys.modules if k == "lm_eval" or k.startswith("lm_eval.")
                  or "lm_eval_adapter" in k]:
            sys.modules.pop(k)
        sys.modules.update(saved)


HARNESS_TASKS = {"arc_easy": {"enabled": True, "num_fewshot": 2, "limit": 1, "batch_size": 2},
                 "hellaswag": True, "boolq": {"enabled": False}, "lambada_openai": True,
                 "gsm8k": True, "winogrande": True}


@pytest.mark.parametrize("api", ["new", "old"])
def test_lm_eval_adapter_matches(models, stub_lm_eval, monkeypatch, api):
    # through sys.modules: the package attribute may hold a module of an earlier stub
    J = importlib.import_module("crs_tpu.evaluation.performance.lm_eval_adapter")
    T = importlib.import_module("crs_tpu_torch.evaluation.performance.lm_eval_adapter")
    j, t = models["int8"]
    if api == "old":
        monkeypatch.delattr(stub_lm_eval, "simple_evaluate")
    stub_lm_eval._CALLS.clear()
    got = T.run_lm_eval_harness(t, HARNESS_TASKS, limit=7)
    got_calls = list(stub_lm_eval._CALLS)
    stub_lm_eval._CALLS.clear()
    ref = J.run_lm_eval_harness(j, HARNESS_TASKS, limit=7)
    assert got == ref and set(got) == {"arc_easy", "hellaswag", "lambada_openai", "gsm8k"}
    assert got_calls == stub_lm_eval._CALLS
    assert all(kw["confirm_run_unsafe_code"] == (api == "new") for _, kw in got_calls)
    lm = t.get_lm_eval_model()
    assert isinstance(lm, T.TorchLM) and isinstance(lm, stub_lm_eval.LM)

    class Req:
        def __init__(self, *args):
            self.args = args

    reqs = [Req(c, x) for c, x in PAIRS[:3]]
    assert [g for _, g in lm.loglikelihood(reqs)] == [g for _, g in T.TorchLM(t).loglikelihood(reqs)]
    rolling = lm.loglikelihood_rolling([Req("a text scored whole")])
    _close(rolling[0], J.JaxLM(j).loglikelihood_rolling([Req("a text scored whole")])[0])
    gen = [Req("Q: 1+1? A:", {"until": ["\n", "Q"], "max_gen_toks": 6}),
           Req("Hello", {"until": "x"})]
    assert lm.generate_until(gen) == J.JaxLM(j).generate_until(gen)
    for name in ("parse_task_config", "get_metric_from_results"):
        assert getattr(T, name) is not None
    assert T.parse_task_config({"limit": 3}) == J.parse_task_config({"limit": 3})
    assert T.get_metric_from_results({"acc": {"mean": 0.5}}, "winogrande") == 0.5


def test_lm_eval_model_without_lm_eval(models, monkeypatch):
    _, t = models["int8"]
    monkeypatch.setitem(sys.modules, "lm_eval", None)  # import lm_eval raises ImportError
    monkeypatch.delitem(sys.modules, "crs_tpu_torch.evaluation.performance.lm_eval_adapter",
                        raising=False)
    with pytest.raises(NotImplementedError):
        t.get_lm_eval_model()
