"""Code-generation dataset loaders (port of
``crs_tpu.finetuning.code_generation``).

HumanEval (eval-only, metadata keeps the tests and entry point), MBPP
(train / test with the first three test examples inlined), CodeAlpaca-20k
(90/10 split), CodeContests (difficulty filter, 80/20), and the factory.

All HF-hub loaders are gated on dataset availability (zero-egress images have
no cache); each loader also accepts a local JSON file via config
``data_path`` — a list of {instruction, input, output} — and there is a
deterministic synthetic dataset for offline training tests.
"""

from __future__ import annotations

import json
import logging
import os
import random
from typing import Any, Dict, List, Optional

from .base import BaseDatasetLoader, DatasetSample

logger = logging.getLogger(__name__)

__all__ = [
    "HumanEvalLoader", "MBPPLoader", "CodeAlpacaLoader", "CodeContestsLoader",
    "SyntheticCodeLoader", "LocalJSONLoader", "create_code_dataset_loader",
]


def _local_samples(path: str) -> List[DatasetSample]:
    with open(path) as f:
        data = json.load(f)
    return [
        DatasetSample(
            instruction=d.get("instruction", ""),
            input=d.get("input", ""),
            output=d.get("output", ""),
            category="code_generation",
            metadata={k: v for k, v in d.items() if k not in ("instruction", "input", "output")},
        )
        for d in data
    ]


def _hf(name: str, *args, **kw):
    os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    from datasets import load_dataset  # type: ignore

    return load_dataset(name, *args, **kw)


class LocalJSONLoader(BaseDatasetLoader):
    name = "local_json"
    category = "code_generation"

    def load(self):
        path = self.config["data_path"]
        samples = _local_samples(path)
        split = self.config.get("eval_split", 0.1)
        n_eval = max(1, int(len(samples) * split)) if len(samples) > 1 else 0
        return samples[: len(samples) - n_eval], samples[len(samples) - n_eval :]


class SyntheticCodeLoader(BaseDatasetLoader):
    """Deterministic synthetic instruction-code pairs (offline default)."""

    name = "synthetic_code"
    category = "code_generation"

    _TEMPLATES = [
        ("Write a function that adds {a} to its argument.",
         "def add_{a}(x):\n    return x + {a}\n"),
        ("Write a function that multiplies its argument by {a}.",
         "def mul_{a}(x):\n    return x * {a}\n"),
        ("Write a function that returns the string '{w}'.",
         "def get_{w}():\n    return '{w}'\n"),
        ("Write a function that checks whether its argument equals {a}.",
         "def is_{a}(x):\n    return x == {a}\n"),
    ]
    _WORDS = ["alpha", "beta", "gamma", "delta", "omega"]

    def load(self):
        n = int(self.config.get("num_samples", 64))
        rng = random.Random(int(self.config.get("seed", 0)))
        samples = []
        for _ in range(n):
            t_instr, t_out = rng.choice(self._TEMPLATES)
            sub = {"a": rng.randint(1, 99), "w": rng.choice(self._WORDS)}
            samples.append(
                DatasetSample(
                    instruction=t_instr.format(**sub),
                    output=t_out.format(**sub),
                    category="code_generation",
                )
            )
        n_eval = max(1, n // 10)
        return samples[:-n_eval], samples[-n_eval:]


class HumanEvalLoader(BaseDatasetLoader):
    name = "humaneval"
    category = "code_generation"

    def load(self):
        if self.config.get("data_path"):
            samples = _local_samples(self.config["data_path"])
            return [], samples  # eval-only by default
        try:
            ds = _hf("openai_humaneval", split="test")
        except Exception as e:
            logger.warning("humaneval unavailable offline: %s", e)
            return [], []
        samples = [
            DatasetSample(
                instruction="Complete the following Python function.",
                input=r["prompt"],
                output=r["canonical_solution"],
                category="code_generation",
                metadata={"test": r["test"], "entry_point": r["entry_point"], "task_id": r["task_id"]},
            )
            for r in ds
        ]
        return [], samples


class MBPPLoader(BaseDatasetLoader):
    name = "mbpp"
    category = "code_generation"

    def load(self):
        if self.config.get("data_path"):
            return LocalJSONLoader(self.config).load()
        try:
            train = _hf("mbpp", split="train")
            test = _hf("mbpp", split="test")
        except Exception as e:
            logger.warning("mbpp unavailable offline: %s", e)
            return [], []

        def convert(rows):
            out = []
            for r in rows:
                tests = "\n".join(r.get("test_list", [])[:3])  # the first three inline
                out.append(
                    DatasetSample(
                        instruction=r["text"],
                        input=f"Your code should pass these tests:\n{tests}" if tests else "",
                        output=r["code"],
                        category="code_generation",
                        metadata={"task_id": r.get("task_id")},
                    )
                )
            return out

        return convert(train), convert(test)


class CodeAlpacaLoader(BaseDatasetLoader):
    name = "code_alpaca"
    category = "code_generation"

    def load(self):
        if self.config.get("data_path"):
            return LocalJSONLoader(self.config).load()
        try:
            ds = _hf("sahil2801/CodeAlpaca-20k", split="train")
        except Exception as e:
            logger.warning("code_alpaca unavailable offline: %s", e)
            return [], []
        samples = [
            DatasetSample(
                instruction=r["instruction"], input=r.get("input", ""),
                output=r["output"], category="code_generation",
            )
            for r in ds
        ]
        n_eval = len(samples) // 10  # 90/10
        return samples[:-n_eval], samples[-n_eval:]


class CodeContestsLoader(BaseDatasetLoader):
    name = "code_contests"
    category = "code_generation"

    def load(self):
        if self.config.get("data_path"):
            return LocalJSONLoader(self.config).load()
        try:
            ds = _hf("deepmind/code_contests", split="train")
        except Exception as e:
            logger.warning("code_contests unavailable offline: %s", e)
            return [], []
        max_difficulty = self.config.get("max_difficulty")
        samples = []
        for r in ds:
            if max_difficulty is not None and r.get("difficulty", 0) > max_difficulty:
                continue
            sols = r.get("solutions", {}).get("solution", [])
            if not sols:
                continue
            samples.append(
                DatasetSample(
                    instruction=r["description"][:2000], output=sols[0][:4000],
                    category="code_generation",
                    metadata={"difficulty": r.get("difficulty")},
                )
            )
        n_eval = max(1, len(samples) // 5)  # 80/20
        return samples[:-n_eval], samples[-n_eval:]


_LOADERS = {
    "humaneval": HumanEvalLoader,
    "mbpp": MBPPLoader,
    "code_alpaca": CodeAlpacaLoader,
    "code_contests": CodeContestsLoader,
    "synthetic": SyntheticCodeLoader,
    "local_json": LocalJSONLoader,
}


def create_code_dataset_loader(name: str, config: Optional[Dict[str, Any]] = None) -> BaseDatasetLoader:
    """A loader by name."""
    if name not in _LOADERS:
        raise ValueError(f"unknown code dataset: {name} (known: {sorted(_LOADERS)})")
    return _LOADERS[name](config)
