"""Task registry and native multiple-choice evaluation (port of
``crs_tpu.evaluation.performance.tasks``).

The 23-task ``TASK_REGISTRY`` (metric, default few-shot count, category),
the presets, config validation and templates. A task runs through the
lm-eval harness (``lm_eval_adapter``) when ``lm_eval`` and its data are
there; a task with local data (a ``dataset_path`` of {query, choices,
gold} items, or ``corpus_qa_mc`` built from a QA file) is scored here as
lm-eval scores multiple choice: each choice's log-likelihood through the
model's batched scoring, acc and acc_norm.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = ["TASK_REGISTRY", "PRESETS", "MultipleChoiceTask", "build_corpus_qa_task", "validate_task_config"]

# name → {metric, num_fewshot, category}
TASK_REGISTRY: Dict[str, Dict[str, Any]] = {
    "hellaswag": {"metric": "acc_norm", "num_fewshot": 0, "category": "commonsense"},
    "arc_easy": {"metric": "acc_norm", "num_fewshot": 0, "category": "commonsense"},
    "arc_challenge": {"metric": "acc_norm", "num_fewshot": 0, "category": "commonsense"},
    "winogrande": {"metric": "acc", "num_fewshot": 0, "category": "commonsense"},
    "piqa": {"metric": "acc_norm", "num_fewshot": 0, "category": "commonsense"},
    "openbookqa": {"metric": "acc_norm", "num_fewshot": 0, "category": "commonsense"},
    "boolq": {"metric": "acc", "num_fewshot": 0, "category": "knowledge"},
    "mmlu": {"metric": "acc", "num_fewshot": 5, "category": "knowledge"},
    "triviaqa": {"metric": "exact_match", "num_fewshot": 5, "category": "knowledge"},
    "nq_open": {"metric": "exact_match", "num_fewshot": 5, "category": "knowledge"},
    "truthfulqa_mc2": {"metric": "acc", "num_fewshot": 0, "category": "knowledge"},
    "gsm8k": {"metric": "exact_match", "num_fewshot": 5, "category": "math"},
    "math_qa": {"metric": "acc_norm", "num_fewshot": 0, "category": "math"},
    "arithmetic": {"metric": "acc", "num_fewshot": 0, "category": "math"},
    "minerva_math": {"metric": "exact_match", "num_fewshot": 4, "category": "math"},
    "humaneval": {"metric": "pass@1", "num_fewshot": 0, "category": "code"},
    "mbpp": {"metric": "pass@1", "num_fewshot": 3, "category": "code"},
    "lambada_openai": {"metric": "acc", "num_fewshot": 0, "category": "language"},
    "wikitext": {"metric": "word_perplexity", "num_fewshot": 0, "category": "language"},
    "anli": {"metric": "acc", "num_fewshot": 0, "category": "reasoning"},
    "logiqa": {"metric": "acc_norm", "num_fewshot": 0, "category": "reasoning"},
    "sciq": {"metric": "acc_norm", "num_fewshot": 0, "category": "reasoning"},
    "corpus_qa_mc": {"metric": "acc", "num_fewshot": 0, "category": "retrieval", "local": True},
}

# Reference lm_eval_utils presets (:107-142)
PRESETS: Dict[str, List[str]] = {
    "baseline": ["hellaswag", "arc_easy", "arc_challenge", "humaneval"],
    "standard": ["hellaswag", "arc_easy", "arc_challenge", "winogrande", "piqa", "boolq"],
    "comprehensive": [
        "hellaswag", "arc_easy", "arc_challenge", "winogrande", "piqa", "boolq",
        "mmlu", "gsm8k", "humaneval", "truthfulqa_mc2",
    ],
    "reasoning": ["anli", "logiqa", "sciq"],
    "knowledge": ["boolq", "mmlu", "triviaqa", "nq_open"],
    "math_code": ["gsm8k", "math_qa", "humaneval", "mbpp"],
    "quick_test": ["arc_easy", "corpus_qa_mc"],
    "offline": ["corpus_qa_mc"],
}


def validate_task_config(tasks_cfg: Dict[str, Any]) -> List[str]:
    """Warn-and-filter unknown tasks."""
    valid = []
    for name, cfg in tasks_cfg.items():
        if name not in TASK_REGISTRY:
            logger.warning("unknown task %r — skipping", name)
            continue
        if isinstance(cfg, dict) and not cfg.get("enabled", True):
            continue
        valid.append(name)
    return valid


class MultipleChoiceTask:
    """Native loglikelihood-ranking evaluation (the lm-eval MC mechanism)."""

    def __init__(self, name: str, items: Sequence[Dict[str, Any]], metric: str = "acc"):
        self.name = name
        self.items = list(items)
        self.metric = metric

    @classmethod
    def from_file(cls, name: str, path: str, metric: str = "acc") -> "MultipleChoiceTask":
        with open(path) as f:
            items = json.load(f)
        return cls(name, items, metric)

    def evaluate(
        self, model, limit: Optional[int] = None, num_fewshot: int = 0
    ) -> Dict[str, Any]:
        items = self.items[: int(limit)] if limit else self.items
        if not items:
            return {"task": self.name, "metric": self.metric, "score": None, "num_items": 0}
        # few-shot prefix from held-out trailing items (lm-eval convention:
        # exemplars show the correct answer)
        prefix = ""
        if num_fewshot > 0:
            pool = [it for it in self.items if it not in items][:num_fewshot]
            if len(pool) < num_fewshot:
                pool = self.items[-num_fewshot:]
            prefix = "\n\n".join(
                f"{ex['query']} {ex['choices'][int(ex['gold'])]}" for ex in pool
            ) + "\n\n"
        # batched scoring: one device call per length bucket, not per choice
        pairs = [
            (prefix + item["query"], " " + c.lstrip())
            for item in items for c in item["choices"]
        ]
        flat = model.get_loglikelihood_batch(pairs)
        correct = correct_norm = 0
        cursor = 0
        for item in items:
            choices = item["choices"]
            gold = int(item["gold"])
            lls = flat[cursor : cursor + len(choices)]
            cursor += len(choices)
            if int(max(range(len(lls)), key=lambda i: lls[i])) == gold:
                correct += 1
            # length-normalized (acc_norm): divide by continuation chars
            norm = [ll / max(len(c), 1) for ll, c in zip(lls, choices)]
            if int(max(range(len(norm)), key=lambda i: norm[i])) == gold:
                correct_norm += 1
        acc = correct / len(items)
        acc_norm = correct_norm / len(items)
        return {
            "task": self.name,
            "metric": self.metric,
            "score": acc_norm if self.metric == "acc_norm" else acc,
            "acc": acc,
            "acc_norm": acc_norm,
            "num_items": len(items),
        }


def generate_config_template(preset: str = "standard") -> Dict[str, Any]:
    """Config template for a preset's tasks."""
    if preset not in PRESETS:
        raise ValueError(f"unknown preset: {preset} (known: {sorted(PRESETS)})")
    return {
        name: {
            "enabled": True,
            "num_fewshot": TASK_REGISTRY[name]["num_fewshot"],
            "limit": 50,
            "metric": TASK_REGISTRY[name]["metric"],
        }
        for name in PRESETS[preset]
    }


def main(argv=None) -> int:
    """Task-utility CLI."""
    import argparse

    ap = argparse.ArgumentParser(description="Task registry utilities")
    ap.add_argument("--list", action="store_true", help="list all tasks")
    ap.add_argument("--presets", action="store_true", help="list presets")
    ap.add_argument("--template", metavar="PRESET", help="print a config template")
    args = ap.parse_args(argv)
    if args.list:
        for name, info in sorted(TASK_REGISTRY.items()):
            print(f"{name:18s} metric={info['metric']:16s} fewshot={info['num_fewshot']} "
                  f"category={info['category']}")
    elif args.presets:
        for name, tasks in PRESETS.items():
            print(f"{name}: {', '.join(tasks)}")
    elif args.template:
        print(json.dumps(generate_config_template(args.template), indent=2))
    else:
        print(f"{len(TASK_REGISTRY)} tasks, {len(PRESETS)} presets (--list / --presets / --template)")
    return 0


def build_corpus_qa_task(
    qa_path: Optional[str] = None,
    num_choices: int = 4,
    seed: int = 0,
) -> Optional[MultipleChoiceTask]:
    """Deterministic MC task from a QA file (a list of {question, answer}):
    the correct answer against distractor answers drawn from the other
    questions, by ``random.Random(seed)`` (``crs_tpu``'s draws). None when
    no file is given or it does not exist."""
    if not qa_path or not os.path.exists(qa_path):
        return None
    import random

    with open(qa_path) as f:
        qa = json.load(f)
    rng = random.Random(seed)
    items = []
    for i, item in enumerate(qa):
        others = [q["answer"] for j, q in enumerate(qa) if j != i]
        distractors = rng.sample(others, min(num_choices - 1, len(others)))
        choices = distractors + [item["answer"]]
        rng.shuffle(choices)
        items.append(
            {
                "query": f"Question: {item['question']}\nAnswer:",
                "choices": choices,
                "gold": choices.index(item["answer"]),
            }
        )
    return MultipleChoiceTask("corpus_qa_mc", items)
