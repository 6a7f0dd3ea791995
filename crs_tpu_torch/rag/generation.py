"""RAG answer generation: prompting, cleaning, degenerate-answer retry (port
of ``crs_tpu.rag.generation``; host code around the model's batched
generate).

- sampling defaults: temperature 0.3, top-p 0.9, repetition penalty 1.15;
- the context is cut to ``max_context_chars`` at a sentence boundary;
- the instruct prompt uses the tokenizer's chat template when it has one,
  else ``[INST] … [/INST]``;
- answers lose "Answer:" prefixes and "Based on the context" boilerplate and
  are capped at ``max_answer_sentences`` sentences;
- a degenerate answer (a verbatim 10-gram of the context, fewer than 15
  words, or one half contained in the other) is retried once with a simpler
  prompt, all retries of a batch in one batched call.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, Optional, Sequence

from ..utils.sentences import split_sentences

logger = logging.getLogger(__name__)

__all__ = ["RAGGenerator"]


class RAGGenerator:
    def __init__(self, model_interface, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.model = model_interface
        self.max_new_tokens = int(config.get("max_new_tokens", 256))
        self.temperature = float(config.get("temperature", 0.3))
        self.top_p = float(config.get("top_p", 0.9))
        self.repetition_penalty = float(config.get("repetition_penalty", 1.15))
        self.max_context_chars = int(config.get("max_context_chars", 2000))
        self.max_answer_sentences = int(config.get("max_answer_sentences", 4))
        self.retry_on_problematic = bool(config.get("retry_on_problematic", True))

    # -- public -------------------------------------------------------------
    def generate(self, question: str, context: str = "") -> str:
        return self.generate_batch([question], [context])[0]

    def generate_batch(
        self, questions: Sequence[str], contexts: Optional[Sequence[str]] = None
    ) -> List[str]:
        contexts = contexts or [""] * len(questions)
        prompts = [
            self._format_instruct_prompt(q, self._truncate_context(c))
            for q, c in zip(questions, contexts)
        ]
        raw = self._model_generate(prompts)
        answers = [self._clean_answer(a) for a in raw]

        if self.retry_on_problematic:
            retry_idx = [
                i for i, (a, c) in enumerate(zip(answers, contexts))
                if self._is_problematic(a, c)
            ]
            if retry_idx:
                logger.info("retrying %d degenerate answers", len(retry_idx))
                simple = [
                    self._format_simple_prompt(questions[i], self._truncate_context(contexts[i]))
                    for i in retry_idx
                ]
                retried = self._model_generate(simple)
                for j, i in enumerate(retry_idx):
                    cleaned = self._clean_answer(retried[j])
                    if not self._is_problematic(cleaned, contexts[i]) or not answers[i]:
                        answers[i] = cleaned
        return answers

    def generate_without_context(self, question: str) -> str:
        return self.generate(question, "")

    # -- internals ----------------------------------------------------------
    def _model_generate(self, prompts: Sequence[str]) -> List[str]:
        if hasattr(self.model, "generate_batch"):
            return self.model.generate_batch(
                list(prompts),
                max_new_tokens=self.max_new_tokens,
                temperature=self.temperature,
                top_p=self.top_p,
                repetition_penalty=self.repetition_penalty,
            )
        return [
            self.model.generate(
                p,
                max_new_tokens=self.max_new_tokens,
                temperature=self.temperature,
                top_p=self.top_p,
                repetition_penalty=self.repetition_penalty,
            )
            for p in prompts
        ]

    def _truncate_context(self, context: str) -> str:
        """Cap context at max_context_chars, cutting at a sentence boundary."""
        if len(context) <= self.max_context_chars:
            return context
        cut = context[: self.max_context_chars]
        last = max(cut.rfind(". "), cut.rfind(".\n"), cut.rfind("! "), cut.rfind("? "))
        if last > self.max_context_chars // 2:
            cut = cut[: last + 1]
        return cut

    def _format_instruct_prompt(self, question: str, context: str) -> str:
        """Chat-template prompt with plain fallback."""
        if context.strip():
            user = (
                "Use the following context to answer the question. "
                "Answer concisely based only on the context.\n\n"
                f"Context:\n{context}\n\nQuestion: {question}"
            )
        else:
            user = question
        # real-checkpoint tokenizers expose the model's own chat template
        tok = getattr(self.model, "tokenizer", None)
        apply = getattr(tok, "apply_chat_template", None)
        if callable(apply):
            try:
                return apply(
                    [{"role": "user", "content": user}],
                    tokenize=False, add_generation_prompt=True,
                )
            except Exception:  # pragma: no cover - template-dependent
                pass
        return f"[INST] {user} [/INST]"

    def _format_simple_prompt(self, question: str, context: str) -> str:
        """The retry prompt: plainer phrasing."""
        if context.strip():
            return f"Context: {context}\n\nQuestion: {question}\nAnswer:"
        return f"Question: {question}\nAnswer:"

    def _clean_answer(self, answer: str) -> str:
        """Strip boilerplate, cap sentence count."""
        a = answer.strip()
        a = re.sub(r"^(answer|response)\s*[:\-]\s*", "", a, flags=re.I)
        a = re.sub(
            r"^(based on (the|this) (provided )?context,?\s*|according to the (provided )?context,?\s*)",
            "",
            a,
            flags=re.I,
        )
        a = a.strip()
        sentences = split_sentences(a)
        if len(sentences) > self.max_answer_sentences:
            a = " ".join(sentences[: self.max_answer_sentences])
        return a.strip()

    # honest fallback responses are never flagged
    _FALLBACK_PHRASES = (
        "not provided",
        "not in the context",
        "cannot answer",
        "insufficient information",
        "does not specify",
    )

    def _is_problematic(self, answer: str, context: str) -> bool:
        """Degenerate-answer checks:
        honest-fallback allowlist; verbatim 10-gram copy from context;
        too-short (<15 words); half-repetition via substring containment.
        """
        answer_lower = answer.lower()
        if any(p in answer_lower for p in self._FALLBACK_PHRASES):
            return False
        answer_clean = answer_lower.replace(".", "").replace(",", "").strip()
        context_clean = context.lower().replace(".", "").replace(",", "").strip()
        words = answer_clean.split()
        # verbatim copy: any 10-gram of the cleaned answer appears verbatim
        # in the cleaned context
        if context_clean:
            for i in range(len(words) - 10):
                gram = " ".join(words[i : i + 10])
                if gram in context_clean:
                    logger.warning("Answer contains long verbatim copy from context")
                    return True
        # too short (<15 words)
        if len(words) < 15:
            return True
        # self-repetition: one half contained in the other
        if len(words) >= 10:
            half = len(words) // 2
            first_half = " ".join(words[:half])
            second_half = " ".join(words[half:])
            if first_half in second_half or second_half in first_half:
                logger.warning("Answer contains repetition")
                return True
        return False
