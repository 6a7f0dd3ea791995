"""LoRA finetuning with evaluation in the loop (port of
``crs_tpu.finetuning.trainer``).

- ``EvaluationCallback``: after each epoch, an ``EvaluationRunner`` into
  ``epoch_N/``, the best metric and epoch (by the metric's direction), and
  ``evaluation_history.json``.
- ``QuantizedModelFinetuner``: LoRA (r 16, α 32 on the seven projections)
  over the frozen, possibly quantized base; instruction prompts tokenized
  into fixed-shape batches; the masked next-token cross-entropy; the
  optimizer chain of ``crs_tpu`` (frozen gradients zeroed, the global-norm
  clip over the adapters, AdamW with decoupled weight decay under a linear
  warmup and cosine decay); checkpoints in ``crs_tpu``'s layout
  (``checkpoint-<step>/adapters.npz`` + ``manifest.json``, pruned to
  ``save_total_limit``), resume from the highest one, ``save_model`` and a
  time estimate.

The step runs eagerly: the loss, ``backward()`` and the update. The update
is optax's arithmetic written out: the moments are kept in the adapters'
dtype (bf16), each op rounded to it, its constants rounded to it first, as
JAX rounds a Python scalar against a bf16 array. The global norm sums each
gradient's squares in f32, rounds the sum to the gradient's dtype and adds
the sums in bf16, or in f32 over a quantized base (whose frozen f32 zero
gradients come first in optax's sum). The schedule is optax's
``warmup_cosine_decay_schedule`` in closed form, its count starting at 0:
the first update's rate is 0.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..evaluation.base import higher_is_better
from ..models.transformer import forward
from .base import BaseDatasetLoader, DatasetSample
from .lora import LoRAWeight, adapter_tensors, add_lora, extract_lora, lora_nodes

logger = logging.getLogger(__name__)

__all__ = ["EvaluationCallback", "QuantizedModelFinetuner", "warmup_cosine_lr", "masked_loss"]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class EvaluationCallback:
    """Per-epoch benchmark runs with best-model tracking."""

    def __init__(
        self,
        model_interface,
        pipeline=None,
        eval_config: Optional[Dict[str, Any]] = None,
        output_dir: str = "finetune_eval",
        metric: str = "perplexity",
        benchmarks: Sequence[str] = ("performance",),
    ):
        self.model = model_interface
        self.pipeline = pipeline
        self.eval_config = eval_config or {}
        self.output_dir = output_dir
        self.metric = metric
        self.benchmarks = tuple(benchmarks)
        self.history: List[Dict[str, Any]] = []
        self.best_value: Optional[float] = None
        self.best_epoch: Optional[int] = None

    def on_epoch_end(self, epoch: int) -> Dict[str, Any]:
        from ..evaluation.runner import EvaluationRunner

        out_dir = os.path.join(self.output_dir, f"epoch_{epoch}")
        runner = EvaluationRunner(
            model=self.model, pipeline=self.pipeline,
            config=self.eval_config, output_dir=out_dir,
        )
        res = runner.run_all(
            run_efficiency="efficiency" in self.benchmarks,
            run_performance="performance" in self.benchmarks,
            run_retrieval="retrieval" in self.benchmarks,
        )
        summary = res.get_summary()
        value = summary.get(self.metric)
        entry = {"epoch": epoch, "metric": self.metric, "value": value, "summary": summary}
        self.history.append(entry)
        self._update_best(epoch, value)
        self._persist()
        return entry

    def _update_best(self, epoch: int, value: Optional[float]) -> None:
        if value is None:
            return
        hib = higher_is_better(self.metric)
        better = (
            self.best_value is None
            or (hib is not False and value > self.best_value)
            or (hib is False and value < self.best_value)
        )
        if better:
            self.best_value, self.best_epoch = value, epoch
            logger.info("new best %s=%.4f at epoch %d", self.metric, value, epoch)

    def _persist(self) -> None:
        os.makedirs(self.output_dir, exist_ok=True)
        with open(os.path.join(self.output_dir, "evaluation_history.json"), "w") as f:
            json.dump(
                {
                    "history": self.history,
                    "best_metric": self.metric,
                    "best_value": self.best_value,
                    "best_epoch": self.best_epoch,
                },
                f, indent=2, default=str,
            )


def warmup_cosine_lr(count: int, peak: float, warmup: int, total: int) -> float:
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup, total)`` at
    update ``count`` (from 0), in f32 as optax computes it: peak·count /
    warmup during the warmup, then peak·½(1 + cos(π·t / (total − warmup)))
    with t = min(count − warmup, total − warmup)."""
    if total - warmup <= 0:
        raise ValueError(f"the cosine decay needs total > warmup, got {total} and {warmup}")
    f32 = np.float32
    if count < warmup:
        frac = f32(1) - f32(count) / f32(warmup)
        return float(f32(-peak) * frac + f32(peak))
    steps = f32(total - warmup)
    t = min(f32(count - warmup), steps)
    return float(f32(peak) * (f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / steps))))


def masked_loss(logits: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Next-token softmax cross-entropy (optax's
    ``softmax_cross_entropy_with_integer_labels``: the row max taken out
    without a gradient) summed over the positions where a token and the one
    before it are real, over max(their count, 1)."""
    lg = logits[:, :-1, :]
    shifted = lg - lg.amax(dim=-1, keepdim=True).detach()
    label = torch.gather(shifted, -1, ids[:, 1:, None])[..., 0]
    losses = torch.log(torch.exp(shifted).sum(dim=-1)) - label
    valid = mask[:, 1:] & mask[:, :-1]
    return (losses * valid).sum() / torch.clamp_min(valid.sum(), 1)


def _as(x: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to ``dtype``: what JAX makes of a weak-typed
    scalar against an array of that dtype."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


class _AdamW:
    """optax's ``clip_by_global_norm`` then ``adamw`` over the adapters,
    op by op in their dtype; moments restart at zero with the count.
    ``norm_dtype``: the dtype the global norm's per-tensor sums are added
    in."""

    def __init__(self, tensors: Sequence[torch.Tensor], schedule, weight_decay: float,
                 max_norm: float, norm_dtype: torch.dtype = torch.bfloat16):
        self.tensors = list(tensors)
        self.schedule, self.weight_decay, self.max_norm = schedule, weight_decay, max_norm
        self.norm_dtype = norm_dtype
        self.mu = [torch.zeros_like(t, requires_grad=False) for t in self.tensors]
        self.nu = [torch.zeros_like(t, requires_grad=False) for t in self.tensors]
        self.count = 0

    @torch.no_grad()
    def step(self) -> float:
        """Apply one update from the tensors' ``.grad``; returns the rate."""
        grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in self.tensors]
        total = torch.zeros((), dtype=self.norm_dtype, device=grads[0].device)
        for g in grads:
            total = total + torch.sum(torch.square(g.float())).to(g.dtype)
        norm = torch.sqrt(total)
        if not bool(norm < self.max_norm):
            grads = [(g / norm.to(g.dtype)) * _as(self.max_norm, g.dtype) for g in grads]
        self.count += 1
        f32 = np.float32
        bc1 = f32(1) - f32(ADAM_B1) ** f32(self.count)
        bc2 = f32(1) - f32(ADAM_B2) ** f32(self.count)
        lr = self.schedule(self.count - 1)
        for p, g, mu, nu in zip(self.tensors, grads, self.mu, self.nu):
            dt = p.dtype
            mu.copy_(g * _as(1 - ADAM_B1, dt) + mu * _as(ADAM_B1, dt))
            nu.copy_((g * g) * _as(1 - ADAM_B2, dt) + nu * _as(ADAM_B2, dt))
            mu_hat = mu / _as(float(bc1), dt)
            nu_hat = nu / _as(float(bc2), dt)
            upd = mu_hat / (torch.sqrt(nu_hat) + _as(ADAM_EPS, dt))
            upd = upd + p * _as(self.weight_decay, dt)
            p.copy_(p + upd * _as(-lr, dt))
        return lr


class QuantizedModelFinetuner:
    def __init__(self, model_interface, config: Optional[Dict[str, Any]] = None):
        self.model = model_interface
        cfg = config or {}
        self.rank = int(cfg.get("lora_rank", 16))
        self.alpha = float(cfg.get("lora_alpha", 32.0))
        self.learning_rate = float(cfg.get("learning_rate", 2e-4))
        self.weight_decay = float(cfg.get("weight_decay", 0.01))
        self.num_epochs = int(cfg.get("num_epochs", 1))
        self.batch_size = int(cfg.get("batch_size", 4))
        self.max_seq_len = int(cfg.get("max_seq_len", 256))
        self.warmup_steps = int(cfg.get("warmup_steps", 10))
        self.grad_clip = float(cfg.get("grad_clip", 1.0))
        self.output_dir = cfg.get("output_dir", "finetune_out")
        self.save_total_limit = int(cfg.get("save_total_limit", 3))
        self.checkpoint_every = int(cfg.get("checkpoint_every", 50))
        self.seed = int(cfg.get("seed", 0))
        self.callback: Optional[EvaluationCallback] = None
        self._opt: Optional[_AdamW] = None
        self.global_step = 0

    # -- preparation -----------------------------------------------------------
    def prepare_model(self) -> None:
        """Attach LoRA adapters to the (possibly quantized) model params, A
        drawn from a generator seeded with ``seed``."""
        self.model._ensure()
        self.model.params = add_lora(
            self.model.params,
            torch.Generator().manual_seed(self.seed),
            rank=self.rank,
            alpha=self.alpha,
        )
        logger.info("LoRA attached: r=%d alpha=%.0f", self.rank, self.alpha)

    def setup_evaluation(self, **kw) -> EvaluationCallback:
        self.callback = EvaluationCallback(self.model, **kw)
        return self.callback

    # -- data --------------------------------------------------------------------
    def prepare_batches(self, samples: Sequence[DatasetSample]) -> List[Dict[str, np.ndarray]]:
        """Tokenize instruction prompts into fixed-shape training batches.

        The loss is masked to real (non-pad) next-token positions; the full
        formatted prompt (instruction + response) is trained on."""
        tok = self.model.tokenizer
        encoded = []
        for s in samples:
            text = BaseDatasetLoader.format_prompt(s, include_output=True)
            ids = tok.encode(text, max_length=self.max_seq_len)
            if len(ids) >= 2:
                encoded.append(ids)
        pad_id = getattr(tok, "pad_id", 0)
        batches = []
        for start in range(0, len(encoded), self.batch_size):
            group = encoded[start : start + self.batch_size]
            ids = np.full((self.batch_size, self.max_seq_len), pad_id, np.int32)
            mask = np.zeros((self.batch_size, self.max_seq_len), np.bool_)
            for row, seq in enumerate(group):
                ids[row, : len(seq)] = seq
                mask[row, : len(seq)] = True
            batches.append({"ids": ids, "mask": mask})
        return batches

    # -- optimizer / step ---------------------------------------------------------
    def _build_optimizer(self, total_steps: int) -> _AdamW:
        warmup = min(self.warmup_steps, max(total_steps // 10, 1))
        decay = max(total_steps, 1)
        warmup_cosine_lr(0, self.learning_rate, warmup, decay)  # raises as optax does
        quantized = any(hasattr(n.base, "codes") for n in lora_nodes(self.model.params))
        return _AdamW(adapter_tensors(self.model.params),
                      lambda c: warmup_cosine_lr(c, self.learning_rate, warmup, decay),
                      self.weight_decay, self.grad_clip,
                      torch.float32 if quantized else torch.bfloat16)

    def _device_batch(self, batch: Dict[str, np.ndarray]):
        dev = self.model.device
        return (torch.from_numpy(batch["ids"]).to(dev, torch.long),
                torch.from_numpy(batch["mask"]).to(dev))

    def loss(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The batch's masked next-token loss through the model's forward."""
        return masked_loss(forward(self.model.params, self.model.cfg, ids, mask), ids, mask)

    def train_step(self, batch: Dict[str, np.ndarray]) -> float:
        """One eager step: the loss, ``backward()``, the update → the loss."""
        ids, mask = self._device_batch(batch)
        for t in self._opt.tensors:
            t.grad = None
        loss = self.loss(ids, mask)
        loss.backward()
        self._opt.step()
        return float(loss.detach())

    # -- training loop --------------------------------------------------------------
    def train(
        self,
        train_samples: Sequence[DatasetSample],
        eval_samples: Optional[Sequence[DatasetSample]] = None,
        resume: bool = True,
    ) -> Dict[str, Any]:
        if not lora_nodes(self.model.params):
            self.prepare_model()
        batches = self.prepare_batches(train_samples)
        if not batches:
            raise ValueError("no training batches produced")
        total_steps = len(batches) * self.num_epochs
        start_epoch = 0
        if resume:
            start_epoch = self._try_resume()
        self._opt = self._build_optimizer(total_steps)

        history: List[Dict[str, Any]] = []
        t0 = time.perf_counter()
        for epoch in range(start_epoch, self.num_epochs):
            epoch_losses = []
            for batch in batches:
                epoch_losses.append(self.train_step(batch))
                self.global_step += 1
                if self.global_step % self.checkpoint_every == 0:
                    self._save_checkpoint(epoch)
            mean_loss = float(np.mean(epoch_losses))
            entry: Dict[str, Any] = {"epoch": epoch, "loss": mean_loss, "steps": self.global_step}
            logger.info("epoch %d: loss=%.4f", epoch, mean_loss)
            if eval_samples:
                entry["eval_loss"] = self.evaluate_loss(eval_samples)
            if self.callback is not None:
                entry["evaluation"] = self.callback.on_epoch_end(epoch)
            history.append(entry)
            self._save_checkpoint(epoch)
        wall = time.perf_counter() - t0
        result = {
            "history": history,
            "train_time_s": wall,
            "total_steps": self.global_step,
            "final_loss": history[-1]["loss"] if history else None,
        }
        os.makedirs(self.output_dir, exist_ok=True)
        with open(os.path.join(self.output_dir, "train_result.json"), "w") as f:
            json.dump(result, f, indent=2, default=str)
        return result

    @torch.no_grad()
    def evaluate_loss(self, samples: Sequence[DatasetSample]) -> float:
        losses = [float(self.loss(*self._device_batch(b))) for b in self.prepare_batches(samples)]
        return float(np.mean(losses)) if losses else float("nan")

    # -- checkpointing ------------------------------------------------------------------
    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(self.output_dir, f"checkpoint-{step}")

    def _save_checkpoint(self, epoch: int) -> str:
        path = self._ckpt_dir(self.global_step)
        os.makedirs(path, exist_ok=True)
        adapters = extract_lora(self.model.params)
        arrays = {}
        manifest = {"step": self.global_step, "epoch": epoch, "adapters": {}}
        for i, (name, ad) in enumerate(sorted(adapters.items())):
            arrays[f"a_{i}"] = ad["a"].detach().float().cpu().numpy()
            arrays[f"b_{i}"] = ad["b"].detach().float().cpu().numpy()
            manifest["adapters"][name] = {"index": i, "alpha": ad["alpha"], "rank": ad["rank"]}
        np.savez_compressed(os.path.join(path, "adapters.npz"), **arrays)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        self._prune_checkpoints()
        return path

    def _prune_checkpoints(self) -> None:
        ckpts = self._list_checkpoints()
        while len(ckpts) > self.save_total_limit:
            victim = ckpts.pop(0)  # lowest step
            shutil.rmtree(os.path.join(self.output_dir, f"checkpoint-{victim}"), ignore_errors=True)

    def _list_checkpoints(self) -> List[int]:
        if not os.path.isdir(self.output_dir):
            return []
        steps = []
        for name in os.listdir(self.output_dir):
            mm = re.fullmatch(r"checkpoint-(\d+)", name)
            if mm:
                steps.append(int(mm.group(1)))
        return sorted(steps)

    def _try_resume(self) -> int:
        """Resume the adapters and the step counter from the highest
        checkpoint-*; the optimizer's moments and count restart fresh."""
        ckpts = self._list_checkpoints()
        if not ckpts:
            return 0
        step = ckpts[-1]
        path = self._ckpt_dir(step)
        try:
            epoch = self.load_adapters(path)
            self.global_step = step
            logger.info("resumed from %s (epoch %d)", path, epoch)
            return epoch + 1
        except Exception as e:  # a partial or foreign checkpoint: train from the start
            logger.warning("resume failed from %s: %s", path, e)
            return 0

    def load_adapters(self, path: str) -> int:
        """Load ``path``'s adapters (either package's) into the model's LoRA
        nodes of the same names, as new leaf tensors in each node's dtype and
        device → the checkpoint's epoch."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = np.load(os.path.join(path, "adapters.npz"))
        by_name = {
            name: (arrays[f"a_{info['index']}"], arrays[f"b_{info['index']}"])
            for name, info in manifest["adapters"].items()
        }

        def leaf(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
            return torch.from_numpy(np.asarray(a, np.float32)).to(like.device, like.dtype) \
                .requires_grad_(True)

        def visit(prefix: str, node: Any) -> Any:
            if isinstance(node, LoRAWeight):
                if prefix in by_name:
                    a, b = by_name[prefix]
                    return LoRAWeight(node.base, leaf(a, node.lora_a), leaf(b, node.lora_b),
                                      node.alpha, node.rank)
                return node
            if isinstance(node, dict):
                return {k: visit(f"{prefix}.{k}" if prefix else k, v) for k, v in node.items()}
            if isinstance(node, list):
                return [visit(f"{prefix}[{i}]", v) for i, v in enumerate(node)]
            return node

        self.model.params = visit("", self.model.params)
        return int(manifest.get("epoch", 0))

    # -- export -------------------------------------------------------------------------
    def save_model(self, out_dir: Optional[str] = None) -> str:
        out_dir = out_dir or os.path.join(self.output_dir, "final")
        path = self._save_checkpoint(epoch=self.num_epochs - 1)
        os.makedirs(out_dir, exist_ok=True)
        for fname in ("adapters.npz", "manifest.json"):
            shutil.copy(os.path.join(path, fname), os.path.join(out_dir, fname))
        snapshot = {
            "lora_rank": self.rank,
            "lora_alpha": self.alpha,
            "learning_rate": self.learning_rate,
            "num_epochs": self.num_epochs,
            "batch_size": self.batch_size,
            "max_seq_len": self.max_seq_len,
            "model": self.model.get_model_info(),
        }
        with open(os.path.join(out_dir, "training_config.json"), "w") as f:
            json.dump(snapshot, f, indent=2, default=str)
        return out_dir

    # -- estimation ---------------------------------------------------------------------
    def estimate_training_time(
        self, num_samples: int, measured_step_s: Optional[float] = None
    ) -> Dict[str, Any]:
        steps_per_epoch = -(-num_samples // self.batch_size)
        total_steps = steps_per_epoch * self.num_epochs
        step_s = measured_step_s or 0.5
        return {
            "steps_per_epoch": steps_per_epoch,
            "total_steps": total_steps,
            "est_step_s": step_s,
            "est_total_s": total_steps * step_s,
            "est_total_h": total_steps * step_s / 3600.0,
        }
