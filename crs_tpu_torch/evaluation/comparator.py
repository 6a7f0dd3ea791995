"""Results comparator (port of ``crs_tpu.evaluation.comparator``).

Pairwise metric diffs with improved / regressed classification
(``compare_two``), significance tests from stored mean and std (z-test and
Cohen's d with its interpretation), all-pairs comparison, the best model,
and the weighted leaderboard with min-max normalization and lower-is-better
inversion (``create_leaderboard``); a command line. Host code only.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .base import higher_is_better
from .summary import ResultsSummary

__all__ = ["ResultsComparator"]


class ResultsComparator:
    def __init__(self, results: Optional[Dict[str, Dict[str, Any]]] = None):
        self.results = results or {}

    @classmethod
    def from_directories(cls, dirs: Sequence[str]) -> "ResultsComparator":
        s = ResultsSummary(list(dirs))
        return cls(s.results)

    def _metric(self, label: str, metric: str) -> Optional[float]:
        return ResultsSummary.find_metric(self.results.get(label, {}), metric)

    # -- pairwise --------------------------------------------------------------
    def compare_two(self, a: str, b: str, metrics: Sequence[str]) -> Dict[str, Any]:
        out: Dict[str, Any] = {"a": a, "b": b, "metrics": {}}
        improved = regressed = 0
        for m in metrics:
            va, vb = self._metric(a, m), self._metric(b, m)
            if va is None or vb is None:
                continue
            diff = va - vb
            pct = diff / abs(vb) * 100.0 if vb else 0.0
            hib = higher_is_better(m)
            direction = None
            if hib is not None and diff != 0:
                direction = "improved" if (diff > 0) == hib else "regressed"
                improved += direction == "improved"
                regressed += direction == "regressed"
            out["metrics"][m] = {"a": va, "b": vb, "diff": diff, "pct": pct, "direction": direction}
        out["improved"] = improved
        out["regressed"] = regressed
        return out

    def compare_all_pairs(self, metrics: Sequence[str]) -> List[Dict[str, Any]]:
        labels = list(self.results)
        out = []
        for i, a in enumerate(labels):
            for b in labels[i + 1 :]:
                out.append(self.compare_two(a, b, metrics))
        return out

    # -- significance from stored stats ---------------------------------------
    @staticmethod
    def statistical_significance_test(
        mean_a: float, std_a: float, n_a: int,
        mean_b: float, std_b: float, n_b: int,
    ) -> Dict[str, Any]:
        se = math.sqrt(std_a**2 / max(n_a, 1) + std_b**2 / max(n_b, 1))
        z = (mean_a - mean_b) / se if se > 0 else 0.0
        pooled = math.sqrt((std_a**2 + std_b**2) / 2.0)
        d = (mean_a - mean_b) / pooled if pooled > 0 else 0.0
        interp = (
            "negligible" if abs(d) < 0.2 else
            "small" if abs(d) < 0.5 else
            "medium" if abs(d) < 0.8 else "large"
        )
        p: Optional[float]
        try:
            from scipy import stats as sps  # type: ignore

            p = float(2 * (1 - sps.norm.cdf(abs(z))))
        except ImportError:
            p = None
        return {
            "z_statistic": z,
            "p_value": p,
            "significant": abs(z) > 1.96,
            "cohens_d": d,
            "effect_size": interp,
        }

    # -- best model -----------------------------------------------------------
    def best_model(self, metric: str) -> Optional[Tuple[str, float]]:
        vals = {l: self._metric(l, metric) for l in self.results}
        vals = {l: v for l, v in vals.items() if v is not None}
        if not vals:
            return None
        hib = higher_is_better(metric)
        pick = max(vals.items(), key=lambda kv: kv[1]) if hib is not False else min(
            vals.items(), key=lambda kv: kv[1]
        )
        return pick

    # -- leaderboard -----------------------------------------------------------
    def create_leaderboard(self, weights: Dict[str, float]) -> List[Dict[str, Any]]:
        """Weighted score over min-max-normalized metrics; lower-is-better
        metrics are inverted before normalization."""
        labels = list(self.results)
        norm: Dict[str, Dict[str, float]] = {}
        for metric in weights:
            vals = {l: self._metric(l, metric) for l in labels}
            vals = {l: v for l, v in vals.items() if v is not None}
            if len(vals) < 2:
                continue
            lo, hi = min(vals.values()), max(vals.values())
            span = hi - lo or 1.0
            hib = higher_is_better(metric)
            for l, v in vals.items():
                score = (v - lo) / span
                if hib is False:
                    score = 1.0 - score
                norm.setdefault(l, {})[metric] = score
        rows = []
        for l in labels:
            scores = norm.get(l, {})
            if not scores:
                continue
            total = sum(weights[m] * s for m, s in scores.items())
            wsum = sum(weights[m] for m in scores)
            rows.append({"label": l, "score": total / wsum if wsum else 0.0, "components": scores})
        rows.sort(key=lambda r: -r["score"])
        for i, r in enumerate(rows):
            r["rank"] = i + 1
        return rows


def main(argv=None) -> int:  # the command line
    ap = argparse.ArgumentParser(description="Compare result directories")
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--metrics", nargs="+", default=["latency_ms_per_token", "perplexity", "f1_score"])
    ap.add_argument("--leaderboard", action="store_true")
    args = ap.parse_args(argv)
    c = ResultsComparator.from_directories(args.dirs)
    if args.leaderboard:
        weights = {m: 1.0 for m in args.metrics}
        for row in c.create_leaderboard(weights):
            print(f"{row['rank']}. {row['label']}: {row['score']:.3f}")
    else:
        for cmp in c.compare_all_pairs(args.metrics):
            print(json.dumps(cmp, indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
