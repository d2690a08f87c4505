"""CSV decline reports + upper-bound bookkeeping (own copy of the JAX
package's ``eval/report.py``: the same CSV and JSON, byte for byte).

The reference's forgetting report: per-class AP/recall across epochs
with decline vs a stored joint-training "upper bound", mean rows, the
summed old-class decline, and prediction-count ratios. The upper bound is
JSON (``upper_bound.json``) instead of a pickle:
  {"<class>": {"ap": x, "recall": y}, "mean": {...}, "pred_ratio": r}
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .coco_eval import EvalResult


def save_upper_bound(path: str, result: EvalResult) -> None:
    """Store a joint-training run's per-class AP/recall as the upper bound."""
    # -1.0 is coco_eval's no-GT-in-split sentinel; persisting it would
    # later read as a real (negative) upper bound and corrupt declines
    data = {
        name: {"ap": result.ap50[name], "recall": result.recall[name]}
        for name in result.ap50
        if result.ap50[name] >= 0.0
    }
    data["mean"] = {"ap": result.mean_ap50, "recall": result.mean_recall}
    data["pred_ratio"] = (
        result.pred_num / result.real_num if result.real_num else 0.0
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def load_upper_bound(path: str) -> Optional[Dict]:
    """Load ``upper_bound.json``; when absent, fall back to a reference
    ``upper_bound.pickle`` beside it (``{cat: {'ap': x, 'recall': y}}``),
    normalized to the JSON schema —
    so a reference experiment dir's decline reports continue here
    unchanged. NB: unpickling executes code in the file; the fallback
    only fires for the exact sibling filename inside the user's own
    ``val_result`` dir."""
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    ref_path = os.path.join(os.path.dirname(path), "upper_bound.pickle")
    if not os.path.exists(ref_path):
        return None
    import pickle

    with open(ref_path, "rb") as f:
        raw = pickle.load(f)
    data = {
        str(name): {"ap": float(v["ap"]), "recall": float(v["recall"])}
        for name, v in raw.items()
        if isinstance(v, dict) and "ap" in v
    }
    if data:  # the reference pickle has no mean/pred_ratio rows
        data["mean"] = {
            "ap": sum(v["ap"] for v in data.values()) / len(data),
            "recall": sum(v["recall"] for v in data.values()) / len(data),
        }
        data["pred_ratio"] = 0.0
    return data or None


def decline_csv(
    results: Dict[int, EvalResult],        # epoch -> result
    class_names: Sequence[str],            # knowing order (old first)
    num_old_classes: int,
    upper_bound: Optional[Dict] = None,
    out_path: Optional[str] = None,
) -> str:
    """Build the reference-format CSV; returns the text."""
    epochs = sorted(results)
    lines: List[str] = []
    lines.append("Epoch" + "".join(f",{e},{e},{e},{e}" for e in epochs))
    lines.append("" + ",AP,Recall,AP_decline,Recall_decline" * len(epochs))

    ap_declines: Dict[int, List[float]] = {e: [] for e in epochs}
    rc_declines: Dict[int, List[float]] = {e: [] for e in epochs}

    for name in class_names:
        row = name
        ub_ap = upper_bound.get(name, {}).get("ap", 0.0) if upper_bound else 0.0
        ub_rc = upper_bound.get(name, {}).get("recall", 0.0) if upper_bound else 0.0
        for e in epochs:
            ap = results[e].ap50.get(name, -1.0)
            rc = results[e].recall.get(name, -1.0)
            d_ap, d_rc = ub_ap - ap, ub_rc - rc
            # -1 sentinel = class absent from the split: keep it visible
            # in the AP column but exclude it from the decline sums (one
            # absent old class would otherwise inflate Sum_decline >100%)
            ap_declines[e].append(d_ap if ap >= 0.0 else 0.0)
            rc_declines[e].append(d_rc if rc >= 0.0 else 0.0)
            row += f",{ap},{rc},{d_ap * 100:.1f}%,{d_rc * 100:.1f}%"
        lines.append(row)

    row = "Mean"
    for e in epochs:
        m_ap, m_rc = results[e].mean_ap50, results[e].mean_recall
        ub_m = upper_bound.get("mean", {}) if upper_bound else {}
        row += (
            f",{m_ap},{m_rc},"
            f"{(ub_m.get('ap', 0.0) - m_ap) * 100:.1f}%,"
            f"{(ub_m.get('recall', 0.0) - m_rc) * 100:.1f}%"
        )
    lines.append(row)

    row = "Sum_decline"
    for e in epochs:
        row += (
            f",,,{sum(ap_declines[e][:num_old_classes]) * 100:.1f}%,"
            f"{sum(rc_declines[e][:num_old_classes]) * 100:.1f}%"
        )
    lines.append(row)

    row = "Pred num"
    for e in epochs:
        row += f",{results[e].pred_num},,,"
    lines.append(row)
    row = "Pred ratio"
    for e in epochs:
        ratio = results[e].pred_num / max(results[e].real_num, 1)
        ub_ratio = upper_bound.get("pred_ratio", 0.0) if upper_bound else 0.0
        row += f",{ratio:.1f},,{ub_ratio:.1f},"
    lines.append(row)

    text = "\n".join(lines)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            f.write(text)
    return text
