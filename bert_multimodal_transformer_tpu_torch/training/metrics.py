"""Evaluation metrics: a numpy-only copy of the JAX package's
``training/metrics.py`` (the port cannot import that package, whose
``__init__`` pulls in jax, and does not edit it). The port keeps its own
copy, and the tests hold it equal to the original (ROADMAP A.12).

MOSI-standard scoring: drop exactly-zero labels unless ``use_zero``, MAE,
Pearson correlation, then binarize predictions/labels at ≥ 0 for accuracy
(Acc-2) and weighted F1.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def binary_weighted_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """sklearn f1_score(average="weighted") for binary labels."""
    y_true = np.asarray(y_true, bool)
    y_pred = np.asarray(y_pred, bool)
    f1s, weights = [], []
    for cls in (False, True):
        support = np.sum(y_true == cls)
        if support == 0:
            continue
        tp = np.sum((y_pred == cls) & (y_true == cls))
        fp = np.sum((y_pred == cls) & (y_true != cls))
        fn = np.sum((y_pred != cls) & (y_true == cls))
        precision = tp / (tp + fp) if (tp + fp) else 0.0
        recall = tp / (tp + fn) if (tp + fn) else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if (precision + recall) else 0.0)
        f1s.append(f1)
        weights.append(support)
    if not weights:
        return 0.0
    return float(np.average(f1s, weights=weights))


def pearson_corr(a: np.ndarray, b: np.ndarray) -> float:
    """np.corrcoef[0][1]."""
    if len(a) < 2:
        return float("nan")
    return float(np.corrcoef(a, b)[0][1])


def score_regression(
    preds: np.ndarray,
    labels: np.ndarray,
    use_zero: bool = False,
) -> Dict[str, float]:
    """Returns {acc, mae, corr, f_score} with zero-label exclusion."""
    preds = np.asarray(preds, np.float64).reshape(-1)
    labels = np.asarray(labels, np.float64).reshape(-1)
    keep = (labels != 0) | use_zero
    preds = preds[keep]
    labels = labels[keep]

    mae = float(np.mean(np.abs(preds - labels))) if len(preds) else 0.0
    corr = pearson_corr(preds, labels)

    pred_pos = preds >= 0
    label_pos = labels >= 0
    acc = float(np.mean(pred_pos == label_pos)) if len(preds) else 0.0
    f_score = binary_weighted_f1(label_pos, pred_pos)
    return {"acc": acc, "mae": mae, "corr": corr, "f_score": f_score}


def multiclass_weighted_f1(y_true: np.ndarray,
                           y_pred: np.ndarray) -> float:
    """sklearn f1_score(average="weighted") over integer class ids."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    f1s, weights = [], []
    for cls in np.unique(y_true):
        support = int(np.sum(y_true == cls))
        tp = np.sum((y_pred == cls) & (y_true == cls))
        fp = np.sum((y_pred == cls) & (y_true != cls))
        fn = np.sum((y_pred != cls) & (y_true == cls))
        precision = tp / (tp + fp) if (tp + fp) else 0.0
        recall = tp / (tp + fn) if (tp + fn) else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if (precision + recall) else 0.0)
        f1s.append(f1)
        weights.append(support)
    if not weights:
        return 0.0
    return float(np.average(f1s, weights=weights))


def score_classification(
    pred_classes: np.ndarray,
    labels: np.ndarray,
) -> Dict[str, float]:
    """Accuracy + weighted F1 for a num_labels > 1 classifier head."""
    pred_classes = np.asarray(pred_classes).reshape(-1)
    labels = np.asarray(labels).reshape(-1).astype(pred_classes.dtype)
    if len(labels) == 0:
        return {"acc": 0.0, "f_score": 0.0}
    acc = float(np.mean(pred_classes == labels))
    return {"acc": acc,
            "f_score": multiclass_weighted_f1(labels, pred_classes)}
