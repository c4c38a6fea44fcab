"""Reporting: reference-style text reports and ``metrics.jsonl``.

Counterpart of ``consensus_entropy_tpu/al/reporting.py``, with the
scikit-learn metrics it and the pre-trainer call computed here in numpy:
``weighted_prf`` is ``precision_score``, ``recall_score`` and ``f1_score``
with ``average="weighted", zero_division=0``, and ``classification_
report`` prints scikit-learn's text (``zero_division=0``, two digits)
for the same inputs.  The labels are the sorted union of the true and
predicted ones.
"""

from __future__ import annotations

import datetime
import json
import os

import numpy as np


def _per_label(y_true, y_pred):
    """``(labels, tp, pred_sum, true_sum)`` over the sorted union of
    labels (``multilabel_confusion_matrix`` counts)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_true.shape != y_pred.shape or y_true.ndim != 1:
        raise ValueError(f"y_true {y_true.shape} and y_pred {y_pred.shape} "
                         "must be 1-D and of one length")
    labels = np.union1d(y_true, y_pred)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels],
                  np.int64)
    pred = np.array([np.sum(y_pred == c) for c in labels], np.int64)
    true = np.array([np.sum(y_true == c) for c in labels], np.int64)
    if not tp.any():
        # scikit-learn's counts come out float when nothing was right (and
        # the report then prints its supports as floats)
        tp, pred, true = (a.astype(np.float64) for a in (tp, pred, true))
    return labels, tp, pred, true


def _divide(num, den) -> np.ndarray:
    """``_prf_divide`` with ``zero_division=0``."""
    den = np.asarray(den, np.float64).copy()
    mask = den == 0
    den[mask] = 1
    out = np.asarray(num, np.float64) / den
    out[mask] = 0.0
    return out


def _prf(tp, pred, true):
    precision = _divide(tp, pred)
    recall = _divide(tp, true)
    f1 = _divide(2 * tp.astype(np.float64),
                 true.astype(np.float64) + pred.astype(np.float64))
    return precision, recall, f1


def _average(values, weights=None) -> float:
    if weights is None:
        return float(np.mean(values))
    try:
        return float(np.average(values, weights=weights))
    except ZeroDivisionError:
        return float(np.average(values))


def weighted_prf(y_true, y_pred) -> tuple[float, float, float]:
    """``(precision, recall, f1)`` as scikit-learn's ``precision_score``,
    ``recall_score`` and ``f1_score`` give them with ``average="weighted",
    zero_division=0``."""
    _, tp, pred, true = _per_label(y_true, y_pred)
    if len(tp) == 0:
        return (float("nan"),) * 3
    return tuple(_average(v, weights=true) for v in _prf(tp, pred, true))


def weighted_f1(y_true, y_pred) -> float:
    """``f1_score(y_true, y_pred, average="weighted", zero_division=0)``."""
    return weighted_prf(y_true, y_pred)[2]


def classification_report(y_true, y_pred, digits: int = 2) -> str:
    """scikit-learn's ``classification_report(..., zero_division=0)`` text
    for multiclass labels."""
    labels, tp, pred, true = _per_label(y_true, y_pred)
    p, r, f1 = _prf(tp, pred, true)
    names = ["%s" % lab for lab in labels]
    headers = ["precision", "recall", "f1-score", "support"]
    width = max(max(len(n) for n in names), len("weighted avg"), digits)
    head_fmt = "{:>{width}s} " + " {:>9}" * len(headers)
    report = head_fmt.format("", *headers, width=width) + "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(names, p, r, f1, true):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    support = np.sum(true)
    micro = _prf(np.array([tp.sum()]), np.array([pred.sum()]),
                 np.array([true.sum()]))[2][0]
    report += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}"
               + " {:>9}\n").format("accuracy", "", "", float(micro),
                                    support, width=width, digits=digits)
    for heading, weights in (("macro avg", None), ("weighted avg", true)):
        avg = [_average(v, weights) for v in (p, r, f1)] + [support]
        report += row_fmt.format(heading, *avg, width=width, digits=digits)
    return report


class UserReport:
    """One user's AL run: the text report and ``metrics.jsonl``, at the
    reference's cadence (``amg_test.py:389-418,516-518``)."""

    def __init__(self, user_path: str, mode: str, *, now: str | None = None,
                 write: bool = True):
        """``write=False`` computes metrics and touches no file."""
        self.write = write
        ts = now or datetime.datetime.now().strftime("%d-%m-%Y.%H-%M-%S")
        self.txt_path = os.path.join(user_path,
                                     f"{mode}.trial.date_{ts}.txt")
        self.jsonl_path = os.path.join(user_path, "metrics.jsonl")
        if not write:
            self._txt = self._jsonl = None
            return
        self._txt = open(self.txt_path, "a")
        self._jsonl = open(self.jsonl_path, "a")

    def epoch_header(self, epoch: int) -> None:
        if not self.write:
            return
        self._txt.write("---------------------------------")
        self._txt.write(
            f"\n\n~~~~~~~~~\nEpoch {epoch}:~~~~~~~~~\n~~~~~~~~~\n\n\n")

    def model_eval(self, model_name: str, y_true, y_pred) -> float:
        f1 = weighted_f1(y_true, y_pred)
        if self.write:
            self._txt.write(f"Model: {model_name}\n")
            self._txt.write(f"{classification_report(y_true, y_pred)}\n")
        return f1

    def quarantine_event(self, epoch: int, event: dict) -> None:
        """A member quarantine, in both report files."""
        if not self.write:
            return
        self._txt.write(f"!! quarantined member {event['member']}: "
                        f"{event['reason']}\n")
        self._txt.flush()
        self._jsonl.write(json.dumps(
            {"event": "quarantine", "epoch": epoch, **event}) + "\n")
        self._jsonl.flush()

    def epoch_summary(self, epoch: int, f1_list, *, queried=None,
                      pool_size=None) -> None:
        if not self.write:
            return
        mean_f1 = float(np.mean(f1_list)) if len(f1_list) else float("nan")
        self._txt.write("**\nSummary: F1 mean score over all classifiers = "
                        f"{mean_f1}\n**\n")
        self._txt.flush()
        rec = {"epoch": epoch, "mean_f1": mean_f1,
               "f1": [float(x) for x in f1_list]}
        if queried is not None:
            rec["queried"] = list(map(str, queried))
        if pool_size is not None:
            rec["pool_size"] = int(pool_size)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if not self.write:
            return
        self._txt.write("---------------------------------")
        self._txt.close()
        self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
