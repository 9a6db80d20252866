"""Pieces the drivers share: dataclass configurations of the port from a
configuration file, a seeded reservoir of the window's answers, and the
comparisons."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def tuples(value):
    """JSON lists as the tuples the port's frozen dataclasses hold."""
    if isinstance(value, list):
        return tuple(tuples(v) for v in value)
    if isinstance(value, dict):
        return {k: tuples(v) for k, v in value.items()}
    return value


def dataclass_of(cls, values: dict, **nested):
    """``cls(**values)`` with the fields of ``nested`` built by their own
    classes; a key ``cls`` does not have raises."""
    names = {f.name for f in dataclasses.fields(cls)}
    extra = set(values) - names
    if extra:
        raise KeyError(f'{cls.__name__} has no field(s) {sorted(extra)}')
    kw = tuples(values)
    for key, sub in nested.items():
        kw[key] = dataclass_of(sub, values[key])
    return cls(**kw)


class Reservoir:
    """A uniform sample of ``k`` of the window's answers, drawn from the
    seed without knowing how many the window will hold."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        n, self.seen = self.seen, self.seen + 1
        if n < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, n + 1))
        if j < self.k:
            self.items[j] = item


def rel_err(value: torch.Tensor, ref: torch.Tensor) -> float:
    """||value - ref|| / ||ref||, in f64."""
    v, r = value.double(), ref.double()
    return float(torch.linalg.vector_norm(v - r)
                 / torch.linalg.vector_norm(r).clamp(min=1e-300))


def dets_mismatch(dets, ref_dets) -> float:
    """Share of the served detections (boxes, scores, labels, valid) that
    the reference's decode of the same head outputs does not give, slot
    for slot: another validity, label or score, or a box off by more
    than 1e-5 of its scale."""
    boxes, scores, labels, valid = dets
    r_boxes, r_scores, r_labels, r_valid = ref_dets
    tol = 1e-5 * (1.0 + r_boxes.abs())
    bad = ((valid != r_valid)
           | (valid & ((labels != r_labels)
                       | ((scores - r_scores).abs()
                          > 1e-5 * (1.0 + r_scores.abs()))
                       | ((boxes - r_boxes).abs() > tol).any(-1))))
    return float(bad.sum()) / max(int((valid | r_valid).sum()), 1)
