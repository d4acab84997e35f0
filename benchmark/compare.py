"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference computes from the same inputs."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Tuple

import numpy as np


def _norms(leaves: Dict, names: Iterable[str]) -> Dict[str, float]:
    return {n: float(np.linalg.norm(np.asarray(leaves[n], dtype=np.float64))) for n in names}


def leaf_gap(program: Dict, reference: Dict, names: List[str]) -> Tuple[float, str]:
    """The worst leaf's |norm(program) - norm(reference)| over the larger of
    the reference's norm of that leaf and of the median leaf; and its
    name."""
    p, r = _norms(program, names), _norms(reference, names)
    median = statistics.median(r.values())
    gaps = {n: abs(p[n] - r[n]) / max(r[n], median) for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moved_leaves(first_grad: Dict, names: List[str], share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's: the others (a bias ahead of batch norm) move under Adam
    by round-off alone."""
    g = _norms(first_grad, names)
    median = statistics.median(g.values())
    return [n for n in names if g[n] >= share * median]


def loss_gap(program: Dict[str, List[float]], reference: Dict[str, List[float]],
             steps: int) -> float:
    """The largest absolute gap between a loss (any level) of the first
    ``steps`` steps and the reference's."""
    return max(abs(a - b) for k in reference
               for a, b in zip(program[k][:steps], reference[k][:steps]))


def pose_gaps(program: np.ndarray, reference: np.ndarray) -> Dict[str, float]:
    """Rows of (q, t): the largest component gap of the unit quaternions
    (sign aligned) and the largest distance between the translations, m."""
    q_p, q_r = program[:, :4], reference[:, :4]
    sign = np.where(np.sum(q_p * q_r, axis=1, keepdims=True) < 0, -1.0, 1.0)
    return {"q_gap": float(np.max(np.abs(q_p * sign - q_r))),
            "t_gap_m": float(np.max(np.linalg.norm(program[:, 4:] - reference[:, 4:], axis=1)))}
