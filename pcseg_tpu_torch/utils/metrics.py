"""Parity metrics (a NumPy copy of pcseg_tpu.utils.metrics): the
BASELINE.json north-star measurements.

``label_agreement`` compares two label grids allowing for permuted region
ids (region identity is matched by maximal overlap), since any id-order
divergence would otherwise count every pixel of a region as wrong.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np


class AgreementReport(NamedTuple):
    per_point_agreement: float      # exact label equality
    matched_agreement: float        # after optimal greedy id matching
    num_regions_a: int
    num_regions_b: int
    id_mapping: Dict[int, int]


def label_agreement(a: np.ndarray, b: np.ndarray) -> AgreementReport:
    """Per-point agreement between label grids (negatives = unlabeled)."""
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    exact = float((a == b).mean())

    ids_a = np.unique(a[a >= 0])
    ids_b = np.unique(b[b >= 0])
    # greedy maximal-overlap matching (regions are usually near-disjoint)
    pairs = []
    for ia in ids_a:
        mask = a == ia
        vals, counts = np.unique(b[mask], return_counts=True)
        for v, c in zip(vals, counts):
            if v >= 0:
                pairs.append((int(c), int(ia), int(v)))
    pairs.sort(reverse=True)
    used_a, used_b, mapping = set(), set(), {}
    for c, ia, ib in pairs:
        if ia in used_a or ib in used_b:
            continue
        mapping[ia] = ib
        used_a.add(ia)
        used_b.add(ib)

    remapped = np.full_like(a, -1)
    for ia, ib in mapping.items():
        remapped[a == ia] = ib
    remapped[a < 0] = a[a < 0]
    matched = float(((remapped == b) | ((remapped < 0) & (b < 0))).mean())
    return AgreementReport(
        per_point_agreement=exact,
        matched_agreement=matched,
        num_regions_a=len(ids_a),
        num_regions_b=len(ids_b),
        id_mapping=mapping)


def normal_angle_error_deg(a: np.ndarray, b: np.ndarray) -> dict:
    """Angular error stats between normal grids (NaN-aware)."""
    va = np.all(np.isfinite(a), axis=-1)
    vb = np.all(np.isfinite(b), axis=-1)
    both = va & vb
    dots = np.clip(np.abs(np.sum(a[both] * b[both], axis=-1)), 0, 1)
    ang = np.degrees(np.arccos(dots)) if both.any() else np.zeros(0)
    return {
        "validity_agreement": float((va == vb).mean()),
        "max_deg": float(ang.max()) if len(ang) else 0.0,
        "mean_deg": float(ang.mean()) if len(ang) else 0.0,
    }
