"""Match disambiguation by rotation (geodesic) consistency.

Stand-in for the reference's Yan-et-al geodesic-consistency scoring +
match filtering (ref extract_relative_poses.py:23-30, 199-214 and the
external `disambiguation.calculate_geodesic_consistency_scores` /
`filter_matches` modules): each edge (i, j) is scored by how consistently
its measured relative rotation agrees with compositions through common
neighbors k (R_ij ≈ R_kj R_ik); low-scoring edges — typically wrong
matches from repeated structure — are filtered with the same strategy
menu (threshold / knn / percentile)."""
from __future__ import annotations

import numpy as np


def _rotation_angle(R: np.ndarray) -> float:
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(tr)))


def geodesic_consistency_scores(
    geometries, num_images: int, angle_thresh_deg: float = 10.0
) -> dict:
    """Score each edge by triplet rotation consistency.

    Returns {(i, j): score in [0, 1]} — the fraction of triplets through
    common neighbors whose composed rotation agrees within the threshold.
    Edges with no triplet support score 0.5 (uninformative, as in the
    reference's don't-care band)."""
    R = {}
    neighbors = [set() for _ in range(num_images)]
    for g in geometries:
        R[(g.i, g.j)] = g.R
        neighbors[g.i].add(g.j)
        neighbors[g.j].add(g.i)

    def rel(i, j):
        if (i, j) in R:
            return R[(i, j)]
        return R[(j, i)].T

    scores = {}
    for g in geometries:
        i, j = g.i, g.j
        common = (neighbors[i] & neighbors[j]) - {i, j}
        if not common:
            scores[(i, j)] = 0.5
            continue
        ok = 0
        for k in common:
            composed = rel(k, j) @ rel(i, k)
            if _rotation_angle(composed.T @ rel(i, j)) < angle_thresh_deg:
                ok += 1
        scores[(i, j)] = ok / len(common)
    return scores


def filter_edges(
    geometries, scores: dict, filter_type: str = "threshold",
    threshold: float = 0.15, topk: int = 3, percentile: float | None = None,
):
    """Drop low-consistency edges (ref filter_matches strategies)."""
    if filter_type == "threshold":
        keep = {e for e, s in scores.items() if s >= threshold}
    elif filter_type == "percentile":
        assert percentile is not None
        cut = np.percentile(list(scores.values()), percentile)
        keep = {e for e, s in scores.items() if s >= cut}
    elif filter_type == "knn":
        by_node: dict[int, list] = {}
        for (i, j), s in scores.items():
            by_node.setdefault(i, []).append((s, (i, j)))
            by_node.setdefault(j, []).append((s, (i, j)))
        keep = set()
        for node, edges in by_node.items():
            for s, e in sorted(edges, reverse=True)[:topk]:
                keep.add(e)
    else:
        raise ValueError(filter_type)
    return [g for g in geometries if (g.i, g.j) in keep]
