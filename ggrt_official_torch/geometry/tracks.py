"""Feature-track building from pairwise matches (host-side; the JAX
package's geometry/tracks.py, a copy).

Parity target: the reference's ggrt/geometry/track.py (TrackBuilder, used
by scripts/preprocess_dbarf_dataset.py): union-find over per-image feature
observations connected by two-view matches, yielding multi-view tracks for
triangulation / pose-graph preprocessing.
"""
from __future__ import annotations

from collections import defaultdict


class UnionFind:
    def __init__(self):
        self.parent: dict = {}

    def find(self, x):
        root = x
        while self.parent.setdefault(root, root) != root:
            root = self.parent[root]
        while self.parent[x] != root:  # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


class TrackBuilder:
    """Build tracks from matches {(img_i, img_j): [(feat_i, feat_j), ...]}.

    A track is a set of (image_id, feature_id) observations of one 3D point.
    Tracks containing two observations in the same image are inconsistent
    and dropped (standard SfM practice; matches the reference's filtering).
    """

    def __init__(self):
        self.uf = UnionFind()

    def add_matches(self, image_pair: tuple[int, int], matches) -> None:
        i, j = image_pair
        for fi, fj in matches:
            self.uf.union((i, int(fi)), (j, int(fj)))

    def build(self, min_length: int = 2) -> list[list[tuple[int, int]]]:
        groups = defaultdict(list)
        for obs in list(self.uf.parent):
            groups[self.uf.find(obs)].append(obs)

        tracks = []
        for obs_list in groups.values():
            if len(obs_list) < min_length:
                continue
            images = [o[0] for o in obs_list]
            if len(set(images)) != len(images):
                continue  # inconsistent: two features of one image
            tracks.append(sorted(obs_list))
        return sorted(tracks)
