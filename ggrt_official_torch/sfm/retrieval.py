"""Image retrieval for match-pair selection (the JAX package's
sfm/retrieval.py, without OpenCV).

Stand-in for hloc's NetVLAD retrieval (ref extract_relative_poses.py:
pairs_from_retrieval.main with num_matches top-k): a global descriptor per
image (grid-pooled intensities and a histogram of grey levels,
L2-normalized) and cosine-similarity top-k pair lists: a list of (i, j)
pairs covering each image's k most similar partners.

OpenCV's grey read, INTER_AREA resize and calcHist are done in numpy
(data/image_io.py): the same uint8 grid cells and the same counts.
"""
from __future__ import annotations

import os

import numpy as np

from ..data.image_io import read_gray, resize


def global_descriptor(image_gray: np.ndarray, grid: int = 8, bins: int = 16) -> np.ndarray:
    """Tiny gist-style descriptor of a uint8 grey image: grid-pooled
    intensities (INTER_AREA to grid x grid, rounded to uint8 as OpenCV's
    uint8 resize) and a `bins`-bin histogram over [0, 256)."""
    cells = resize(image_gray.astype(np.float32), (grid, grid), "area")
    g = np.clip(np.rint(cells), 0, 255).astype(np.uint8)
    g = (g - g.mean()) / (g.std() + 1e-6)
    hist = np.bincount((image_gray.astype(np.int64).ravel() * bins) >> 8, minlength=bins).astype(np.float32)
    hist = hist / (np.linalg.norm(hist) + 1e-6)
    desc = np.concatenate([g.reshape(-1), hist])
    return desc / (np.linalg.norm(desc) + 1e-6)


def pairs_from_retrieval(image_dir: str, files: list[str], num_matches: int = 10):
    """Top-k most-similar pairs per image by descriptor cosine similarity."""
    D = np.stack([global_descriptor(read_gray(os.path.join(image_dir, f))) for f in files])
    sim = D @ D.T
    np.fill_diagonal(sim, -np.inf)

    pairs = set()
    n = len(files)
    k = min(num_matches, n - 1)
    for i in range(n):
        for j in np.argsort(-sim[i])[:k]:
            pairs.add((min(i, int(j)), max(i, int(j))))
    return sorted(pairs)
