"""Feature extraction + two-view geometry, in PyTorch on the card.

Stand-in for hloc SuperPoint/SuperGlue + COLMAP geometric verification
(ref extract_relative_poses.py:94-147 reads COLMAP two_view_geometries and
decomposes the essential matrix; here the same relative motions come from
SIFT + ratio matching + RANSAC essential + recoverPose). The JAX package
runs these steps through OpenCV; the port runs OpenCV's algorithms in
torch (`sift.py`, `essential.py`), on `device` ("cuda" unless the caller
asks for "cpu"), and needs no OpenCV:

  * `extract_features`: SIFT as cv2.SIFT_create(nfeatures) computes it;
    keypoints as (n, 2) float32 tensors where JAX keeps cv2.KeyPoint's
    `pt`.
  * `match_pair`: the exact two nearest neighbours by L2 (one float64
    matmul of the descriptor sets, then topk), where JAX's FLANN (5
    randomized kd-trees, 50 checks) finds them approximately; Lowe's
    ratio test at 0.8, the matches in query order.
  * `two_view_geometry`: RANSAC essential matrix (prob 0.999, 1 px) and
    recoverPose; the samples come from a `torch.Generator`.

A pair costs three host reads: the match count, one per RANSAC round
(usually one), and the result's copy to the host."""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..data.image_io import read_gray
from . import essential, sift


class TwoViewGeometry(NamedTuple):
    i: int
    j: int
    R: np.ndarray        # (3, 3) relative rotation, x_j = R x_i + t
    t: np.ndarray        # (3,) unit-norm relative translation
    num_inliers: int


def extract_features(image_dir: str, files: list[str], max_features: int = 4096, device="cuda"):
    """[(keypoints (n, 2) float32, descriptors (n, 128) float32)] per file,
    on `device`."""
    out = []
    for f in files:
        kp, desc = sift.detect_and_compute(read_gray(os.path.join(image_dir, f)), max_features, device=device)
        out.append((kp.pt, desc))
    return out


def ratio_matches(di: torch.Tensor, dj: torch.Tensor, ratio: float = 0.8):
    """Lowe's ratio test on the exact 2-NN of each row of `di` among `dj`:
    (query indices, train indices) of the kept matches, in query order.

    The descriptors hold integers, so the float64 distances are exact; they
    are compared as OpenCV's matcher gives them (float32 L2, the ratio in
    double). One host read: the number kept."""
    if len(dj) < 2:
        empty = torch.zeros(0, dtype=torch.long, device=di.device)
        return empty, empty
    a, b = di.to(torch.float64), dj.to(torch.float64)
    d2 = (a * a).sum(1, keepdim=True) + (b * b).sum(1) - 2 * (a @ b.T)
    d2, nn = torch.topk(d2.clamp(min=0), 2, dim=1, largest=False)
    dist = torch.sqrt(d2.to(torch.float32)).to(torch.float64)
    q = torch.nonzero(dist[:, 0] < ratio * dist[:, 1])[:, 0]
    return q, nn[q, 0]


def match_pair(feats_i, feats_j, ratio: float = 0.8):
    """(pts_i, pts_j) (m, 2) float32 tensors of the matches that pass the
    ratio test, or None where either image has fewer than 8 descriptors or
    fewer than 8 matches pass."""
    kpi, di = feats_i
    kpj, dj = feats_j
    if di is None or dj is None or len(di) < 8 or len(dj) < 8:
        return None
    q, t = ratio_matches(di, dj, ratio)
    if len(q) < 8:
        return None
    return kpi[q], kpj[t]


def two_view_geometry(pts_i, pts_j, K: np.ndarray, min_inliers: int = 30, generator: torch.Generator | None = None):
    """(R (3, 3), t (3,), inliers) as numpy float64 and int, or None where
    RANSAC finds no single essential matrix or fewer than `min_inliers`
    inliers. Tensors run on their own device, arrays on the card;
    `generator` must live there too."""
    dev = pts_i.device if torch.is_tensor(pts_i) else torch.device("cuda")
    pts_i, pts_j = torch.as_tensor(pts_i, device=dev), torch.as_tensor(pts_j, device=dev)
    E, mask = essential.find_essential_mat(pts_i, pts_j, K, 0.999, 1.0, generator=generator)
    if E is None or E.shape != (3, 3):
        return None
    _, R, t, _ = essential.recover_pose(E, pts_i, pts_j, K, mask=mask)
    vals = torch.cat([mask.sum().reshape(1).to(torch.float64), R.reshape(-1), t]).cpu().numpy()
    inliers = int(vals[0])
    if inliers < min_inliers:
        return None
    return vals[1:10].reshape(3, 3), vals[10:13], inliers


def build_view_graph(image_dir: str, files, pairs, K, min_inliers: int = 30, device="cuda",
                     generator: torch.Generator | None = None):
    """Run matching + two-view geometry over the pair list on `device`;
    `generator` (on `device`; seeded 0 when None) draws every RANSAC sample."""
    dev = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    feats = extract_features(image_dir, files, device=dev)
    geometries: list[TwoViewGeometry] = []
    for i, j in pairs:
        m = match_pair(feats[i], feats[j])
        if m is None:
            continue
        tv = two_view_geometry(m[0], m[1], K, min_inliers, generator)
        if tv is None:
            continue
        geometries.append(TwoViewGeometry(i, j, tv[0], tv[1], tv[2]))
    return geometries
