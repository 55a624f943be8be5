"""Feature extraction + two-view geometry (OpenCV).

Stand-in for hloc SuperPoint/SuperGlue + COLMAP geometric verification
(ref extract_relative_poses.py:94-147 reads COLMAP two_view_geometries and
decomposes the essential matrix; here the same relative motions come from
SIFT + ratio matching + RANSAC essential + recoverPose)."""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class TwoViewGeometry(NamedTuple):
    i: int
    j: int
    R: np.ndarray        # (3, 3) relative rotation, x_j = R x_i + t
    t: np.ndarray        # (3,) unit-norm relative translation
    num_inliers: int


def extract_features(image_dir: str, files: list[str], max_features: int = 4096):
    import cv2

    sift = cv2.SIFT_create(nfeatures=max_features)
    out = []
    for f in files:
        img = cv2.imread(os.path.join(image_dir, f), cv2.IMREAD_GRAYSCALE)
        kp, desc = sift.detectAndCompute(img, None)
        out.append((kp, desc))
    return out


def match_pair(feats_i, feats_j, ratio: float = 0.8):
    import cv2

    kpi, di = feats_i
    kpj, dj = feats_j
    if di is None or dj is None or len(di) < 8 or len(dj) < 8:
        return None
    matcher = cv2.FlannBasedMatcher(dict(algorithm=1, trees=5), dict(checks=50))
    matches = matcher.knnMatch(di, dj, k=2)
    good = [m for m, nn in matches if m.distance < ratio * nn.distance]
    if len(good) < 8:
        return None
    pts_i = np.float32([kpi[m.queryIdx].pt for m in good])
    pts_j = np.float32([kpj[m.trainIdx].pt for m in good])
    return pts_i, pts_j


def two_view_geometry(pts_i, pts_j, K: np.ndarray, min_inliers: int = 30):
    import cv2

    E, mask = cv2.findEssentialMat(pts_i, pts_j, K, cv2.RANSAC, 0.999, 1.0)
    if E is None or E.shape != (3, 3):
        return None
    inliers = int(mask.sum()) if mask is not None else 0
    if inliers < min_inliers:
        return None
    _, R, t, _ = cv2.recoverPose(E, pts_i, pts_j, K, mask=mask)
    return R, t[:, 0], inliers


def build_view_graph(image_dir: str, files, pairs, K, min_inliers: int = 30):
    """Run matching + two-view geometry over the pair list."""
    feats = extract_features(image_dir, files)
    geometries: list[TwoViewGeometry] = []
    for i, j in pairs:
        m = match_pair(feats[i], feats[j])
        if m is None:
            continue
        tv = two_view_geometry(m[0], m[1], K, min_inliers)
        if tv is None:
            continue
        geometries.append(TwoViewGeometry(i, j, tv[0], tv[1], tv[2]))
    return geometries
