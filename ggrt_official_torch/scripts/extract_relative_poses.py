"""Offline relative-pose extraction (the reference's
scripts/extract_relative_poses.py; the JAX package's root script of the
same name).

The reference shells out to hloc (SuperPoint features + matching) and
COLMAP two-view geometries; the JAX script builds the same pipeline on
OpenCV: SIFT features -> FLANN matching with ratio test -> essential
matrix (RANSAC) -> R,t decomposition -> g2o EDGE_SE3:QUAT relative poses +
VERTEX placeholders. This one runs OpenCV's algorithms in torch on the
card (`sfm/sift.py`, exact 2-NN matching, `sfm/essential.py`) and needs no
OpenCV; --device cpu runs them on the CPU, --seed seeds the RANSAC draws.

Usage:
  python -m ggrt_official_torch.scripts.extract_relative_poses --image_dir <dir> --out graph.g2o --fx 300
"""
from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch

from ..data.image_io import read_image
from ..sfm.two_view import extract_features, ratio_matches, two_view_geometry


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) -> [qw qx qy qz]."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([
            0.25 * s,
            (R[2, 1] - R[1, 2]) / s,
            (R[0, 2] - R[2, 0]) / s,
            (R[1, 0] - R[0, 1]) / s,
        ])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def extract_relative_poses(image_dir: str, K: np.ndarray, max_pairs_per_image: int = 5,
                           min_matches: int = 30, device="cuda", generator: torch.Generator | None = None):
    """Relative poses of every pair at most `max_pairs_per_image` apart in
    file order: (files, [(i, j, R, t, inliers)]). Features, matching and
    geometry run on `device`; `generator` (on `device`, seeded 0 when None)
    draws the RANSAC samples."""
    files = sorted(
        f for f in os.listdir(image_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    dev = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    feats = extract_features(image_dir, files, max_features=0, device=dev)

    edges = []
    n = len(files)
    for i, j in itertools.combinations(range(n), 2):
        if abs(i - j) > max_pairs_per_image:
            continue
        kpi, di = feats[i]
        kpj, dj = feats[j]
        q, t = ratio_matches(di, dj, 0.8)
        if len(q) < min_matches:
            continue
        tv = two_view_geometry(kpi[q], kpj[t], K, min_matches, generator)
        if tv is None:
            continue
        R, t, inliers = tv
        edges.append((i, j, R, t, inliers))
    return files, edges


def write_g2o(path: str, n_nodes: int, edges) -> None:
    with open(path, "w") as f:
        for i in range(n_nodes):
            f.write(f"VERTEX_SE3:QUAT {i} 0 0 0 0 0 0 1\n")
        for i, j, R, t, _ in edges:
            q = rotmat_to_quat(R)  # [qw qx qy qz]
            f.write(
                f"EDGE_SE3:QUAT {i} {j} {t[0]} {t[1]} {t[2]} "
                f"{q[1]} {q[2]} {q[3]} {q[0]} "
                + " ".join(["1"] * 21) + "\n"
            )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--fx", type=float, required=True)
    ap.add_argument("--fy", type=float, default=None)
    ap.add_argument("--cx", type=float, default=None)
    ap.add_argument("--cy", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sample = read_image(
        os.path.join(args.image_dir, sorted(os.listdir(args.image_dir))[0])
    )
    h, w = sample.shape[:2]
    K = np.array([
        [args.fx, 0, args.cx if args.cx else w / 2],
        [0, args.fy if args.fy else args.fx, args.cy if args.cy else h / 2],
        [0, 0, 1],
    ])
    dev = torch.device(args.device)
    files, edges = extract_relative_poses(args.image_dir, K, device=dev,
                                          generator=torch.Generator(device=dev).manual_seed(args.seed))
    write_g2o(args.out, len(files), edges)
    print(f"{len(files)} images, {len(edges)} relative poses -> {args.out}")
    return files, edges


if __name__ == "__main__":
    main()
