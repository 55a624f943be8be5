"""The offline SfM pipeline, end to end.

Equivalent of the reference's extract_relative_poses.py main +
preprocess_dbarf_dataset.py + colmap_model_to_poses_bounds.py chain:
images -> retrieval pairs -> two-view geometries -> geodesic-consistency
filter -> g2o view graph -> MST-initialized global poses ->
poses_bounds.npy (LLFF convention)."""
from __future__ import annotations

import os

import numpy as np
import torch

from ..data.image_io import read_image
from ..geometry.pose_init import PoseInitializer
from .disambiguation import filter_edges, geodesic_consistency_scores
from .retrieval import pairs_from_retrieval
from .two_view import build_view_graph


def _quat_from_R(R):
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(R).as_quat()  # [qx qy qz qw]
    return np.array([q[3], q[0], q[1], q[2]])


def write_g2o(path: str, n_nodes: int, geometries) -> None:
    """g2o view graph (ref output_view_graph, extract_relative_poses.py:70-91)."""
    with open(path, "w") as f:
        for i in range(n_nodes):
            f.write(f"VERTEX_SE3:QUAT {i} 0 0 0 0 0 0 1\n")
        for g in geometries:
            q = _quat_from_R(g.R)
            f.write(
                f"EDGE_SE3:QUAT {g.i} {g.j} {g.t[0]} {g.t[1]} {g.t[2]} "
                f"{q[1]} {q[2]} {q[3]} {q[0]} " + " ".join(["1"] * 21) + "\n"
            )


def write_poses_bounds(path: str, c2ws: np.ndarray, K: np.ndarray,
                       hw: tuple[int, int], near: float, far: float) -> None:
    """LLFF poses_bounds.npy (ref colmap_model_to_poses_bounds.py): rows of
    [3x5 pose|hwf] + [near far], with the LLFF (down, right, back) basis."""
    n = c2ws.shape[0]
    h, w = hw
    f = float(K[0, 0])
    rows = []
    for i in range(n):
        m = c2ws[i]
        # c2w (right, down, forward) -> LLFF columns (-y, x, z) convention:
        pose = np.concatenate(
            [m[:3, 1:2], -m[:3, 0:1], m[:3, 2:3], m[:3, 3:4],
             np.array([[h], [w], [f]])], axis=1,
        )
        rows.append(np.concatenate([pose.reshape(-1), [near, far]]))
    np.save(path, np.stack(rows))


def run_sfm_pipeline(
    image_dir: str,
    out_dir: str,
    K: np.ndarray,
    num_matches: int = 10,
    disambiguate: bool = True,
    filter_type: str = "threshold",
    threshold: float = 0.15,
    min_inliers: int = 30,
    depth_bounds: tuple[float, float] = (1.0, 100.0),
    device="cuda",
    generator: torch.Generator | None = None,
) -> dict:
    """Returns {files, geometries, scores, poses_c2w} and writes
    view_graph.g2o + poses_bounds.npy into out_dir. Features, matching and
    the two-view geometries run on `device`; `generator` (on `device`,
    seeded 0 when None) draws the RANSAC samples."""
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(
        f for f in os.listdir(image_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    n = len(files)
    pairs = pairs_from_retrieval(image_dir, files, num_matches=num_matches)
    geometries = build_view_graph(image_dir, files, pairs, K, min_inliers, device=device, generator=generator)

    scores = None
    if disambiguate and geometries:
        scores = geodesic_consistency_scores(geometries, n)
        geometries = filter_edges(
            geometries, scores, filter_type=filter_type, threshold=threshold
        )

    write_g2o(os.path.join(out_dir, "view_graph.g2o"), n, geometries)

    poses_c2w = None
    if geometries:
        edges = {}
        for g in geometries:
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = g.R
            T[:3, 3] = g.t
            edges[(g.i, g.j)] = (T, g.num_inliers)
        try:
            init = PoseInitializer(edges, n)
            poses_c2w = init.init_poses_from_mst()
            sample = read_image(os.path.join(image_dir, files[0]))
            write_poses_bounds(
                os.path.join(out_dir, "poses_bounds.npy"), poses_c2w, K,
                sample.shape[:2], *depth_bounds,
            )
        except Exception as e:  # disconnected graphs etc. — keep the g2o
            print(f"global pose init skipped: {e}")

    return {
        "files": files,
        "geometries": geometries,
        "scores": scores,
        "poses_c2w": poses_c2w,
    }
