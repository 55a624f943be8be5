"""Global pose initialization from a relative-pose view graph (the JAX
package's geometry/pose_init.py, a copy: numpy and scipy on the host).

Parity target: the reference's ggrt/pose_util.py:309-619 (PoseInitializer):
  * MST rotation initialization: build a graph weighted by inverse inlier
    count, take the minimum spanning tree, and chain relative rotations
    outward from a reference frame (pose_util.py:389-436). networkx +
    a priority queue in the reference become scipy.sparse.csgraph +
    breadth-first propagation here.
  * Global positions: the reference delegates to an external
    `position_estimator` that is None in-repo (pose_util.py:322 — the
    path cannot run as committed, SURVEY.md §2.11). We replace it with
    the standard linear least-squares translation registration: given
    MST rotations and relative translations t_ij (w2c convention,
    T_j = T_ij @ T_i), solve min Σ ||t_j - R_ij t_i - t_ij||² with the
    reference camera anchored.
  * Noisy-GT pose synthesis for robustness experiments
    (pose_util.py:340-380).

All numpy, host-side (offline SfM tooling, SURVEY.md §7.1 layer L7).
"""
from __future__ import annotations

import numpy as np


def mst_rotations(
    edges: dict, num_poses: int, ref_id: int = 0, ref_rotation: np.ndarray | None = None
) -> np.ndarray:
    """Chain relative rotations over the minimum spanning tree.

    edges: {(i, j): (R_ij (3, 3), num_inliers)} with R_j = R_ij @ R_i
    (world-to-camera chaining, pose_util.py:410-416).
    Returns (n, 3, 3) w2c rotations.
    """
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order, minimum_spanning_tree

    rows, cols, weights = [], [], []
    for (i, j), (_, inliers) in edges.items():
        rows.append(i)
        cols.append(j)
        weights.append(1.0 / max(float(inliers), 1e-6))
    graph = csr_matrix(
        (weights + weights, (rows + cols, cols + rows)),
        shape=(num_poses, num_poses),
    )
    mst = minimum_spanning_tree(graph)
    sym = mst + mst.T

    order, predecessors = breadth_first_order(sym, ref_id, directed=False)

    def rel(i, j):
        if (i, j) in edges:
            return np.asarray(edges[(i, j)][0], np.float64)
        return np.asarray(edges[(j, i)][0], np.float64).T

    R = np.tile(np.eye(3), (num_poses, 1, 1))
    if ref_rotation is not None:
        R[ref_id] = ref_rotation
    for j in order:
        i = predecessors[j]
        if j == ref_id or i < 0:
            continue
        R[j] = rel(i, j) @ R[i]
    return R.astype(np.float32)


def solve_positions(
    edges: dict, rotations: np.ndarray, ref_id: int = 0,
    ref_position: np.ndarray | None = None, metric_scale: bool = False,
) -> np.ndarray:
    """Least-squares w2c translations from relative translations.

    edges: {(i, j): ((R_ij, t_ij), inliers)} or {(i, j): (T_ij 4x4,
    inliers)}; constraint t_j = R_ij t_i + t_ij.

    With metric_scale=False (the default; essential-matrix decompositions
    give only the DIRECTION of each t_ij), the per-edge scale is
    eliminated by projecting the constraint onto the complement of the
    measured direction — standard least-squares translation averaging —
    and the global scale is fixed by unit-scaling one edge. Returns (n, 3)."""
    n = rotations.shape[0]
    rows = []
    rhs = []

    def unpack(v):
        m = np.asarray(v, np.float64)
        if m.shape == (4, 4):
            return m[:3, :3], m[:3, 3]
        return np.asarray(v[0], np.float64), np.asarray(v[1], np.float64)

    first_edge = None
    for (i, j), (meas, _) in edges.items():
        R_ij, t_ij = unpack(meas)
        block = np.zeros((3, 3 * n))
        block[:, 3 * j : 3 * j + 3] = np.eye(3)
        block[:, 3 * i : 3 * i + 3] = -R_ij
        if metric_scale:
            rows.append(block)
            rhs.append(t_ij)
        else:
            norm = np.linalg.norm(t_ij)
            if norm < 1e-9:
                continue
            u = t_ij / norm
            P = np.eye(3) - np.outer(u, u)
            rows.append(P @ block)
            rhs.append(np.zeros(3))
            if first_edge is None:
                first_edge = (block, u)
    if not metric_scale and first_edge is not None:
        # Pin the global scale: the first edge's displacement along its
        # measured direction is 1.
        block, u = first_edge
        rows.append((u[None, :] @ block))
        rhs.append(np.ones(1))
    # Anchor the reference camera.
    anchor = np.zeros((3, 3 * n))
    anchor[:, 3 * ref_id : 3 * ref_id + 3] = np.eye(3) * 1e3
    rows.append(anchor)
    rhs.append(
        (np.zeros(3) if ref_position is None else np.asarray(ref_position)) * 1e3
    )

    A = np.concatenate(rows, axis=0)
    b = np.concatenate(rhs, axis=0)
    t, *_ = np.linalg.lstsq(A, b, rcond=None)
    return t.reshape(n, 3).astype(np.float32)


class PoseInitializer:
    """View-graph pose initialization (numpy).

    edges: {(i, j): (T_ij (4, 4) relative w2c transform T_j = T_ij T_i,
    num_inliers)}."""

    def __init__(self, edges: dict, num_poses: int, ref_id: int = 0,
                 ref_pose_w2c: np.ndarray | None = None,
                 metric_scale: bool = False):
        self.edges = edges
        self.num_poses = num_poses
        self.ref_id = ref_id
        self.metric_scale = metric_scale
        self.ref_pose = (
            np.eye(4, dtype=np.float32) if ref_pose_w2c is None else ref_pose_w2c
        )

    def init_poses_from_mst(self) -> np.ndarray:
        """Returns (n, 4, 4) CAMERA-TO-WORLD poses (the reference converts
        w2c -> c2w for ibrnet at pose_util.py:330-334)."""
        rot_edges = {
            k: (np.asarray(v[0])[:3, :3], v[1]) for k, v in self.edges.items()
        }
        R = mst_rotations(
            rot_edges, self.num_poses, self.ref_id, self.ref_pose[:3, :3]
        )
        t = solve_positions(self.edges, R, self.ref_id, self.ref_pose[:3, 3],
                            metric_scale=self.metric_scale)

        c2w = np.tile(np.eye(4, dtype=np.float32), (self.num_poses, 1, 1))
        c2w[:, :3, :3] = np.transpose(R, (0, 2, 1))
        c2w[:, :3, 3] = -np.einsum("nji,nj->ni", R, t)
        return c2w


def init_poses_from_noisy_gt(
    pose_gt_c2w: np.ndarray, noise_level: float = 0.15,
    outlier_ratio: float = 0.2, rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """Perturb GT poses with rotational/translational noise + se3 outliers
    (pose_util.py:340-380)."""
    from scipy.spatial.transform import Rotation

    rng = rng or np.random.RandomState(0)
    poses = np.array(pose_gt_c2w, np.float32, copy=True)
    n = poses.shape[0]

    so3 = rng.randn(n, 3) * noise_level
    eu3 = rng.randn(n, 3) * 0.2 * noise_level
    R_noise = Rotation.from_rotvec(so3).as_matrix().astype(np.float32)
    poses[:, :3, :3] = np.einsum("nij,njk->nik", R_noise, poses[:, :3, :3])
    poses[:, :3, 3] += eu3.astype(np.float32)

    n_out = int(n * outlier_ratio)
    if n_out > 0:
        idx = rng.permutation(n)[:n_out]
        se3 = rng.randn(n_out, 6) * 0.5
        R_out = Rotation.from_rotvec(se3[:, :3]).as_matrix().astype(np.float32)
        T_out = np.tile(np.eye(4, dtype=np.float32), (n_out, 1, 1))
        T_out[:, :3, :3] = R_out
        T_out[:, :3, 3] = se3[:, 3:]
        poses[idx] = np.einsum("nij,njk->nik", T_out, poses[idx])
    return poses
