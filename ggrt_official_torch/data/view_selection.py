"""Source-view selection (host-side numpy; reference
data_loaders/data_utils.py:290-352): get_nearest_pose_ids with the
"matrix", "vector" and "dist" metrics, and view-graph selection.

The ids come from np.argsort, as in the JAX package, so ties fall the same
way in both.
"""
from __future__ import annotations

import heapq

import numpy as np

TINY_NUMBER = 1e-6


def angular_dist_between_2_vectors(vec1, vec2):
    vec1_unit = vec1 / (np.linalg.norm(vec1, axis=1, keepdims=True) + TINY_NUMBER)
    vec2_unit = vec2 / (np.linalg.norm(vec2, axis=1, keepdims=True) + TINY_NUMBER)
    return np.arccos(np.clip(np.sum(vec1_unit * vec2_unit, axis=-1), -1.0, 1.0))


def batched_angular_dist_rot_matrix(R1, R2):
    """Angular distance between batches of rotation matrices."""
    return np.arccos(
        np.clip(
            (np.trace(np.matmul(R2.transpose(0, 2, 1), R1), axis1=1, axis2=2) - 1) / 2.0,
            -1 + TINY_NUMBER,
            1 - TINY_NUMBER,
        )
    )


def get_nearest_pose_ids(tar_pose, ref_poses, num_select, tar_id=-1, angular_dist_method="vector",
                         scene_center=(0, 0, 0)):
    """The `num_select` reference views nearest to the target, never the
    target itself (`tar_id`): by rotation angle ("matrix"), by the angle
    between the camera centres seen from `scene_center` ("vector"), or by
    the distance between camera centres ("dist").

    tar_pose: (4, 4) c2w; ref_poses: (n, 4, 4) c2w.
    """
    num_cams = len(ref_poses)
    num_select = min(num_select, num_cams - 1)
    batched_tar_pose = tar_pose[None, ...].repeat(num_cams, 0)

    if angular_dist_method == "matrix":
        dists = batched_angular_dist_rot_matrix(batched_tar_pose[:, :3, :3], ref_poses[:, :3, :3])
    elif angular_dist_method == "vector":
        center = np.array(scene_center)[None, ...]
        dists = angular_dist_between_2_vectors(batched_tar_pose[:, :3, 3] - center,
                                               ref_poses[:, :3, 3] - center)
    elif angular_dist_method == "dist":
        dists = np.linalg.norm(batched_tar_pose[:, :3, 3] - ref_poses[:, :3, 3], axis=1)
    else:
        raise ValueError(f"unknown angular_dist_method: {angular_dist_method}")

    if tar_id >= 0:
        if not tar_id < num_cams:
            raise ValueError(f"tar_id {tar_id} out of range for {num_cams} cameras")
        dists[tar_id] = 1e3  # never select the target itself
    return np.argsort(dists)[:num_select]


def get_nearby_view_ids(target_id: int, graph, idx_to_node_id: dict, node_id_to_idx: dict,
                        num_select: int):
    """View-graph source selection (ref data_utils.py:329-352): `graph` has
    `neighbors(node)` and edge weights as graph[u][v]['weight']
    (networkx-compatible); a higher weight (stronger covisibility) comes
    first."""
    target_node_id = idx_to_node_id[target_id]
    heap = []
    for j in graph.neighbors(target_node_id):
        if j not in node_id_to_idx:
            continue
        priority = int((1.0 / graph[target_node_id][j]["weight"]) * 1e5)
        heapq.heappush(heap, (priority, j))

    select_ids = []
    while heap and len(select_ids) < num_select:
        _, node = heapq.heappop(heap)
        select_ids.append(node_id_to_idx[node])
    return np.array(select_ids)
