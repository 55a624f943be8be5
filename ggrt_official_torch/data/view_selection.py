"""Source-view selection (host-side numpy; reference
data_loaders/data_utils.py:290-328, get_nearest_pose_ids with the "dist"
metric, the one the synthetic scenes use; the angular metrics are not
ported yet)."""
from __future__ import annotations

import numpy as np


def get_nearest_pose_ids(tar_pose, ref_poses, num_select, tar_id=-1):
    """The `num_select` reference views whose camera centres lie nearest to
    the target's, never the target itself (`tar_id`).

    tar_pose: (4, 4) c2w; ref_poses: (n, 4, 4) c2w.
    """
    num_cams = len(ref_poses)
    num_select = min(num_select, num_cams - 1)
    dists = np.linalg.norm(tar_pose[None, :3, 3] - ref_poses[:, :3, 3], axis=1)
    if tar_id >= 0:
        if not tar_id < num_cams:
            raise ValueError(f"tar_id {tar_id} out of range for {num_cams} cameras")
        dists[tar_id] = 1e3
    return np.argsort(dists)[:num_select]
