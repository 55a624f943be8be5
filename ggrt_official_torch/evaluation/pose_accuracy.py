"""Absolute pose accuracy protocol on g2o files (the JAX package's
evaluation/pose_accuracy.py; the reference's
eval/eval_abs_pose_accuracy.py and the g2o parsing of
ggrt/geometry/utils.py): read VERTEX_SE3:QUAT absolute poses (and
EDGE_SE3:QUAT relative constraints), ATE-align the predictions to GT and
report rotation and translation error statistics. The parsing is numpy on
the host; the alignment runs on float32 CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.alignment import align_ate_c2b_use_a2b, evaluate_camera_alignment


def quat_to_rotmat(qwxyz: np.ndarray) -> np.ndarray:
    w, x, y, z = qwxyz
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def read_g2o_file(filename: str):
    """Parse VERTEX_SE3:QUAT lines -> (n, 7) rows [qw qx qy qz tx ty tz]
    indexed by node id (ref eval_abs_pose_accuracy.py:16-47), plus edges
    as (pairs (m, 2), rel (m, 7))."""
    poses_dict = {}
    edges = []
    with open(filename) as f:
        for line in f:
            data = line.split(" ")
            if data[0].startswith("VERTEX_SE3:QUAT"):
                idx = int(data[1])
                pose = np.array(
                    [float(data[8]), float(data[5]), float(data[6]), float(data[7]),
                     float(data[2]), float(data[3]), float(data[4])]
                )
                assert abs(np.linalg.norm(pose[:4]) - 1) < 1e-4
                poses_dict[idx] = pose
            elif data[0].startswith("EDGE_SE3:QUAT"):
                i, j = int(data[1]), int(data[2])
                rel = np.array(
                    [float(data[9]), float(data[6]), float(data[7]), float(data[8]),
                     float(data[3]), float(data[4]), float(data[5])]
                )
                edges.append(((i, j), rel))
    n = max(poses_dict) + 1 if poses_dict else 0
    absolute = np.zeros((n, 7))
    for k, v in poses_dict.items():
        absolute[k] = v
    pairs = np.array([e[0] for e in edges]) if edges else np.zeros((0, 2), int)
    rels = np.stack([e[1] for e in edges]) if edges else np.zeros((0, 7))
    return absolute, pairs, rels


def qt_rows_to_c2w(rows: np.ndarray) -> np.ndarray:
    """(n, 7) [qw qx qy qz tx ty tz] world->cam rows -> (n, 4, 4) c2w."""
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    for i, row in enumerate(rows):
        R = quat_to_rotmat(row[:4])
        t = row[4:]
        out[i, :3, :3] = R.T
        out[i, :3, 3] = -R.T @ t
    return out


def evaluate_g2o_pose_accuracy(pred_file: str, gt_file: str) -> dict:
    """Full eval_abs_pose_accuracy protocol on two g2o files."""
    pred_rows, _, _ = read_g2o_file(pred_file)
    gt_rows, _, _ = read_g2o_file(gt_file)
    n = min(len(pred_rows), len(gt_rows))
    pred = torch.tensor(qt_rows_to_c2w(pred_rows[:n]), dtype=torch.float32)
    gt = torch.tensor(qt_rows_to_c2w(gt_rows[:n]), dtype=torch.float32)
    aligned = align_ate_c2b_use_a2b(pred, gt)
    stats = evaluate_camera_alignment(aligned, gt)
    return {k: float(v) for k, v in stats.items()} | {"n_poses": int(n)}
