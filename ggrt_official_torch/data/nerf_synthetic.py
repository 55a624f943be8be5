"""NeRF-synthetic (Blender) dataset (host-side numpy; the reference's
nerf_synthetic.py, the JAX package's data/nerf_synthetic.py):
transforms_{split}.json with camera_angle_x and per-frame c2w matrices,
RGBA pngs composited on white, fixed near/far (2, 6), and the
blender->opencv column flip."""
from __future__ import annotations

import json
import os

import numpy as np

from .datasets import make_example, pack_camera
from .image_io import read_image
from .view_selection import get_nearest_pose_ids


class NerfSyntheticDataset:
    def __init__(self, rootdir: str, mode: str, scenes=("lego",), num_source_views: int = 5,
                 testskip: int = 8):
        self.folder_path = os.path.join(rootdir, "nerf_synthetic")
        self.mode = "val" if mode == "validation" else mode
        self.num_source_views = num_source_views

        if isinstance(scenes, str):
            scenes = [scenes]

        self.render_rgb_files = []
        self.render_poses = []
        self.render_intrinsics = []
        self.render_train_set_ids = []
        self.train_rgb_files = []
        self.train_poses = []
        self.train_intrinsics = []

        for i, scene in enumerate(scenes):
            scene_path = os.path.join(self.folder_path, scene)
            train_files, train_poses, train_K = self._read_split(scene_path, "train", 1)
            split = "train" if self.mode == "train" else "test"
            skip = 1 if self.mode == "train" else testskip
            files, poses, K = self._read_split(scene_path, split, skip)

            self.train_rgb_files.append(train_files)
            self.train_poses.append(train_poses)
            self.train_intrinsics.append(train_K)
            self.render_rgb_files.extend(files)
            self.render_poses.extend(poses)
            self.render_intrinsics.extend([K[0]] * len(files))
            self.render_train_set_ids.extend([i] * len(files))

    @staticmethod
    def _read_split(scene_path: str, split: str, skip: int):
        with open(os.path.join(scene_path, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        frames = meta["frames"][::skip]
        files, poses = [], []
        for frame in frames:
            files.append(os.path.join(scene_path, frame["file_path"] + ".png"))
            c2w = np.array(frame["transform_matrix"], np.float64)
            c2w[:, 1:3] *= -1  # blender -> opencv
            poses.append(c2w)
        h, w = read_image(files[0]).shape[:2]
        focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        K = np.array([[focal, 0, w / 2, 0], [0, focal, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
        return files, np.stack(poses), np.tile(K[None], (len(files), 1, 1))

    def __len__(self):
        return len(self.render_rgb_files)

    @staticmethod
    def _load_rgb(path):
        img = read_image(path).astype(np.float32) / 255.0
        if img.shape[-1] == 4:  # composite RGBA on white
            img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
        return img

    def __getitem__(self, idx):
        idx = idx % len(self.render_rgb_files)
        rgb = self._load_rgb(self.render_rgb_files[idx])
        pose = self.render_poses[idx]
        K = self.render_intrinsics[idx]
        h, w = rgb.shape[:2]

        tsid = self.render_train_set_ids[idx]
        train_files = self.train_rgb_files[tsid]
        train_poses = self.train_poses[tsid]
        train_K = self.train_intrinsics[tsid]

        rgb_file = self.render_rgb_files[idx]
        id_render = train_files.index(rgb_file) if rgb_file in train_files else -1
        nearest = get_nearest_pose_ids(pose, train_poses, self.num_source_views, tar_id=id_render,
                                       angular_dist_method="vector")

        camera = pack_camera((h, w), K, pose)
        src_rgbs = np.stack([self._load_rgb(train_files[s]) for s in nearest])
        src_cams = np.stack([pack_camera((h, w), train_K[s], train_poses[s]) for s in nearest])
        return make_example(
            rgb, camera, rgb_file, src_rgbs, src_cams, (2.0, 6.0),
            train_poses[nearest].astype(np.float32), pose[None].astype(np.float32),
            train_K[nearest][:, :3, :3], K[None, :3, :3], nearest, tsid, (h, w),
        )
