"""ScanNet dataset (host-side numpy; the reference's scannet.py, the JAX
package's data/scannet.py): color/<i>.jpg, pose/<i>.txt (c2w) and
intrinsic/intrinsic_color.txt; every frameskip-th frame, non-finite poses
left out, sources the nearest by camera distance."""
from __future__ import annotations

import os

import numpy as np

from .datasets import make_example, pack_camera
from .image_io import read_image, resize
from .view_selection import get_nearest_pose_ids


class ScannetDataset:
    def __init__(self, rootdir: str, mode: str, scenes=(), num_source_views: int = 5, frameskip: int = 10,
                 testhold: int = 8, image_size=(240, 320)):
        self.folder_path = os.path.join(rootdir, "scannet")
        self.mode = mode
        self.num_source_views = num_source_views
        self.image_size = image_size

        if isinstance(scenes, str):
            scenes = [scenes]
        if not scenes:
            scenes = sorted(os.listdir(self.folder_path))

        self.render_rgb_files = []
        self.render_poses = []
        self.render_intrinsics = []
        self.render_train_set_ids = []
        self.train_rgb_files = []
        self.train_poses = []
        self.train_intrinsics = []

        for i, scene in enumerate(scenes):
            scene_path = os.path.join(self.folder_path, scene)
            color_dir = os.path.join(scene_path, "color")
            pose_dir = os.path.join(scene_path, "pose")
            K = np.loadtxt(os.path.join(scene_path, "intrinsic", "intrinsic_color.txt"))[:4, :4]

            frames = sorted(int(os.path.splitext(f)[0]) for f in os.listdir(color_dir))[::frameskip]
            files, poses = [], []
            for fr in frames:
                pose = np.loadtxt(os.path.join(pose_dir, f"{fr}.txt"))
                if not np.isfinite(pose).all():
                    continue
                files.append(os.path.join(color_dir, f"{fr}.jpg"))
                poses.append(pose)
            poses = np.stack(poses)
            ids = np.arange(len(files))
            i_test = ids[::testhold]
            i_train = np.array([j for j in ids if j not in i_test])
            i_render = i_train if mode == "train" else i_test

            self.train_rgb_files.append([files[j] for j in i_train])
            self.train_poses.append(poses[i_train])
            self.train_intrinsics.append(np.tile(K[None], (len(i_train), 1, 1)))
            self.render_rgb_files.extend([files[j] for j in i_render])
            self.render_poses.extend(poses[i_render])
            self.render_intrinsics.extend([K] * len(i_render))
            self.render_train_set_ids.extend([i] * len(i_render))

    def __len__(self):
        return len(self.render_rgb_files)

    def _load(self, path, K):
        img = read_image(path).astype(np.float32)[..., :3] / 255.0
        h, w = img.shape[:2]
        sy = self.image_size[0] / h
        sx = self.image_size[1] / w
        img = resize(img, self.image_size, "linear")
        K = K.copy()
        K[0] *= sx
        K[1] *= sy
        return img, K

    def __getitem__(self, idx):
        idx = idx % len(self.render_rgb_files)
        rgb, K = self._load(self.render_rgb_files[idx], self.render_intrinsics[idx])
        pose = self.render_poses[idx]

        tsid = self.render_train_set_ids[idx]
        train_files = self.train_rgb_files[tsid]
        train_poses = self.train_poses[tsid]
        train_K = self.train_intrinsics[tsid]

        rgb_file = self.render_rgb_files[idx]
        id_render = train_files.index(rgb_file) if rgb_file in train_files else -1
        nearest = get_nearest_pose_ids(pose, train_poses, self.num_source_views, tar_id=id_render,
                                       angular_dist_method="dist")
        camera = pack_camera(self.image_size, K, pose)
        src_rgbs, src_cams, src_in, src_ex = [], [], [], []
        for s in nearest:
            img, Ks = self._load(train_files[s], train_K[s])
            src_rgbs.append(img)
            src_cams.append(pack_camera(self.image_size, Ks, train_poses[s]))
            src_in.append(Ks[:3, :3])
            src_ex.append(train_poses[s])
        return make_example(
            rgb, camera, rgb_file, np.stack(src_rgbs), np.stack(src_cams), (0.1, 10.0),
            np.stack(src_ex).astype(np.float32), pose[None].astype(np.float32),
            np.stack(src_in), K[None, :3, :3], nearest, tsid, self.image_size,
        )
