"""Waymo driving scenes (host-side numpy; the reference's waymo.py
WaymoStaticDataset, the JAX package's data/waymo.py): per-camera
calibration txt files, the opencv->waymo axis change, ego poses chained
from the first timestep, train 352x480 / test 640x960."""
from __future__ import annotations

import os

import numpy as np

from .datasets import make_example, pack_camera
from .image_io import read_image, resize
from .view_selection import get_nearest_pose_ids

ORIGINAL_SIZE = [[1280, 1920], [1280, 1920], [1280, 1920], [884, 1920], [884, 1920]]
# opencv (x right, y down, z front) -> waymo (x front, y left, z up)
OPENCV2DATASET = np.array([[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], dtype=np.float64)


def load_calibrations(scene_path: str, image_size, camera_list=(0,), start_timestep: int = 0,
                      end_timestep: int = 197):
    """(intrinsics (n, 4, 4), cam_to_worlds (n, 4, 4)), timestep-major
    (waymo.py:154-230)."""
    _intrinsics = []
    cam_to_egos = []
    for i in camera_list:
        intr = np.loadtxt(os.path.join(scene_path, "intrinsics", f"{i}.txt"))
        fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
        fx = fx * image_size[1] / ORIGINAL_SIZE[i][1]
        fy = fy * image_size[0] / ORIGINAL_SIZE[i][0]
        cx = cx * image_size[1] / ORIGINAL_SIZE[i][1]
        cy = cy * image_size[0] / ORIGINAL_SIZE[i][0]
        _intrinsics.append(np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
        cam_to_ego = np.loadtxt(os.path.join(scene_path, "extrinsics", f"{i}.txt"))
        cam_to_egos.append(cam_to_ego @ OPENCV2DATASET)

    ego_start = np.loadtxt(os.path.join(scene_path, "ego_pose", f"{start_timestep:03d}.txt"))
    intrinsics, c2ws = [], []
    for t in range(start_timestep, end_timestep):
        ego_now = np.loadtxt(os.path.join(scene_path, "ego_pose", f"{t:03d}.txt"))
        ego_to_world = np.linalg.inv(ego_start) @ ego_now
        for ci in range(len(camera_list)):
            c2ws.append(ego_to_world @ cam_to_egos[ci])
            intrinsics.append(_intrinsics[ci])
    return np.stack(intrinsics), np.stack(c2ws)


class WaymoStaticDataset:
    def __init__(self, rootdir: str, mode: str, scenes=(), num_source_views: int = 5, camera_list=(0,),
                 start_timestep: int = 0, end_timestep: int = 197, testhold: int = 8):
        self.folder_path = rootdir
        self.mode = mode
        self.num_source_views = num_source_views
        self.image_size = (352, 480) if mode == "train" else (640, 960)

        if isinstance(scenes, str):
            scenes = [scenes]
        if not scenes:
            scenes = sorted(os.listdir(self.folder_path))

        self.render_rgb_files = []
        self.render_intrinsics = []
        self.render_poses = []
        self.render_train_set_ids = []
        self.render_depth_range = []
        self.train_intrinsics = []
        self.train_poses = []
        self.train_rgb_files = []

        for i, scene in enumerate(scenes):
            scene_path = os.path.join(self.folder_path, str(scene))
            rgb_files, i_test, count = [], [], 0
            for t in range(start_timestep, end_timestep):
                for cam_idx in camera_list:
                    if cam_idx == 0:
                        i_test.append(count)
                    rgb_files.append(os.path.join(scene_path, "images", f"{t:03d}_{cam_idx}.jpg"))
                    count += 1
            intrinsics, c2w_mats = load_calibrations(scene_path, self.image_size, camera_list,
                                                     start_timestep, end_timestep)
            i_test = i_test[::testhold]
            i_train = np.array([j for j in range(len(rgb_files)) if j not in i_test])
            i_render = i_train if mode == "train" else np.array(i_test)

            self.train_intrinsics.append(intrinsics[i_train])
            self.train_poses.append(c2w_mats[i_train])
            self.train_rgb_files.append(np.array(rgb_files)[i_train].tolist())
            self.render_rgb_files.extend(np.array(rgb_files)[i_render].tolist())
            self.render_intrinsics.extend(intrinsics[i_render])
            self.render_poses.extend(c2w_mats[i_render])
            self.render_depth_range.extend([[0.1, 100.0]] * len(i_render))
            self.render_train_set_ids.extend([i] * len(i_render))

    def __len__(self):
        return len(self.render_rgb_files)

    def _load(self, path):
        return resize(read_image(path).astype(np.float32)[..., :3] / 255.0, self.image_size, "linear")

    def __getitem__(self, idx):
        idx = idx % len(self.render_rgb_files)
        rgb_file = self.render_rgb_files[idx]
        rgb = self._load(rgb_file)
        pose = self.render_poses[idx]
        intrinsics = self.render_intrinsics[idx]

        tsid = self.render_train_set_ids[idx]
        train_files = self.train_rgb_files[tsid]
        train_poses = self.train_poses[tsid]
        train_intr = self.train_intrinsics[tsid]

        id_render = train_files.index(rgb_file) if rgb_file in train_files else -1
        nearest = get_nearest_pose_ids(pose, train_poses, self.num_source_views, tar_id=id_render,
                                       angular_dist_method="dist")

        camera = pack_camera(self.image_size, intrinsics, pose)
        src_rgbs, src_cams, src_in, src_ex = [], [], [], []
        for sid in nearest:
            src_rgbs.append(self._load(train_files[sid]))
            src_cams.append(pack_camera(self.image_size, train_intr[sid], train_poses[sid]))
            src_in.append(train_intr[sid][:3, :3])
            src_ex.append(train_poses[sid])
        return make_example(
            rgb, camera, rgb_file, np.stack(src_rgbs), np.stack(src_cams), (0.1, 100.0),
            np.stack(src_ex).astype(np.float32), pose[None].astype(np.float32),
            np.stack(src_in), intrinsics[None, :3, :3], nearest, tsid, self.image_size,
        )
