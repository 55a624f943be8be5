"""The remaining reference dataset families (host-side numpy; the JAX
package's data/extra_datasets.py):
  * realestate.py          — RealEstate10K video-frame scenes
  * kitti.py               — KITTI odometry sequences
  * deepvoxels.py          — DeepVoxels synthetic objects
  * google_scanned_objects.py — Google Scanned Objects renderings
  * spaces_dataset.py      — Spaces light-field rigs (models.json)

Each emits the dual batch format of datasets.make_example. File formats,
windows and sampling follow the JAX package, draw for draw from numpy's
global generator; images are read with PIL and resized with OpenCV's
INTER_AREA weights in numpy (`image_io`).
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from .datasets import make_example, pack_camera
from .image_io import read_image, resize
from .view_selection import get_nearest_pose_ids


def _imread(path, target_hw=None):
    img = read_image(path).astype(np.float32)[..., :3] / 255.0
    if target_hw is not None and img.shape[:2] != tuple(target_hw):
        img = resize(img, target_hw, "area")
    return img


# --------------------------------------------------------------- realestate
class RealEstateCamera:
    """One line of a RealEstate10K camera file (ref realestate.py:25-37):
    timestamp fx fy cx cy k1 k2 then a 3x4 w2c matrix, intrinsics
    normalized by image size."""

    def __init__(self, entry):
        fx, fy, cx, cy = entry[1:5]
        self.intrinsics = np.array(
            [[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
            dtype=np.float64,
        )
        w2c = np.eye(4)
        w2c[:3, :] = np.array(entry[7:]).reshape(3, 4)
        self.c2w_mat = np.linalg.inv(w2c)


def parse_realestate_pose_file(path):
    cams = {}
    with open(path) as f:
        for i, line in enumerate(f):
            if i == 0:
                continue
            entry = [float(x) for x in line.split()]
            cams[int(entry[0])] = RealEstateCamera(entry)
    return cams


class RealEstateDataset:
    """RealEstate10K-subset training scenes (ref realestate.py:57-151)."""

    def __init__(
        self, rootdir: str, mode: str = "train", num_source_views: int = 5,
        image_size=(450, 800), window_size: int = 32, **_,
    ):
        self.folder_path = os.path.join(rootdir, "RealEstate10K-subset")
        self.mode = mode
        self.num_source_views = num_source_views
        self.image_size = tuple(image_size)
        self.window_size = window_size

        scene_paths = sorted(
            glob.glob(os.path.join(self.folder_path, mode, "frames", "*"))
        )
        self.all_rgb_files, self.all_timestamps = [], []
        for scene_path in scene_paths:
            files = sorted(
                os.path.join(scene_path, f) for f in os.listdir(scene_path)
            )
            if len(files) < 10:
                continue
            ts = np.array([int(os.path.basename(f).split(".")[0]) for f in files])
            order = np.argsort(ts)
            self.all_rgb_files.append(np.array(files)[order])
            self.all_timestamps.append(ts[order])

    def __len__(self):
        return len(self.all_rgb_files)

    def __getitem__(self, idx):
        rgb_files = self.all_rgb_files[idx]
        timestamps = self.all_timestamps[idx]
        num_frames = len(rgb_files)
        w = self.window_size

        shift = np.random.randint(low=-1, high=2)
        lo = min(4, num_frames - 2)
        id_render = np.random.randint(low=lo, high=max(lo + 1, num_frames - 5))
        right = min(id_render + w + shift, num_frames - 1)
        left = max(0, right - 2 * w)
        candidates = np.arange(left, right)
        if np.random.choice([0, 1], p=[0.01, 0.99]):
            candidates = candidates[candidates != id_render]
        id_feat = np.random.choice(
            candidates, size=min(self.num_source_views, len(candidates)),
            replace=False,
        )

        cam_file = (
            os.path.dirname(rgb_files[id_render]).replace("frames", "cameras")
            + ".txt"
        )
        cams = parse_realestate_pose_file(cam_file)
        h, w_ = self.image_size

        def unnorm(K):
            K = K.copy()
            K[0] *= w_
            K[1] *= h
            return K

        rgb = _imread(rgb_files[id_render], self.image_size)
        cam = cams[timestamps[id_render]]
        K = unnorm(cam.intrinsics)
        camera = pack_camera(self.image_size, K, cam.c2w_mat)

        src_rgbs, src_cams, src_in, src_ex = [], [], [], []
        for i in id_feat:
            src_rgbs.append(_imread(rgb_files[i], self.image_size))
            c = cams[timestamps[i]]
            Ks = unnorm(c.intrinsics)
            src_cams.append(pack_camera(self.image_size, Ks, c.c2w_mat))
            src_in.append(Ks[:3, :3])
            src_ex.append(c.c2w_mat)
        return make_example(
            rgb, camera, rgb_files[id_render], np.stack(src_rgbs),
            np.stack(src_cams), (1.0, 100.0),
            np.stack(src_ex).astype(np.float32),
            cam.c2w_mat[None].astype(np.float32),
            np.stack(src_in), K[None, :3, :3], id_feat, 0, self.image_size,
        )


# -------------------------------------------------------------------- kitti
def read_kitti_poses(path):
    """KITTI odometry poses file: one 3x4 cam0-to-world per line."""
    mats = []
    with open(path) as f:
        for line in f:
            vals = np.fromstring(line, sep=" ")
            if vals.size != 12:
                continue
            m = np.eye(4)
            m[:3, :] = vals.reshape(3, 4)
            mats.append(m)
    return np.stack(mats)


def read_kitti_calib(path, cam: int = 2):
    """calib.txt rows 'Px: <12 vals>'; returns the 3x3 K of camera `cam`
    (ref kitti.py:174-183 uses row 2 = P2)."""
    rows = np.genfromtxt(path)[:, 1:]
    P = rows[cam].reshape(3, 4)
    return P[:, :3].copy()


class KittiDataset:
    """KITTI odometry sequences (ref kitti.py:77-415): image_2 frames,
    poses/<scene>.txt c2w chains, timestep-windowed source selection,
    llffhold test split."""

    ORIGINAL_SIZE = (376, 1241)

    def __init__(
        self, rootdir: str, mode: str = "train", scenes=(),
        num_source_views: int = 5, image_size=(176, 608), llffhold: int = 8,
        start_timestep: int = 0, end_timestep: int = -1, max_view_dist: int = 4,
        **_,
    ):
        self.data_path = os.path.join(rootdir, "kitti")
        self.mode = mode
        self.num_source_views = num_source_views
        self.image_size = tuple(image_size)
        self.max_view_dist = max_view_dist

        if isinstance(scenes, str):
            scenes = [scenes]
        if not scenes:
            scenes = sorted(os.listdir(os.path.join(self.data_path, "sequences")))

        self.render_rgb_files = []
        self.render_poses = []
        self.render_intrinsics = []
        self.render_ids = []
        self.render_train_set_ids = []
        self.train_rgb_files = []
        self.train_poses = []
        self.train_intrinsics = []

        for i, scene in enumerate(scenes):
            scene_path = os.path.join(self.data_path, "sequences", f"{scene}")
            img_dir = os.path.join(scene_path, "image_2")
            frames = sorted(os.listdir(img_dir))
            end = len(frames) if end_timestep < 0 else min(end_timestep, len(frames))
            frames = frames[start_timestep:end]
            files = [os.path.join(img_dir, f) for f in frames]

            K = read_kitti_calib(os.path.join(scene_path, "calib.txt"))
            sy = self.image_size[0] / self.ORIGINAL_SIZE[0]
            sx = self.image_size[1] / self.ORIGINAL_SIZE[1]
            K = K * np.array([[sx], [sy], [1.0]])
            K4 = np.eye(4)
            K4[:3, :3] = K

            c2w = read_kitti_poses(
                os.path.join(self.data_path, "poses", f"{scene}.txt")
            )[start_timestep:end]

            ids = np.arange(len(files))
            i_test = ids[:: llffhold] if mode != "eval_pose" else np.array([], int)
            i_train = np.array([j for j in ids if j not in i_test])
            i_render = i_train if mode in ("train", "eval_pose") else i_test

            self.train_rgb_files.append([files[j] for j in i_train])
            self.train_poses.append(c2w[i_train])
            self.train_intrinsics.append(np.tile(K4[None], (len(i_train), 1, 1)))
            self.render_rgb_files.extend([files[j] for j in i_render])
            self.render_poses.extend(c2w[i_render])
            self.render_intrinsics.extend([K4] * len(i_render))
            self.render_ids.extend(i_render)
            self.render_train_set_ids.extend([i] * len(i_render))

    def __len__(self):
        return len(self.render_rgb_files)

    def __getitem__(self, idx):
        idx = idx % len(self.render_rgb_files)
        rgb = _imread(self.render_rgb_files[idx], self.image_size)
        pose = self.render_poses[idx]
        K4 = self.render_intrinsics[idx]
        tsid = self.render_train_set_ids[idx]
        train_files = self.train_rgb_files[tsid]
        train_poses = self.train_poses[tsid]

        # Timestep-windowed candidates (driving scenes: nearby frames only),
        # mirroring the waymo/kitti window strategy.
        rid = self.render_ids[idx]
        train_ids = np.array(
            [int(os.path.splitext(os.path.basename(f))[0]) for f in train_files]
        )
        window = np.where(np.abs(train_ids - rid) <= self.max_view_dist)[0]
        window = window[train_ids[window] != rid]
        if len(window) == 0:
            window = np.argsort(np.abs(train_ids - rid))[:self.num_source_views]
        if len(window) > self.num_source_views:
            sub = get_nearest_pose_ids(
                pose, train_poses[window], self.num_source_views,
                tar_id=-1, angular_dist_method="dist",
            )
            window = window[sub]

        camera = pack_camera(self.image_size, K4, pose)
        src_rgbs, src_cams, src_in, src_ex = [], [], [], []
        for s in window:
            src_rgbs.append(_imread(train_files[s], self.image_size))
            src_cams.append(pack_camera(self.image_size, K4, train_poses[s]))
            src_in.append(K4[:3, :3])
            src_ex.append(train_poses[s])
        return make_example(
            rgb, camera, self.render_rgb_files[idx], np.stack(src_rgbs),
            np.stack(src_cams), (1.0, 100.0),
            np.stack(src_ex).astype(np.float32), pose[None].astype(np.float32),
            np.stack(src_in), K4[None, :3, :3], window, tsid, self.image_size,
        )


# --------------------------------------------------------------- deepvoxels
def deepvoxels_parse_intrinsics(path, target_size):
    """First line: f cx cy; file encodes a `side` (ref data_utils)."""
    with open(path) as f:
        first = f.readline()
        f_, cx, cy = [float(x) for x in first.split()[:3]]
        lines = f.read().split("\n")
        side = None
        for line in reversed(lines):
            toks = line.split()
            if toks:
                side = float(toks[0])
                break
    scale = target_size / (side if side else target_size)
    K = np.array(
        [[f_ * scale, 0, cx * scale, 0], [0, f_ * scale, cy * scale, 0],
         [0, 0, 1, 0], [0, 0, 0, 1]]
    )
    return K


class DeepVoxelsDataset:
    """DeepVoxels objects (ref deepvoxels.py:27-140)."""

    def __init__(
        self, rootdir: str, mode: str = "train", scenes="vase",
        num_source_views: int = 5, testskip: int = 8, image_size=(512, 512), **_,
    ):
        self.folder_path = os.path.join(rootdir, "deepvoxels")
        self.subset = {"test": "test", "validation": "validation"}.get(mode, "train")
        self.mode = mode
        self.num_source_views = num_source_views
        self.image_size = tuple(image_size)

        if isinstance(scenes, str):
            scenes = [scenes]
        self.all_rgb_files, self.all_pose_files, self.all_intrinsics_files = [], [], []
        self.scene_paths = []
        for scene in scenes:
            scene_path = os.path.join(self.folder_path, self.subset, scene)
            rgb_files = [
                os.path.join(scene_path, "rgb", f)
                for f in sorted(os.listdir(os.path.join(scene_path, "rgb")))
            ]
            if self.subset != "train":
                rgb_files = rgb_files[::testskip]
            pose_files = [
                f.replace("rgb", "pose").replace("png", "txt") for f in rgb_files
            ]
            intr = os.path.join(scene_path, "intrinsics.txt")
            self.all_rgb_files.extend(rgb_files)
            self.all_pose_files.extend(pose_files)
            self.all_intrinsics_files.extend([intr] * len(rgb_files))
            self.scene_paths.extend([scene_path] * len(rgb_files))

    def __len__(self):
        return len(self.all_rgb_files)

    def __getitem__(self, idx):
        idx = idx % len(self.all_rgb_files)
        rgb_file = self.all_rgb_files[idx]
        pose_file = self.all_pose_files[idx]
        K4 = deepvoxels_parse_intrinsics(
            self.all_intrinsics_files[idx], self.image_size[0]
        )

        scene_path = self.scene_paths[idx]
        train_dir = scene_path.replace(f"/{self.subset}/", "/train/")
        train_rgb_files = sorted(glob.glob(os.path.join(train_dir, "rgb", "*")))
        train_pose_files = [
            f.replace("rgb", "pose").replace("png", "txt") for f in train_rgb_files
        ]
        train_poses = np.stack(
            [np.loadtxt(f).reshape(4, 4) for f in train_pose_files]
        )

        if self.subset == "train":
            id_render = train_pose_files.index(pose_file)
            subsample = np.random.choice(np.arange(1, 5))
            n_src = np.random.randint(
                low=max(1, self.num_source_views - 4), high=self.num_source_views + 2
            )
        else:
            id_render, subsample, n_src = -1, 1, self.num_source_views
        n_src = min(n_src, max(1, len(train_rgb_files) - 1))

        rgb = _imread(rgb_file, self.image_size)
        render_pose = np.loadtxt(pose_file).reshape(4, 4)
        nearest = get_nearest_pose_ids(
            render_pose, train_poses,
            min(n_src * subsample, 40, len(train_poses) - (id_render >= 0)),
            tar_id=id_render, angular_dist_method="vector",
        )
        nearest = np.random.choice(nearest, n_src, replace=False)

        camera = pack_camera(self.image_size, K4, render_pose)
        src_rgbs, src_cams, src_in, src_ex = [], [], [], []
        for s in nearest:
            src_rgbs.append(_imread(train_rgb_files[s], self.image_size))
            src_cams.append(pack_camera(self.image_size, K4, train_poses[s]))
            src_in.append(K4[:3, :3])
            src_ex.append(train_poses[s])

        origin_depth = np.linalg.inv(render_pose)[2, 3]
        span = 1.0 if "cube" in rgb_file else 0.8
        depth_range = (origin_depth - span, origin_depth + span)
        return make_example(
            rgb, camera, rgb_file, np.stack(src_rgbs), np.stack(src_cams),
            depth_range, np.stack(src_ex).astype(np.float32),
            render_pose[None].astype(np.float32), np.stack(src_in),
            K4[None, :3, :3], nearest, 0, self.image_size,
        )


# ----------------------------------------------------- google scanned objects
class GoogleScannedDataset:
    """Google Scanned Objects renderings (ref google_scanned_objects.py:29-162,
    train-only; the reference's view-graph selection path needs offline SfM
    artifacts, the pose-distance path is the default here)."""

    def __init__(
        self, rootdir: str, mode: str = "train", num_source_views: int = 5,
        image_size=(512, 512), min_files: int = 250, **_,
    ):
        self.folder_path = os.path.join(rootdir, "google_scanned_objects")
        self.num_source_views = num_source_views
        self.image_size = tuple(image_size)

        self.all_rgb_files, self.all_pose_files, self.all_intr_files = [], [], []
        for scene_path in sorted(glob.glob(os.path.join(self.folder_path, "*"))):
            rgb_files = [
                os.path.join(scene_path, "images", f)
                for f in sorted(os.listdir(os.path.join(scene_path, "images")))
            ]
            pose_files = [
                f.replace("images", "pose").replace("png", "txt") for f in rgb_files
            ]
            intr_files = [
                f.replace("images", "intrinsics").replace("png", "txt")
                for f in rgb_files
            ]
            if len(rgb_files) < min_files:
                continue
            self.all_rgb_files.append(rgb_files)
            self.all_pose_files.append(pose_files)
            self.all_intr_files.append(intr_files)

    def __len__(self):
        return len(self.all_rgb_files)

    def __getitem__(self, idx):
        rgb_files = self.all_rgb_files[idx]
        pose_files = self.all_pose_files[idx]
        intr_files = self.all_intr_files[idx]

        id_render = np.random.choice(np.arange(len(rgb_files)))
        train_poses = np.stack(
            [np.loadtxt(f).reshape(4, 4) for f in pose_files]
        )
        render_pose = train_poses[id_render]
        num_select = self.num_source_views + np.random.randint(low=-2, high=3)
        num_select = max(1, min(num_select, len(rgb_files) - 1))

        pool = get_nearest_pose_ids(
            render_pose, train_poses, num_select, tar_id=id_render,
            angular_dist_method="vector",
        )
        id_feat = np.random.choice(
            pool, min(self.num_source_views, len(pool)), replace=False
        )
        if np.random.choice([0, 1], p=[0.995, 0.005]):
            id_feat[np.random.choice(len(id_feat))] = id_render

        rgb = _imread(rgb_files[id_render], self.image_size)
        K4 = np.eye(4)
        K4_flat = np.loadtxt(intr_files[id_render])
        K4 = K4_flat.reshape(4, 4) if K4_flat.size == 16 else K4
        camera = pack_camera(self.image_size, K4, render_pose)

        origin_depth = np.linalg.inv(render_pose)[2, 3]
        max_radius = 0.5 * np.sqrt(2) * 1.1
        near = max(origin_depth - max_radius, 0.1 * origin_depth)
        far = origin_depth + max_radius

        src_rgbs, src_cams, src_in, src_ex = [], [], [], []
        for s in id_feat:
            src_rgbs.append(_imread(rgb_files[s], self.image_size))
            Ks_flat = np.loadtxt(intr_files[s])
            Ks = Ks_flat.reshape(4, 4) if Ks_flat.size == 16 else np.eye(4)
            src_cams.append(pack_camera(self.image_size, Ks, train_poses[s]))
            src_in.append(Ks[:3, :3])
            src_ex.append(train_poses[s])
        return make_example(
            rgb, camera, rgb_files[id_render], np.stack(src_rgbs),
            np.stack(src_cams), (near, far),
            np.stack(src_ex).astype(np.float32),
            render_pose[None].astype(np.float32), np.stack(src_in),
            K4[None, :3, :3], id_feat, 0, self.image_size,
        )


# ------------------------------------------------------------------- spaces
def _spaces_c2w(view_json):
    """position + axis-angle orientation -> world-from-camera (ref
    spaces_dataset.py:152-173)."""
    from scipy.spatial.transform import Rotation

    transform = np.eye(4)
    transform[:3, 3] = view_json["position"]
    aa = np.array(view_json["orientation"])
    angle = np.linalg.norm(aa)
    axis = aa / angle if angle > 1e-12 else np.array([1.0, 0.0, 0.0])
    # The json stores the world-to-camera rotation; invert.
    R = Rotation.from_rotvec(axis * angle).as_matrix()
    transform[:3, :3] = R.T
    return transform


def _spaces_intrinsics(view_json):
    K = np.eye(4)
    K[0, 0] = view_json["focal_length"]
    K[1, 1] = view_json["focal_length"] * view_json["pixel_aspect_ratio"]
    K[0, 2] = view_json["principal_point"][0]
    K[1, 2] = view_json["principal_point"][1]
    return K


def read_spaces_scene(base_dir):
    """models.json -> list of rigs, each a list of view dicts with
    image_path/shape/K/c2w."""
    with open(os.path.join(base_dir, "models.json")) as f:
        model_json = json.load(f)
    rigs = []
    for views in model_json:
        rig = []
        for vj in views:
            rig.append(
                {
                    "image_path": os.path.join(base_dir, vj["relative_path"]),
                    "shape": (int(vj["height"]), int(vj["width"])),
                    "K": _spaces_intrinsics(vj),
                    "c2w": _spaces_c2w(vj),
                }
            )
        rigs.append(rig)
    return rigs


class SpacesFreeDataset:
    """Spaces light-field rigs with free view selection (ref
    spaces_dataset.py:278-472, SpacesFreeDataset variant: nearest cameras
    across all rigs by pose distance)."""

    def __init__(
        self, rootdir: str, mode: str = "train", num_source_views: int = 5,
        image_size=(480, 800), **_,
    ):
        self.folder_path = os.path.join(rootdir, "spaces_dataset", "data", "800")
        self.num_source_views = num_source_views
        self.image_size = tuple(image_size)
        self.mode = mode
        scene_dirs = sorted(glob.glob(os.path.join(self.folder_path, "scene_*")))
        self.scenes = [read_spaces_scene(d) for d in scene_dirs]
        self.index = [
            (si, ri, vi)
            for si, rigs in enumerate(self.scenes)
            for ri, rig in enumerate(rigs)
            for vi in range(len(rig))
        ]

    def __len__(self):
        return len(self.index)

    def __getitem__(self, idx):
        si, ri, vi = self.index[idx % len(self.index)]
        rigs = self.scenes[si]
        target = rigs[ri][vi]
        all_views = [v for rig in rigs for v in rig if v is not target]
        poses = np.stack([v["c2w"] for v in all_views])

        nearest = get_nearest_pose_ids(
            target["c2w"], poses, self.num_source_views, tar_id=-1,
            angular_dist_method="dist",
        )

        def load(view):
            img = _imread(view["image_path"], self.image_size)
            K = view["K"].copy()
            K[0] *= self.image_size[1] / view["shape"][1]
            K[1] *= self.image_size[0] / view["shape"][0]
            return img, K

        rgb, K = load(target)
        camera = pack_camera(self.image_size, K, target["c2w"])
        src_rgbs, src_cams, src_in, src_ex = [], [], [], []
        for s in nearest:
            img, Ks = load(all_views[s])
            src_rgbs.append(img)
            src_cams.append(pack_camera(self.image_size, Ks, all_views[s]["c2w"]))
            src_in.append(Ks[:3, :3])
            src_ex.append(all_views[s]["c2w"])
        return make_example(
            rgb, camera, target["image_path"], np.stack(src_rgbs),
            np.stack(src_cams), (1.0, 100.0),
            np.stack(src_ex).astype(np.float32),
            target["c2w"][None].astype(np.float32),
            np.stack(src_in), K[None, :3, :3], nearest, si, self.image_size,
        )
