"""Datasets in the dual batch format (host-side numpy): LLFF-format scene
folders (`LLFFTestDataset`, the reference's llff_test.py) and synthetic
multi-view scenes.

`SyntheticPlanesDataset` renders textured alpha planes at fixed depths by
alpha compositing with exact pinhole geometry; each example carries both
the legacy IBRNet keys (rgb/camera/src_rgbs/src_cameras/depth_range) and
the pixelSplat context/target dicts, as the reference's llff_test.py does.
The same seed gives the same arrays as the JAX package's dataset.

Images are read with PIL and blurred and resized in numpy (`image_io`), so
no reader needs OpenCV or imageio.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .image_io import gaussian_blur, read_image
from .llff import batch_parse_llff_poses, load_llff_data, loader_resize
from .view_selection import get_nearest_pose_ids


def pack_camera(img_size, intrinsics4, c2w) -> np.ndarray:
    """34-vector camera: (h, w, K.flatten 16, c2w.flatten 16)."""
    return np.concatenate(
        [list(img_size), intrinsics4.flatten(), c2w.flatten()]
    ).astype(np.float32)


def normalize_intrinsics(intrinsics: np.ndarray, img_size) -> np.ndarray:
    """Pixel -> normalized intrinsics with centered principal point."""
    h, w = img_size
    out = intrinsics.copy()
    out[..., 0, 0] /= w
    out[..., 1, 1] /= h
    out[..., 0, 2] = 0.5
    out[..., 1, 2] = 0.5
    return out


def make_example(
    rgb, camera, rgb_file, src_rgbs, src_cameras, depth_range,
    src_extrinsics, extrinsics, src_intrinsics, intrinsics,
    nearest_pose_ids, train_set_id, image_size,
):
    """Assemble the dual-format example dict (llff_test.py:229-269)."""
    num_select = len(nearest_pose_ids)
    scale = 1.0
    if src_extrinsics.shape[0] == 2:
        a, b = src_extrinsics[:, :3, 3]
        scale = max(float(np.linalg.norm(a - b)), 1e-3)
        src_extrinsics = src_extrinsics.copy()
        extrinsics = extrinsics.copy()
        src_extrinsics[:, :3, 3] /= scale
        extrinsics[:, :3, 3] /= scale

    near = np.full((num_select,), depth_range[0] / scale, np.float32)
    far = np.full((num_select,), depth_range[1] / scale, np.float32)
    return {
        "rgb": rgb.astype(np.float32),
        "camera": camera.astype(np.float32),
        "rgb_path": rgb_file,
        "src_rgbs": src_rgbs.astype(np.float32),
        "src_cameras": src_cameras.astype(np.float32),
        "depth_range": np.asarray(depth_range, np.float32),
        "scaled_shape": (0, 0),
        "context": {
            "extrinsics": src_extrinsics.astype(np.float32),
            "intrinsics": normalize_intrinsics(src_intrinsics, image_size).astype(np.float32),
            "image": src_rgbs.transpose(0, 3, 1, 2).astype(np.float32),
            "near": near,
            "far": far,
            "index": np.asarray(nearest_pose_ids, np.int64),
        },
        "target": {
            "extrinsics": extrinsics.astype(np.float32),
            "intrinsics": normalize_intrinsics(intrinsics, image_size).astype(np.float32),
            "image": rgb.transpose(2, 0, 1)[None].astype(np.float32),
            "near": near[:1],
            "far": far[:1],
            "index": np.asarray([train_set_id], np.int64),
        },
    }


class LLFFScenes:
    """LLFF-format scene folders (poses_bounds.npy + images_N/) in the dual
    batch format (ref llff_test.py:30-287): every llffhold-th view is held
    out for test mode, the rest are the source pool; each example's sources
    are the pool's views nearest to the target ("dist"), without the
    target, read and resized to `image_size` with the loader's blur.

    With `skip_unreadable` a folder that load_llff_data refuses is left out
    (the multi-scene collections); else it raises."""

    def __init__(self, scene_dirs, mode: str, num_source_views: int = 5, llffhold: int = 8,
                 image_size=(320, 448), factor: int = 8, skip_unreadable: bool = False):
        self.mode = mode
        self.num_source_views = num_source_views
        self.image_size = image_size

        self.render_rgb_files = []
        self.render_intrinsics = []
        self.render_poses = []
        self.render_train_set_ids = []
        self.render_depth_range = []
        self.train_intrinsics = []
        self.train_poses = []
        self.train_rgb_files = []

        for scene_path in scene_dirs:
            try:
                _, poses, bds, _, _, rgb_files = load_llff_data(scene_path, factor=factor, load_imgs=False)
            except (FileNotFoundError, ValueError):
                if not skip_unreadable:
                    raise
                continue
            near_depth, far_depth = np.min(bds), np.max(bds)
            intrinsics, c2w_mats = batch_parse_llff_poses(poses)
            ids = np.arange(poses.shape[0])
            i_test = ids[::llffhold]
            i_train = np.array([j for j in ids if j not in i_test])
            i_render = i_train if mode == "train" else i_test

            self.render_train_set_ids.extend([len(self.train_poses)] * len(i_render))
            self.train_intrinsics.append(intrinsics[i_train])
            self.train_poses.append(c2w_mats[i_train])
            self.train_rgb_files.append(np.array(rgb_files)[i_train].tolist())
            self.render_rgb_files.extend(np.array(rgb_files)[i_render].tolist())
            self.render_intrinsics.extend(intrinsics[i_render])
            self.render_poses.extend(c2w_mats[i_render])
            self.render_depth_range.extend([[near_depth, far_depth]] * len(i_render))

    def __len__(self):
        return len(self.render_rgb_files)

    def __getitem__(self, idx):
        idx = idx % len(self.render_rgb_files)
        rgb_file = self.render_rgb_files[idx]
        rgb = read_image(rgb_file).astype(np.float32)[..., :3] / 255.0
        render_pose = self.render_poses[idx]
        intrinsics = self.render_intrinsics[idx]
        depth_range_raw = self.render_depth_range[idx]

        tsid = self.render_train_set_ids[idx]
        train_rgb_files = self.train_rgb_files[tsid]
        train_poses = self.train_poses[tsid]
        train_intrinsics = self.train_intrinsics[tsid]

        id_render = train_rgb_files.index(rgb_file) if rgb_file in train_rgb_files else -1
        nearest_pose_ids = get_nearest_pose_ids(render_pose, train_poses, self.num_source_views,
                                                tar_id=id_render, angular_dist_method="dist")

        camera = pack_camera(rgb.shape[:2], intrinsics, render_pose)
        src_rgbs, src_cameras, src_extr = [], [], []
        for sid in nearest_pose_ids:
            src_rgb = read_image(train_rgb_files[sid]).astype(np.float32)[..., :3] / 255.0
            src_rgbs.append(src_rgb)
            src_cameras.append(pack_camera(src_rgb.shape[:2], train_intrinsics[sid], train_poses[sid]))
            src_extr.append(train_poses[sid])

        rgb_r, camera_r, src_rgbs_r, src_cameras_r, intr3, src_intr3 = loader_resize(
            rgb, camera, np.stack(src_rgbs), np.stack(src_cameras), size=self.image_size)
        depth_range = (depth_range_raw[0] * 0.9, depth_range_raw[1] * 1.5)
        return make_example(
            rgb_r, camera_r, rgb_file, src_rgbs_r, src_cameras_r, depth_range,
            np.stack(src_extr).astype(np.float32), render_pose[None].astype(np.float32),
            src_intr3, intr3[None], nearest_pose_ids, tsid, self.image_size,
        )


class LLFFTestDataset(LLFFScenes):
    """Per-scene LLFF dataset under <rootdir>/nerf_llff_data/ (ref
    llff_test.py): `scenes` by name, all folders when empty."""

    def __init__(self, rootdir: str, mode: str, scenes=(), num_source_views: int = 5, llffhold: int = 8,
                 image_size=(320, 448), factor: int = 8):
        self.folder_path = os.path.join(rootdir, "nerf_llff_data/")
        if isinstance(scenes, str):
            scenes = [scenes]
        if not scenes:
            scenes = sorted(os.listdir(self.folder_path))
        super().__init__([os.path.join(self.folder_path, s) for s in scenes], mode, num_source_views,
                         llffhold, image_size, factor)


@dataclass
class SyntheticSceneSpec:
    """Field for field the JAX package's spec; its docstrings there explain
    each knob (alpha binarisation, camera rotation, texture octaves, focal
    length, plane depths and extents)."""

    n_views: int = 12
    image_size: tuple = (64, 96)
    n_planes: int = 4
    seed: int = 0
    binary_alpha: bool = False
    look_at_z: float | None = None
    rot_wobble_deg: float = 0.0
    arc_scale: float = 1.0
    texture_octaves: int = 1
    focal_factor: float = 1.2
    plane_depths: tuple = (2.0, 6.0)
    plane_span: str = "legacy"


def flagship_scene_spec(seed: int = 0, image_size=(64, 96), n_views: int = 12):
    """The flagship's pose-learning scene, field for field the JAX
    package's (its docstring there gives the reasons): binary alphas,
    6-degree wobble at arc 1.4 around z 4, 4 texture octaves, focal 0.7 of
    the width, planes at 1.5-8 that cover the frustum."""
    return SyntheticSceneSpec(
        n_views=n_views, image_size=image_size, seed=seed, binary_alpha=True,
        look_at_z=4.0, rot_wobble_deg=6.0, arc_scale=1.4,
        texture_octaves=4, focal_factor=0.7, plane_depths=(1.5, 8.0),
        plane_span="cover",
    )


class SyntheticPlanesDataset:
    """Procedural multi-view scene: textured alpha planes at fixed depths,
    cameras on an arc, exact pinhole projection."""

    def __init__(self, spec: SyntheticSceneSpec = SyntheticSceneSpec(),
                 mode: str = "train", num_source_views: int = 4, llffhold: int = 4):
        self.spec = spec
        self.mode = mode
        self.num_source_views = num_source_views
        rng = np.random.RandomState(spec.seed)
        h, w = spec.image_size

        def smooth_noise(shape, blur=9):
            return gaussian_blur(rng.rand(*shape).astype(np.float32), blur)

        def octave_noise(shape):
            """Equal-variance sum of noise octaves at blur sigmas 0.8·3^o,
            rescaled to [0, 1]."""
            if spec.texture_octaves <= 1:
                return smooth_noise(shape)
            acc = np.zeros(shape, np.float32)
            for o in range(spec.texture_octaves):
                layer = gaussian_blur(rng.rand(*shape).astype(np.float32), 0, 0.8 * 3.0**o)
                acc += (layer - layer.mean()) / max(layer.std(), 1e-6)
            acc /= spec.texture_octaves**0.5
            return np.clip(0.5 + 0.25 * acc, 0.0, 1.0)

        depths = np.linspace(spec.plane_depths[0], spec.plane_depths[1], spec.n_planes)
        self.planes = []
        for d in depths:
            tex = np.stack([octave_noise((128, 192)) for _ in range(3)], -1)
            alpha = (smooth_noise((128, 192)) > 0.5).astype(np.float32)
            if not spec.binary_alpha:
                alpha = np.clip(alpha * 0.9 + 0.05, 0, 1)
            if d == depths[-1]:
                alpha = np.ones_like(alpha)  # opaque background plane
            self.planes.append((d, tex, alpha))

        # Cameras: arc along x, looking +z (optionally rotated, see spec).
        self.poses = []
        for i in range(spec.n_views):
            t = (i / max(spec.n_views - 1, 1) - 0.5) * spec.arc_scale
            c2w = np.eye(4)
            c2w[0, 3] = t
            c2w[1, 3] = 0.1 * np.sin(3 * t)
            if spec.look_at_z is not None:
                c = c2w[:3, 3]
                f = np.array([0.0, 0.0, spec.look_at_z]) - c
                fn = np.linalg.norm(f)
                if fn <= 1e-6:
                    raise ValueError(f"camera {i} sits at the look_at point")
                f = f / fn
                r = np.cross([0.0, 1.0, 0.0], f)
                rn = np.linalg.norm(r)
                if rn <= 1e-6:
                    raise ValueError(f"camera {i} forward is parallel to up")
                r = r / rn
                u = np.cross(f, r)
                c2w[:3, :3] = np.stack([r, u, f], axis=1)
            if spec.rot_wobble_deg:
                a = np.deg2rad(spec.rot_wobble_deg)
                # Fixed base phases plus a small bounded per-seed jitter.
                prng = np.random.RandomState(spec.seed + 1000)
                j1, j2 = prng.uniform(-0.15, 0.15, 2)
                yaw = a * np.sin(2.3 * i + 0.7 + j1)
                pitch = 0.6 * a * np.cos(1.7 * i + 0.3 + j2)
                cy, sy = np.cos(yaw), np.sin(yaw)
                cp, sp = np.cos(pitch), np.sin(pitch)
                ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
                c2w[:3, :3] = c2w[:3, :3] @ (ry @ rx)
            self.poses.append(c2w)
        self.poses = np.stack(self.poses).astype(np.float32)

        f = spec.focal_factor * w
        self.K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
        self.images = np.stack([self._render(p) for p in self.poses])

        ids = np.arange(spec.n_views)
        i_test = ids[::llffhold]
        i_train = np.array([j for j in ids if j not in i_test])
        self.i_render = i_train if mode == "train" else i_test
        self.i_train = i_train
        self.depth_range = (depths[0] * 0.8, depths[-1] * 1.3)

    @staticmethod
    def _bilinear(tex, u, v):
        """Bilinear texture lookup (edge-clamped)."""
        h, w = tex.shape[:2]
        u0 = np.clip(np.floor(u).astype(int), 0, w - 1)
        v0 = np.clip(np.floor(v).astype(int), 0, h - 1)
        u1 = np.minimum(u0 + 1, w - 1)
        v1 = np.minimum(v0 + 1, h - 1)
        fu = np.clip(u - u0, 0.0, 1.0)
        fv = np.clip(v - v0, 0.0, 1.0)
        if tex.ndim == 3:
            fu, fv = fu[..., None], fv[..., None]
        return (
            tex[v0, u0] * (1 - fu) * (1 - fv)
            + tex[v0, u1] * fu * (1 - fv)
            + tex[v1, u0] * (1 - fu) * fv
            + tex[v1, u1] * fu * fv
        )

    def _plane_half_extent(self, d):
        """Half extents (hx, hy) of the textured plane at depth d."""
        if self.spec.plane_span == "legacy":
            return 2.0, 1.5
        h, w = self.spec.image_size
        tx = 0.5 / self.spec.focal_factor
        ty = tx * (h / w)
        margin = 0.6 * self.spec.arc_scale + 0.5
        return tx * d * 1.35 + margin, ty * d * 1.35 + margin

    def _render(self, c2w):
        h, w = self.spec.image_size
        xs, ys = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
        Kinv = np.linalg.inv(self.K)
        dirs_cam = np.einsum("ij,jhw->ihw", Kinv, np.stack([xs, ys, np.ones_like(xs)]))
        R, t = c2w[:3, :3], c2w[:3, 3]
        dirs = np.einsum("ij,jhw->ihw", R, dirs_cam)
        out = np.zeros((h, w, 3), np.float32)
        T = np.ones((h, w), np.float32)
        for d, tex, alpha in self.planes:
            # Intersect rays with plane z = d.
            s = (d - t[2]) / dirs[2]
            px = t[0] + s * dirs[0]
            py = t[1] + s * dirs[1]
            hx, hy = self._plane_half_extent(d)
            u = (px + hx) / (2 * hx) * (tex.shape[1] - 1)
            v = (py + hy) / (2 * hy) * (tex.shape[0] - 1)
            inside = (u >= 0) & (u < tex.shape[1]) & (v >= 0) & (v < tex.shape[0])
            a = self._bilinear(alpha, u, v) * inside
            if self.spec.binary_alpha:
                a = (a > 0.5).astype(np.float32)  # keep hits fully opaque
            c = self._bilinear(tex, u, v)
            out += (T * a)[..., None] * c
            T = T * (1 - a)
        return out

    def __len__(self):
        return len(self.i_render)

    def __getitem__(self, idx):
        h, w = self.spec.image_size
        idx = self.i_render[idx % len(self.i_render)]
        rgb = self.images[idx]
        pose = self.poses[idx]

        train_poses = self.poses[self.i_train]
        nearest = get_nearest_pose_ids(
            pose, train_poses, self.num_source_views,
            tar_id=int(np.where(self.i_train == idx)[0][0]) if idx in self.i_train else -1,
            angular_dist_method="dist",
        )
        K4 = np.eye(4, dtype=np.float32)
        K4[:3, :3] = self.K
        camera = pack_camera((h, w), K4, pose)
        src_rgbs = self.images[self.i_train][nearest]
        src_poses = train_poses[nearest]
        src_cameras = np.stack([pack_camera((h, w), K4, p) for p in src_poses])
        return make_example(
            rgb, camera, f"synthetic_{idx}", src_rgbs, src_cameras, self.depth_range,
            src_poses.copy(), pose[None].copy(),
            np.repeat(self.K[None], len(nearest), 0), self.K[None],
            self.i_train[nearest], 0, (h, w),
        )


def collate_batch(example: dict) -> dict:
    """Add the leading batch dim (batch size 1, like the reference loader)."""
    def rec(v):
        if isinstance(v, dict):
            return {k: rec(x) for k, x in v.items()}
        if isinstance(v, np.ndarray):
            return v[None]
        return v

    return {k: rec(v) for k, v in example.items()}
