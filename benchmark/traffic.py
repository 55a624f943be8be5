"""The benchmark's one traffic generator: procedural multi-view scenes of
textured alpha planes, drawn from a seed, in the loader's dual batch format.

A frozen copy of the port's `data/datasets.py::SyntheticPlanesDataset`,
`SyntheticSceneSpec`, `collate_batch` and the helpers they call
(`image_io.gaussian_blur`, `view_selection.get_nearest_pose_ids` with the
"dist" metric), so that a change to the program cannot change the traffic.
The views are rendered all at once in float64 torch, on the card in a run
(the port renders them one by one in numpy; the images agree to float32
rounding).
Each traffic mix (`benchmark/traffic/<mix>.json`) is parameters of this
generator: the scene's fields under "scene", the views per scene, the split
("train" or "test") and the source views per example.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch


@dataclass(frozen=True)
class SceneSpec:
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

    @classmethod
    def of(cls, params: dict, **extra) -> "SceneSpec":
        """A spec from a traffic mix's "scene" dict (lists become tuples)."""
        known = {f.name for f in fields(cls)}
        unknown = set(params) - known
        if unknown:
            raise ValueError(f"unknown scene keys {sorted(unknown)}")
        merged = {**params, **extra}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in merged.items()})


def scene_seeds(seed: int, n: int) -> list[int]:
    """n scene seeds below 2^31 from a run's seed (any size)."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(n) % (2**31 - 1)]


# OpenCV's fixed kernels for sigma <= 0 and small odd sizes.
_SMALL_GAUSSIAN_TAB = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    9: [4 / 256, 13 / 256, 30 / 256, 51 / 256, 60 / 256, 51 / 256, 30 / 256, 13 / 256, 4 / 256],
}


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN_TAB:
        return np.asarray(_SMALL_GAUSSIAN_TAB[ksize], np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(image: np.ndarray, ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.GaussianBlur for a float32 image, reflect-101 border."""
    if ksize == 0:
        ksize = int(np.rint(sigma * 8 + 1)) | 1
    k = _gaussian_kernel(ksize, sigma).astype(np.float64)
    r = ksize // 2
    h, w = image.shape[:2]
    pad = ((r, r), (r, r)) + ((0, 0),) * (image.ndim - 2)
    padded = np.pad(image.astype(np.float64), pad, mode="reflect")
    rows = sum(k[i] * padded[:, i:i + w] for i in range(ksize))
    return sum(k[i] * rows[i:i + h] for i in range(ksize)).astype(np.float32)


def nearest_pose_ids(tar_pose, ref_poses, num_select: int, tar_id: int = -1) -> np.ndarray:
    """The `num_select` reference views whose centres lie nearest the
    target's, never the target itself (`tar_id`)."""
    num_select = min(num_select, len(ref_poses) - 1)
    dists = np.linalg.norm(tar_pose[None, :3, 3] - ref_poses[:, :3, 3], axis=1)
    if tar_id >= 0:
        dists[tar_id] = 1e3
    return np.argsort(dists)[:num_select]


def pack_camera(img_size, intrinsics4, c2w) -> np.ndarray:
    """34-vector camera: (h, w, K.flatten 16, c2w.flatten 16)."""
    return np.concatenate([list(img_size), intrinsics4.flatten(), c2w.flatten()]).astype(np.float32)


def normalize_intrinsics(intrinsics: np.ndarray, img_size) -> np.ndarray:
    h, w = img_size
    out = intrinsics.copy()
    out[..., 0, 0] /= w
    out[..., 1, 1] /= h
    out[..., 0, 2] = 0.5
    out[..., 1, 2] = 0.5
    return out


def make_example(rgb, camera, src_rgbs, src_cameras, depth_range, src_extrinsics, extrinsics,
                 src_intrinsics, intrinsics, nearest, image_size) -> dict:
    """The dual-format example dict (the reference's llff_test.py:229-269)."""
    num_select = len(nearest)
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
        "src_rgbs": src_rgbs.astype(np.float32),
        "src_cameras": src_cameras.astype(np.float32),
        "depth_range": np.asarray(depth_range, np.float32),
        "context": {
            "extrinsics": src_extrinsics.astype(np.float32),
            "intrinsics": normalize_intrinsics(src_intrinsics, image_size).astype(np.float32),
            "image": src_rgbs.transpose(0, 3, 1, 2).astype(np.float32),
            "near": near,
            "far": far,
            "index": np.asarray(nearest, np.int64),
        },
        "target": {
            "extrinsics": extrinsics.astype(np.float32),
            "intrinsics": normalize_intrinsics(intrinsics, image_size).astype(np.float32),
            "image": rgb.transpose(2, 0, 1)[None].astype(np.float32),
            "near": near[:1],
            "far": far[:1],
            "index": np.asarray([0], np.int64),
        },
    }


def collate(example: dict) -> dict:
    """A leading batch axis of 1, as the reference's loader gives, in arrays
    of their own (C-contiguous, natural strides)."""
    def rec(v):
        if isinstance(v, dict):
            return {k: rec(x) for k, x in v.items()}
        return np.ascontiguousarray(v[None]) if isinstance(v, np.ndarray) else v
    return {k: rec(v) for k, v in example.items()}


class PlanesScene:
    """One procedural scene: textured alpha planes at fixed depths, cameras
    on an arc, exact pinhole projection. Examples of the "train" split take
    their targets from the source pool (never a view as its own source);
    those of "test" from every `llffhold`-th view."""

    def __init__(self, spec: SceneSpec, mode: str = "train", num_source_views: int = 4, llffhold: int = 4,
                 device="cpu"):
        self.spec = spec
        self.device = device
        self.num_source_views = num_source_views
        rng = np.random.RandomState(spec.seed)

        def smooth_noise(shape, blur=9):
            return gaussian_blur(rng.rand(*shape).astype(np.float32), blur)

        def octave_noise(shape):
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
                alpha = np.ones_like(alpha)
            self.planes.append((d, tex, alpha))

        poses = []
        for i in range(spec.n_views):
            t = (i / max(spec.n_views - 1, 1) - 0.5) * spec.arc_scale
            c2w = np.eye(4)
            c2w[0, 3] = t
            c2w[1, 3] = 0.1 * np.sin(3 * t)
            if spec.look_at_z is not None:
                f = np.array([0.0, 0.0, spec.look_at_z]) - c2w[:3, 3]
                f = f / np.linalg.norm(f)
                r = np.cross([0.0, 1.0, 0.0], f)
                r = r / np.linalg.norm(r)
                c2w[:3, :3] = np.stack([r, np.cross(f, r), f], axis=1)
            if spec.rot_wobble_deg:
                a = np.deg2rad(spec.rot_wobble_deg)
                j1, j2 = np.random.RandomState(spec.seed + 1000).uniform(-0.15, 0.15, 2)
                yaw = a * np.sin(2.3 * i + 0.7 + j1)
                pitch = 0.6 * a * np.cos(1.7 * i + 0.3 + j2)
                cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
                ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
                c2w[:3, :3] = c2w[:3, :3] @ (ry @ rx)
            poses.append(c2w)
        self.poses = np.stack(poses).astype(np.float32)

        h, w = spec.image_size
        f = spec.focal_factor * w
        self.K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
        self.images = self._render_all(self.poses)
        ids = np.arange(spec.n_views)
        i_test = ids[::llffhold]
        self.i_train = np.array([j for j in ids if j not in i_test])
        self.i_render = self.i_train if mode == "train" else i_test
        self.depth_range = (depths[0] * 0.8, depths[-1] * 1.3)

    def _plane_half_extent(self, d):
        if self.spec.plane_span == "legacy":
            return 2.0, 1.5
        h, w = self.spec.image_size
        tx = 0.5 / self.spec.focal_factor
        ty = tx * (h / w)
        margin = 0.6 * self.spec.arc_scale + 0.5
        return tx * d * 1.35 + margin, ty * d * 1.35 + margin

    def _render_all(self, poses: np.ndarray) -> np.ndarray:
        """Every view at once, in float64 torch on the scene's device: rays
        through pixel centres, alpha-composited front to back over the
        planes, each plane's texture and alpha sampled bilinearly (edge
        clamped, zero outside the plane). Returns float32 (n, h, w, 3)."""
        dev, f64 = self.device, torch.float64
        h, w = self.spec.image_size
        ys, xs = torch.meshgrid(torch.arange(h, dtype=f64, device=dev) + 0.5,
                                torch.arange(w, dtype=f64, device=dev) + 0.5, indexing="ij")
        kinv = torch.as_tensor(np.linalg.inv(self.K), dtype=f64, device=dev)
        dirs_cam = torch.einsum("ij,jhw->ihw", kinv, torch.stack([xs, ys, torch.ones_like(xs)]))
        c2w = torch.as_tensor(poses, dtype=f64, device=dev)
        dirs = torch.einsum("nij,jhw->nihw", c2w[:, :3, :3], dirs_cam)
        t = c2w[:, :3, 3][:, :, None, None]
        out = torch.zeros((len(poses), h, w, 3), dtype=f64, device=dev)
        T = torch.ones((len(poses), h, w), dtype=f64, device=dev)
        for d, tex, alpha in self.planes:
            s = (d - t[:, 2]) / dirs[:, 2]
            px, py = t[:, 0] + s * dirs[:, 0], t[:, 1] + s * dirs[:, 1]
            hx, hy = self._plane_half_extent(d)
            th, tw = tex.shape[:2]
            u = (px + hx) / (2 * hx) * (tw - 1)
            v = (py + hy) / (2 * hy) * (th - 1)
            inside = ((u >= 0) & (u < tw) & (v >= 0) & (v < th)).to(f64)
            u0 = torch.clamp(torch.floor(u), 0, tw - 1).long()
            v0 = torch.clamp(torch.floor(v), 0, th - 1).long()
            u1, v1 = torch.clamp(u0 + 1, max=tw - 1), torch.clamp(v0 + 1, max=th - 1)
            fu, fv = torch.clamp(u - u0, 0.0, 1.0), torch.clamp(v - v0, 0.0, 1.0)
            both = torch.as_tensor(np.concatenate([tex, alpha[..., None]], -1), dtype=f64, device=dev)
            fu, fv = fu[..., None], fv[..., None]
            smp = (both[v0, u0] * (1 - fu) * (1 - fv) + both[v0, u1] * fu * (1 - fv)
                   + both[v1, u0] * (1 - fu) * fv + both[v1, u1] * fu * fv)
            a = smp[..., 3] * inside
            if self.spec.binary_alpha:
                a = (a > 0.5).to(f64)
            out += (T * a)[..., None] * smp[..., :3]
            T = T * (1 - a)
        return out.to(torch.float32).cpu().numpy()

    def __len__(self):
        return len(self.i_render)

    def example(self, idx: int) -> dict:
        """Example `idx` of the split, collated (batch axis of 1)."""
        h, w = self.spec.image_size
        idx = self.i_render[idx % len(self.i_render)]
        pose = self.poses[idx]
        train_poses = self.poses[self.i_train]
        tar_id = int(np.where(self.i_train == idx)[0][0]) if idx in self.i_train else -1
        nearest = nearest_pose_ids(pose, train_poses, self.num_source_views, tar_id)
        K4 = np.eye(4, dtype=np.float32)
        K4[:3, :3] = self.K
        src_poses = train_poses[nearest]
        return collate(make_example(
            self.images[idx], pack_camera((h, w), K4, pose), self.images[self.i_train][nearest],
            np.stack([pack_camera((h, w), K4, p) for p in src_poses]), self.depth_range,
            src_poses.copy(), pose[None].copy(), np.repeat(self.K[None], len(nearest), 0), self.K[None],
            nearest, (h, w)))


def scenes(mix: dict, image_size, seed: int, num_source_views: int, device="cpu") -> list[PlanesScene]:
    """The mix's `scenes` scenes, each from its own seed drawn from `seed`,
    rendered on `device`."""
    return [PlanesScene(SceneSpec.of(mix.get("scene", {}), n_views=mix["views_per_scene"],
                                     image_size=tuple(image_size), seed=s),
                        mode=mix["split"], num_source_views=num_source_views, device=device)
            for s in scene_seeds(seed, mix.get("scenes", 1))]
