"""LLFF scene utilities (host-side numpy; the reference's
llff_data_utils.py, the JAX package's data/llff.py): poses_bounds
parsing, pose recentering, the llff->opencv conversion, and the loader's
anti-aliased resize.

Images are read with PIL and resized in numpy (`image_io`), so no OpenCV
or imageio is needed. Where the JAX package can bind a C++ resize
(GGRT_NATIVE_RESIZE=1, native/), the port keeps the numpy path.
"""
from __future__ import annotations

import os

import numpy as np

from .image_io import gaussian_blur, read_image, resize


def parse_llff_pose(pose: np.ndarray):
    """LLFF 3x5 pose -> (intrinsics 4x4, c2w 4x4) in opencv convention
    (ref llff_data_utils.py:25-41)."""
    h, w, f = pose[:3, -1]
    c2w_4x4 = np.eye(4)
    c2w_4x4[:3] = pose[:3, :4]
    c2w_4x4[:, 1:3] *= -1
    intrinsics = np.array([[f, 0, w / 2.0, 0], [0, f, h / 2.0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    return intrinsics, c2w_4x4


def batch_parse_llff_poses(poses: np.ndarray):
    parsed = [parse_llff_pose(p) for p in poses]
    return np.stack([p[0] for p in parsed]), np.stack([p[1] for p in parsed])


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(z, up, pos):
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses):
    """Recenter so the average pose is the identity (ref :215-227)."""
    poses_ = poses + 0
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses_h = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses_h = np.linalg.inv(c2w) @ poses_h
    poses_[:, :3, :4] = poses_h[:, :3, :4]
    return poses_


def _image_files(dirpath):
    exts = ("JPG", "jpg", "png", "jpeg", "PNG")
    return [os.path.join(dirpath, f) for f in sorted(os.listdir(dirpath)) if f.endswith(exts)]


def load_llff_data(basedir: str, factor: int = 8, load_imgs: bool = False):
    """Load an LLFF scene directory.

    Returns (images|None, poses (n, 3, 5), bds (n, 2), render_poses=None,
    i_test, rgb_files). Prefers a pre-minified images_{factor} directory;
    otherwise records the full-resolution files (callers resize).
    """
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    imgdir = os.path.join(basedir, f"images_{factor}")
    actual_factor = float(factor)
    if not os.path.exists(imgdir):
        imgdir = os.path.join(basedir, "images")
        actual_factor = 1.0
    imgfiles = _image_files(imgdir)
    if len(imgfiles) != poses.shape[-1]:
        raise ValueError(f"{basedir}: {len(imgfiles)} images vs {poses.shape[-1]} poses")

    sh = read_image(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] / actual_factor

    poses = poses.transpose(2, 0, 1).astype(np.float64)  # (n, 3, 5)
    bds = bds.transpose(1, 0).astype(np.float64)

    # Rescale the world so the near bound is ~1 (LLFF's bd_factor 0.75).
    sc = 1.0 / (bds.min() * 0.75)
    poses[:, :3, 3] *= sc
    bds *= sc
    poses = recenter_poses(poses)

    imgs = None
    if load_imgs:
        imgs = np.stack([read_image(f).astype(np.float32)[..., :3] / 255.0 for f in imgfiles], 0)

    i_test = np.argmin(np.linalg.norm(poses[:, :3, 3] - poses[:, :3, 3].mean(0), axis=-1))
    return imgs, poses, bds, None, i_test, imgfiles


def downsample_gaussian_blur(img: np.ndarray, ratio: float) -> np.ndarray:
    """Anti-alias blur before downsampling (ref base_utils.py)."""
    sigma = max(1.0 / ratio / 3.0, 1e-8)
    ksize = int(np.ceil(sigma * 3)) * 2 + 1
    if ratio >= 1.0 or ksize <= 1:
        return img
    return gaussian_blur(img, ksize, sigma)


def _resize_image(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """The reference's anti-aliased resize: blur, then bilinear."""
    return resize(downsample_gaussian_blur(img, out_hw[0] / img.shape[0]), out_hw, "linear")


def loader_resize(rgb, camera, src_rgbs, src_cameras, size=(400, 600)):
    """Resize target and source images and rescale the packed 34-vector
    cameras (ref data_utils.py:130-155, with its fx<-ratio_y / fy<-ratio_x
    index quirk corrected as the JAX package does: fx scales by the x
    ratio, fy by the y ratio)."""
    h, w = rgb.shape[:2]
    out_h, out_w = size
    intrinsics = camera[2:18].reshape(4, 4).copy()
    src_intrinsics = src_cameras[:, 2:18].reshape(-1, 4, 4).copy()
    if out_w >= w or out_h >= h:
        return rgb, camera, src_rgbs, src_cameras, intrinsics[:3, :3], src_intrinsics[:, :3, :3]

    ratio_y = out_h / h
    ratio_x = out_w / w
    intrinsics[0, 0] *= ratio_x
    intrinsics[1, 1] *= ratio_y
    intrinsics[0, 2] *= ratio_x
    intrinsics[1, 2] *= ratio_y
    src_intrinsics[:, 0, 0] *= ratio_x
    src_intrinsics[:, 1, 1] *= ratio_y
    src_intrinsics[:, 0, 2] *= ratio_x
    src_intrinsics[:, 1, 2] *= ratio_y

    camera = camera.copy()
    camera[0], camera[1] = out_h, out_w
    camera[2:18] = intrinsics.flatten()
    src_cameras = src_cameras.copy()
    src_cameras[:, 0], src_cameras[:, 1] = out_h, out_w
    src_cameras[:, 2:18] = src_intrinsics.reshape(-1, 16)

    rgb = _resize_image(rgb, (out_h, out_w))
    src_rgbs = np.stack([_resize_image(s, (out_h, out_w)) for s in src_rgbs], axis=0)
    return rgb, camera, src_rgbs, src_cameras, intrinsics[:3, :3], src_intrinsics[:, :3, :3]
