"""COLMAP model readers (host-side; the reference's colmap_read_model.py,
the JAX package's data/colmap.py): cameras, images and points3D of a
COLMAP sparse reconstruction in the binary format, parsed with struct (no
pycolmap), and their conversion to LLFF poses_bounds rows.
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as np

CameraModel = collections.namedtuple("CameraModel", ["model_id", "model_name", "num_params"])
Camera = collections.namedtuple("Camera", ["id", "model", "width", "height", "params"])
BaseImage = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"]
)
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"]
)

CAMERA_MODELS = {
    CameraModel(0, "SIMPLE_PINHOLE", 3), CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4), CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8), CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12), CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4), CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


class Image(BaseImage):
    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


def _read(f, num_bytes, fmt):
    return struct.unpack("<" + fmt, f.read(num_bytes))


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, width, height = _read(f, 24, "iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = _read(f, 8 * model.num_params, "d" * model.num_params)
            cameras[cid] = Camera(cid, model.model_name, width, height, np.array(params))
    return cameras


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (num_pts,) = _read(f, 8, "Q")
            data = _read(f, 24 * num_pts, "ddq" * num_pts)
            xys = np.column_stack([data[0::3], data[1::3]])
            ids = np.array(data[2::3], dtype=np.int64)
            images[iid] = Image(iid, qvec, tvec, cam_id, name.decode("utf-8"), xys, ids)
    return images


def read_points3d_binary(path):
    points = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            pid = _read(f, 8, "Q")[0]
            xyz = np.array(_read(f, 24, "ddd"))
            rgb = np.array(_read(f, 3, "BBB"))
            error = _read(f, 8, "d")[0]
            (track_len,) = _read(f, 8, "Q")
            track = _read(f, 8 * track_len, "ii" * track_len)
            points[pid] = Point3D(
                pid, xyz, rgb, error,
                np.array(track[0::2]), np.array(track[1::2]),
            )
    return points


def read_model(sparse_dir):
    """Read a COLMAP sparse model directory (binary format)."""
    cameras = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
    images = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    pts_path = os.path.join(sparse_dir, "points3D.bin")
    points = read_points3d_binary(pts_path) if os.path.exists(pts_path) else {}
    return cameras, images, points


def colmap_to_poses_bounds(sparse_dir, points_percentile=(0.1, 99.9)):
    """COLMAP model -> LLFF poses_bounds rows (parity with
    scripts/colmap_model_to_poses_bounds.py)."""
    cameras, images, points = read_model(sparse_dir)
    rows = []
    names = []
    for iid in sorted(images, key=lambda i: images[i].name):
        im = images[iid]
        cam = cameras[im.camera_id]
        R = qvec2rotmat(im.qvec)
        t = im.tvec
        c2w = np.eye(4)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ t
        # opencv -> llff axes: [down, right, back] ordering
        m = np.concatenate(
            [np.stack([c2w[:3, 1], c2w[:3, 0], -c2w[:3, 2], c2w[:3, 3]], axis=1)],
            axis=0,
        )
        if cam.model == "SIMPLE_PINHOLE" or cam.model == "SIMPLE_RADIAL":
            f = cam.params[0]
        else:
            f = cam.params[0]
        hwf = np.array([cam.height, cam.width, f])[:, None]
        depths = []
        for pid in im.point3D_ids:
            if pid >= 0 and pid in points:
                p_cam = R @ points[pid].xyz + t
                depths.append(p_cam[2])
        if depths:
            near = np.percentile(depths, points_percentile[0])
            far = np.percentile(depths, points_percentile[1])
        else:
            near, far = 0.1, 100.0
        rows.append(np.concatenate([np.concatenate([m, hwf], axis=1).ravel(), [near, far]]))
        names.append(im.name)
    return np.stack(rows), names
