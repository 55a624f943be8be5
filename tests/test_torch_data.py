"""The port's data layer against the JAX package's, on the CPU: view
selection, the OpenCV-free blur and resize against cv2, LLFF parsing and
LLFFTestDataset, every reader on scene trees the tests write (as
tests/test_extra_datasets.py writes them), the registry, the mixing
stream, the COLMAP readers and verify_example.

Non-image arrays must be equal; images agree within 1e-6 (float32 blur
and resize sums taken in another order than OpenCV's).
"""
import ast
import json
import struct
from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from ggrt_official_torch.data import colmap as tcolmap
from ggrt_official_torch.data import datasets as tds
from ggrt_official_torch.data import image_io, llff as tllff, mixing as tmix
from ggrt_official_torch.data import registry as treg
from ggrt_official_torch.data import verifier as tver
from ggrt_official_torch.data import view_selection as tvs
from ggrt_official_tpu.data import colmap as jcolmap
from ggrt_official_tpu.data import datasets as jds
from ggrt_official_tpu.data import llff as jllff, mixing as jmix
from ggrt_official_tpu.data import registry as jreg
from ggrt_official_tpu.data import verifier as jver
from ggrt_official_tpu.data import view_selection as jvs
from tests.test_extra_datasets import _pose_ring, _write_png

IMAGE_ATOL = 1e-6
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_examples_equal(a, b, path=""):
    """Two examples (nested dicts) equal: images within IMAGE_ATOL, all
    else exactly."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_examples_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if path.endswith(("rgb", "src_rgbs", "image")):
            np.testing.assert_allclose(a, b, rtol=0, atol=IMAGE_ATOL, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


# --- view selection -----------------------------------------------------

def random_poses(n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        q = rs.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = jcolmap.qvec2rotmat((w, x, y, z))
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = R, rs.normal(size=3) * 2
        out.append(m)
    return np.stack(out)


@pytest.mark.parametrize("method", ["matrix", "vector", "dist"])
@pytest.mark.parametrize("tar_id", [-1, 3])
def test_nearest_pose_ids_match_jax(method, tar_id):
    poses = random_poses(12, 0)
    kw = dict(tar_id=tar_id, angular_dist_method=method, scene_center=(0.1, -0.2, 0.3))
    for k in (1, 5, 11, 20):
        got = tvs.get_nearest_pose_ids(poses[3], poses, k, **kw)
        np.testing.assert_array_equal(got, jvs.get_nearest_pose_ids(poses[3], poses, k, **kw))


def test_vector_is_the_default_and_ties_fall_as_in_jax():
    poses = np.repeat(random_poses(1, 1), 6, axis=0)  # every distance ties
    np.testing.assert_array_equal(tvs.get_nearest_pose_ids(poses[0], poses, 4),
                                  jvs.get_nearest_pose_ids(poses[0], poses, 4))
    with pytest.raises(ValueError):
        tvs.get_nearest_pose_ids(poses[0], poses, 2, angular_dist_method="other")


class Graph(dict):
    def neighbors(self, node):
        return iter(self[node])


def test_nearby_view_ids_match_jax():
    rs = np.random.RandomState(2)
    g = Graph()
    for u in range(8):
        g[u] = {v: {"weight": float(rs.randint(1, 50))} for v in range(8) if v != u}
    idx_to_node = {i: i for i in range(8)}
    node_to_idx = {i: i for i in range(7)}  # node 7 is not a training view
    for k in (1, 3, 10):
        np.testing.assert_array_equal(tvs.get_nearby_view_ids(2, g, idx_to_node, node_to_idx, k),
                                      jvs.get_nearby_view_ids(2, g, idx_to_node, node_to_idx, k))


# --- blur and resize against OpenCV ----------------------------------------

SIZES = [(24, 36), (30, 41), (378, 504)]


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("interp", ["linear", "area"])
def test_resize_matches_cv2(hw, interp):
    flag = {"linear": cv2.INTER_LINEAR, "area": cv2.INTER_AREA}[interp]
    img = np.random.RandomState(hw[0]).rand(*hw, 3).astype(np.float32)
    h, w = hw
    for out in [(h // 2, w // 2), (h * 2, w * 2), (int(h * 0.37) + 1, int(w * 0.61) + 1),
                (h * 3, w // 3 + 1), (h + 3, w - 1), (h, w)]:
        want = cv2.resize(img, (out[1], out[0]), interpolation=flag)
        got = image_io.resize(img, out, interp)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_ATOL, err_msg=str(out))
    np.testing.assert_allclose(image_io.resize(img[..., 0], (h // 3, w // 2), interp),
                               cv2.resize(img[..., 0], (w // 2, h // 3), interpolation=flag),
                               rtol=0, atol=IMAGE_ATOL)


@pytest.mark.parametrize("ratio", [0.5, 0.3, 1 / 8, 320 / 378, 0.9, 1.0])
def test_loader_blur_and_resize_match_jax(ratio):
    img = np.random.RandomState(3).rand(60, 84, 3).astype(np.float32)
    np.testing.assert_allclose(tllff.downsample_gaussian_blur(img, ratio),
                               jllff.downsample_gaussian_blur(img, ratio), rtol=0, atol=IMAGE_ATOL)
    out = (max(1, int(60 * ratio)), max(1, int(84 * ratio)))
    np.testing.assert_allclose(tllff._resize_image(img, out), jllff._resize_image(img, out),
                               rtol=0, atol=IMAGE_ATOL)


def test_synthetic_blur_matches_cv2():
    img = np.random.RandomState(4).rand(20, 30).astype(np.float32)
    for ksize, sigma in ((5, 0.0), (9, 0.0), (0, 0.8), (0, 2.4), (7, 1.3)):
        np.testing.assert_allclose(image_io.gaussian_blur(img, ksize, sigma),
                                   cv2.GaussianBlur(img, (ksize, ksize), sigma), rtol=0, atol=IMAGE_ATOL)


def test_read_image_matches_imageio(tmp_path):
    rs = np.random.RandomState(5)
    for name, arr in (("a.png", rs.rand(8, 12, 3)), ("b.jpg", rs.rand(8, 12, 3)), ("c.png", rs.rand(8, 12, 4))):
        imageio.imwrite(tmp_path / name, (arr * 255).astype(np.uint8))
        np.testing.assert_array_equal(image_io.read_image(str(tmp_path / name)), imageio.imread(tmp_path / name))


def test_no_data_module_imports_opencv_or_imageio():
    for path in sorted((ROOT / "ggrt_official_torch" / "data").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not {n.split(".")[0] for n in names} & {"cv2", "imageio"}, path


# --- LLFF ------------------------------------------------------------------

def write_llff_scene(scene_dir: Path, n=10, hw=(40, 60), factor_dir="images_8", seed=0):
    """An LLFF scene: n PNG views and poses_bounds.npy rows (3x5 LLFF pose
    with hwf, then near and far)."""
    (scene_dir / factor_dir).mkdir(parents=True)
    rows = []
    for i, c2w in enumerate(_pose_ring(n)):
        _write_png(str(scene_dir / factor_dir / f"{i:03d}.png"), h=hw[0], w=hw[1], seed=seed + i)
        pose = c2w[:3, :4].copy()
        pose[:, 1:3] *= -1
        hwf = np.array([hw[0], hw[1], 50.0 * 8])[:, None]
        rows.append(np.concatenate([np.concatenate([pose, hwf], 1).ravel(), [1.5 + 0.1 * i, 9.0]]))
    np.save(scene_dir / "poses_bounds.npy", np.stack(rows))


@pytest.fixture(scope="module")
def llff_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("llff")
    write_llff_scene(root / "nerf_llff_data" / "fern", seed=0)
    write_llff_scene(root / "nerf_llff_data" / "room", n=12, seed=20)
    return root


def test_load_llff_data_matches_jax(llff_root):
    scene = str(llff_root / "nerf_llff_data" / "fern")
    got, want = tllff.load_llff_data(scene, load_imgs=True), jllff.load_llff_data(scene, load_imgs=True)
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    for a, b in zip(tllff.batch_parse_llff_poses(got[1]), jllff.batch_parse_llff_poses(want[1])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_llff_test_dataset_matches_jax(llff_root, mode):
    kw = dict(scenes=(), num_source_views=3, llffhold=4, image_size=(16, 24))
    got = tds.LLFFTestDataset(str(llff_root), mode, **kw)
    want = jds.LLFFTestDataset(str(llff_root), mode, **kw)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        assert_examples_equal(got[i], want[i])


@pytest.mark.parametrize("name,sub", [("llff", "real_iconic_noface"), ("ibrnet_collected", "ibrnet_collected_2")])
def test_collections_match_jax(tmp_path, name, sub):
    write_llff_scene(tmp_path / sub / "a", n=9)
    (tmp_path / sub / "empty").mkdir()  # no poses_bounds: left out
    kw = dict(num_source_views=2, image_size=(20, 30))
    got, want = treg.dataset_dict[name](str(tmp_path), "train", **kw), jreg.dataset_dict[name](str(tmp_path), "train", **kw)
    assert len(got) == len(want) > 0
    for i in (0, len(want) - 1):
        assert_examples_equal(got[i], want[i])


# --- the other readers -------------------------------------------------------

def write_realestate(root):
    scene = root / "RealEstate10K-subset" / "train" / "frames" / "scene0"
    lines = ["https://example"]
    poses = _pose_ring(12)
    for i in range(12):
        _write_png(str(scene / f"{i:05d}.jpg"), seed=i)
        w2c = np.linalg.inv(poses[i])[:3, :].reshape(-1)
        lines.append(" ".join(map(str, [i, 0.8, 0.9, 0.5, 0.5, 0.0, 0.0, *w2c.tolist()])))
    (root / "RealEstate10K-subset" / "train" / "cameras").mkdir(parents=True)
    (root / "RealEstate10K-subset" / "train" / "cameras" / "scene0.txt").write_text("\n".join(lines))
    return dict(mode="train", num_source_views=3, image_size=(16, 24))


def write_kitti(root):
    seq = root / "kitti" / "sequences" / "00"
    poses = _pose_ring(10)
    for i in range(10):
        _write_png(str(seq / "image_2" / f"{i:06d}.png"), seed=i)
    P = np.array([[100.0, 0, 60, 0], [0, 100.0, 30, 0], [0, 0, 1, 0]])
    (seq / "calib.txt").write_text("\n".join(f"P{j}: " + " ".join(map(str, P.reshape(-1))) for j in range(4)))
    (root / "kitti" / "poses").mkdir(parents=True)
    (root / "kitti" / "poses" / "00.txt").write_text(
        "\n".join(" ".join(map(str, p[:3, :].reshape(-1))) for p in poses))
    return dict(mode="train", scenes="00", num_source_views=3, image_size=(16, 32))


def write_deepvoxels(root):
    poses = _pose_ring(8)
    for subset in ("train", "test"):
        sp = root / "deepvoxels" / subset / "vase"
        (sp / "pose").mkdir(parents=True)
        for i in range(8):
            _write_png(str(sp / "rgb" / f"{i:03d}.png"), seed=i)
            (sp / "pose" / f"{i:03d}.txt").write_text(" ".join(map(str, poses[i].reshape(-1))))
        (sp / "intrinsics.txt").write_text("100.0 4.0 4.0 0\n0\n8\n")
    return dict(mode="train", scenes="vase", num_source_views=3, image_size=(16, 16))


def write_google_scanned(root):
    obj = root / "google_scanned_objects" / "obj0"
    (obj / "pose").mkdir(parents=True)
    (obj / "intrinsics").mkdir(parents=True)
    K4 = np.eye(4)
    K4[0, 0] = K4[1, 1] = 80.0
    K4[0, 2] = K4[1, 2] = 8.0
    for i, p in enumerate(_pose_ring(6)):
        _write_png(str(obj / "images" / f"{i:03d}.png"), seed=i)
        (obj / "pose" / f"{i:03d}.txt").write_text(" ".join(map(str, p.reshape(-1))))
        (obj / "intrinsics" / f"{i:03d}.txt").write_text(" ".join(map(str, K4.reshape(-1))))
    return dict(mode="train", num_source_views=3, image_size=(16, 16), min_files=6)


def write_spaces(root):
    from scipy.spatial.transform import Rotation

    base = root / "spaces_dataset" / "data" / "800" / "scene_000"
    base.mkdir(parents=True)
    model, k = [], 0
    for r in range(3):
        rig = []
        for c in range(4):
            rel = f"cam_{c:02d}/image_{r:03d}.png"
            _write_png(str(base / rel), h=8, w=12, seed=k)
            Rm = Rotation.from_euler("XYZ", [0.01 * k, 0.02 * k, 0.0]).as_matrix()
            rig.append({"relative_path": rel, "height": 8, "width": 12, "focal_length": 10.0,
                        "pixel_aspect_ratio": 1.0, "principal_point": [6.0, 4.0],
                        "position": [0.1 * k, 0.05 * r, 0.0],
                        "orientation": Rotation.from_matrix(Rm.T).as_rotvec().tolist()})
            k += 1
        model.append(rig)
    (base / "models.json").write_text(json.dumps(model))
    return dict(mode="train", num_source_views=3, image_size=(16, 20))


def write_nerf_synthetic(root):
    scene = root / "nerf_synthetic" / "lego"
    rs = np.random.RandomState(7)
    for split, n in (("train", 8), ("test", 9)):
        frames = []
        for i, p in enumerate(_pose_ring(n)):
            name = f"{split}/r_{i}"
            (scene / split).mkdir(parents=True, exist_ok=True)
            imageio.imwrite(scene / f"{name}.png", (rs.rand(8, 12, 4) * 255).astype(np.uint8))
            frames.append({"file_path": name, "transform_matrix": p.tolist()})
        (scene / f"transforms_{split}.json").write_text(json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    return dict(mode="test", scenes="lego", num_source_views=3, testskip=2)


def write_scannet(root):
    scene = root / "scannet" / "scene0000_00"
    for d in ("color", "pose", "intrinsic"):
        (scene / d).mkdir(parents=True)
    (scene / "intrinsic" / "intrinsic_color.txt").write_text(
        "\n".join(" ".join(map(str, row)) for row in [[30.0, 0, 12, 0], [0, 30.0, 8, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
    for i, p in enumerate(_pose_ring(24)):
        _write_png(str(scene / "color" / f"{i}.jpg"), h=16, w=24, seed=i)
        (scene / "pose" / f"{i}.txt").write_text("\n".join(" ".join(map(str, row)) for row in p))
    (scene / "pose" / "5.txt").write_text("\n".join(["nan nan nan nan"] * 4))  # left out
    return dict(mode="train", num_source_views=2, frameskip=2, testhold=4, image_size=(12, 20))


def write_waymo(root):
    scene = root / "waymo" / "seg0"
    for d in ("intrinsics", "extrinsics", "ego_pose", "images"):
        (scene / d).mkdir(parents=True)
    (scene / "intrinsics" / "0.txt").write_text("\n".join(map(str, [2000.0, 2000.0, 960.0, 640.0, 0, 0, 0, 0, 0])))
    (scene / "extrinsics" / "0.txt").write_text("\n".join(" ".join(map(str, r)) for r in np.eye(4)))
    for t, p in enumerate(_pose_ring(10)):
        (scene / "ego_pose" / f"{t:03d}.txt").write_text("\n".join(" ".join(map(str, r)) for r in p))
        _write_png(str(scene / "images" / f"{t:03d}_0.jpg"), h=20, w=30, seed=t)
    return dict(mode="train", scenes=("seg0",), num_source_views=3, end_timestep=10)


READERS = {
    "realestate": write_realestate, "kitti": write_kitti, "deepvoxels": write_deepvoxels,
    "google_scanned": write_google_scanned, "spaces": write_spaces, "nerf_synthetic": write_nerf_synthetic,
    "scannet": write_scannet, "waymo": write_waymo,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_matches_jax(tmp_path, name):
    kw = READERS[name](tmp_path)
    mode = kw.pop("mode")
    root = str(tmp_path / "waymo") if name == "waymo" else str(tmp_path)
    np.random.seed(0)
    want_ds = jreg.dataset_dict[name](root, mode, **kw)
    got_ds = treg.dataset_dict[name](root, mode, **kw)
    assert len(got_ds) == len(want_ds) > 0
    for i in sorted({0, len(want_ds) - 1}):
        np.random.seed(10 + i)
        want = want_ds[i]
        np.random.seed(10 + i)
        got = got_ds[i]
        assert_examples_equal(got, want)


def test_registry_names_match_jax():
    assert list(treg.dataset_dict) == list(jreg.dataset_dict)
    for name, cls in treg.dataset_dict.items():
        assert cls.__name__ == jreg.dataset_dict[name].__name__, name


# --- mixing ------------------------------------------------------------------

def test_weighted_mix_stream_matches_jax():
    parts = [list(range(0, 5)), list(range(100, 103)), list(range(200, 211))]
    got, want = tmix.WeightedMixDataset(parts, [0.2, 0.5, 0.3], seed=4), jmix.WeightedMixDataset(parts, [0.2, 0.5, 0.3], seed=4)
    assert len(got) == len(want)
    assert [got[i] for i in range(40)] == [want[i] for i in range(40)]
    for host in range(3):
        g, w = got.host_shard_iter(host, 3, seed=9), want.host_shard_iter(host, 3, seed=9)
        assert [next(g) for _ in range(15)] == [next(w) for _ in range(15)]


def test_create_training_dataset_matches_jax():
    from types import SimpleNamespace

    classes = {"a": lambda cfg, mode: [("a", i) for i in range(4)], "b": lambda cfg, mode: [("b", i) for i in range(6)]}
    cfg = SimpleNamespace(train=SimpleNamespace(train_dataset="a+b", dataset_weights=(0.3, 0.7), seed=2))
    got, want = tmix.create_training_dataset(cfg, classes), jmix.create_training_dataset(cfg, classes)
    assert [got[i] for i in range(20)] == [want[i] for i in range(20)]
    cfg.train.train_dataset = "a"
    assert tmix.create_training_dataset(cfg, classes) == jmix.create_training_dataset(cfg, classes)
    cfg.train.train_dataset = "c"
    with pytest.raises(KeyError):
        tmix.create_training_dataset(cfg, classes)


# --- COLMAP --------------------------------------------------------------------

def write_colmap_model(sparse: Path):
    """cameras.bin, images.bin and points3D.bin in COLMAP's binary layout."""
    sparse.mkdir(parents=True)
    rs = np.random.RandomState(8)
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, 64, 48) + struct.pack("<4d", 50.0, 52.0, 32.0, 24.0))  # PINHOLE
        f.write(struct.pack("<iiQQ", 2, 0, 64, 48) + struct.pack("<3d", 55.0, 32.0, 24.0))       # SIMPLE_PINHOLE
    pts = {pid: rs.normal(size=3) + [0, 0, 6] for pid in range(1, 9)}
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for pid, xyz in pts.items():
            f.write(struct.pack("<Q3d3Bd", pid, *xyz, 10, 20, 30, 0.5))
            f.write(struct.pack("<Q", 2) + struct.pack("<4i", 1, 0, 2, 1))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 3))
        for iid, name in ((1, "b.png"), (2, "a.png"), (3, "c.png")):
            q = rs.normal(size=4)
            q /= np.linalg.norm(q)
            f.write(struct.pack("<i4d3di", iid, *q, *rs.normal(size=3), 1 + iid % 2))
            f.write(name.encode() + b"\x00")
            ids = [1, 2, -1, 5] if iid != 3 else []
            f.write(struct.pack("<Q", len(ids)))
            for k, pid in enumerate(ids):
                f.write(struct.pack("<ddq", 1.5 * k, 2.5 * k, pid))


def test_colmap_readers_match_jax(tmp_path):
    sparse = tmp_path / "sparse" / "0"
    write_colmap_model(sparse)
    got, want = tcolmap.read_model(str(sparse)), jcolmap.read_model(str(sparse))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            for a, b in zip(g[k], w[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rows, names = tcolmap.colmap_to_poses_bounds(str(sparse))
    rows_j, names_j = jcolmap.colmap_to_poses_bounds(str(sparse))
    assert names == names_j == ["a.png", "b.png", "c.png"]
    np.testing.assert_array_equal(rows, rows_j)
    np.testing.assert_allclose(tcolmap.qvec2rotmat((1.0, 0, 0, 0)), np.eye(3))


# --- verifier ------------------------------------------------------------------

def turned(example, deg):
    """The example with context view 1 turned by `deg` about y and view 2
    shifted, so that some of their epipolar segments leave the frame."""
    a = np.deg2rad(deg)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    ext = example["context"]["extrinsics"].copy()
    ext[1, :3, :3] = R @ ext[1, :3, :3]
    ext[2, :3, 3] += [1.0, 0.3, 0.0]
    return {**example, "context": {**example["context"], "extrinsics": ext.astype(np.float32)}}


@pytest.fixture(scope="module")
def jax_verify_reports():
    """JAX's verify_example on a synthetic example turned by 0, 25, 40 and
    60 degrees (the module's one JAX fixture)."""
    ex = tds.SyntheticPlanesDataset(tds.SyntheticSceneSpec(n_views=8, image_size=(24, 32)), num_source_views=3)[0]
    examples = [turned(ex, deg) for deg in (0, 25, 40, 60)]
    return examples, [jver.verify_example(e, num_rays=64) for e in examples]


def test_verify_example_matches_jax(jax_verify_reports):
    examples, reports = jax_verify_reports
    assert len({r["min_overlap"] for r in reports}) == 4  # from full overlap down to none
    for ex, want in zip(examples, reports):
        assert tver.verify_example(ex, num_rays=64) == want
