"""The port's pose and SfM tooling against the JAX package, on the CPU: the
quaternion Lie group (values and gradients, at θ = 0, a small θ inside
the Taylor branches, a generic θ and θ near π, and R_to_quat's pivot
ties), the g2o pose-accuracy protocol, the track builder, the pose
initialisation, the disambiguation filter, the retrieval descriptors and
pairs, and the two-view geometry, SfM pipeline and relative-pose CLI (no
OpenCV in the port) against the JAX package's OpenCV ones on PNG views the
tests write (test_sfm's, and chip_smoke phase 19's scene).

Inputs are made with numpy from a seed and given to both sides. Each test
states its tolerance.
"""
import importlib.util
import math
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation

import scripts.extract_relative_poses as jextract
from ggrt_official_torch.data.image_io import read_gray
from ggrt_official_torch.evaluation import pose_accuracy as tpa
from ggrt_official_torch.geometry import lie_group as tlg
from ggrt_official_torch.geometry import pose_init as tpi
from ggrt_official_torch.geometry import tracks as ttracks
from ggrt_official_torch.scripts import extract_relative_poses as textract
from ggrt_official_torch.sfm import disambiguation as tdis
from ggrt_official_torch.sfm import pipeline as tpipe
from ggrt_official_torch.sfm import retrieval as tret
from ggrt_official_torch.sfm import two_view as ttv
from ggrt_official_tpu.evaluation import pose_accuracy as jpa
from ggrt_official_tpu.geometry import lie_group as jlg
from ggrt_official_tpu.geometry import pose_init as jpi
from ggrt_official_tpu.geometry import se3 as jse3
from ggrt_official_tpu.geometry import tracks as jtracks
from ggrt_official_tpu.sfm import disambiguation as jdis
from ggrt_official_tpu.sfm import pipeline as jpipe
from ggrt_official_tpu.sfm import retrieval as jret
from ggrt_official_tpu.sfm import two_view as jtv
from tests.test_sfm import _render_plane_views

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.tensor(np.asarray(x))


def close(actual, expected, **tol):
    np.testing.assert_allclose(np.asarray(actual, np.float64), np.asarray(expected, np.float64), **tol)


# --- the Lie group ---------------------------------------------------------------

# θ = 0, a θ inside the Taylor branches (θ² < 1e-8), a generic θ, θ near π.
THETAS = {"zero": 0.0, "small": 5e-5, "generic": 0.9, "near_pi": math.pi - 1e-2}
# fn -> the kinds of its arguments: w so(3), wu se(3), q quaternion, v
# quat+trans, R rotation, T pose, p points.
LIE_FNS = {
    "quat_normalize": "q", "quat_mul": "qq", "quat_conj": "q", "quat_rotate": "qp", "quat_to_R": "q",
    "R_to_quat": "R", "quat_exp": "w", "quat_log": "q", "se3q_from_matrix": "T", "se3q_to_matrix": "v",
    "se3q_mul": "vv", "se3q_inv": "v", "se3q_transform": "vP", "se3q_exp": "u", "se3q_log": "v",
    "so3_left_jacobian": "w", "so3_right_jacobian": "w", "boxplus_left": "Tu", "boxplus_right": "Tu",
    "se3_adjoint": "T", "jacob_expeD_de": "T", "jacob_Dexpe_de": "T",
}


def lie_inputs(regime):
    """kind -> an input of that kind at θ of `regime` (3 of each, batched);
    the quaternions and matrices are the JAX package's maps of the tangents,
    and a quaternion's norm is moved off 1 to reach quat_normalize."""
    rng = np.random.RandomState(21)
    axes = rng.normal(size=(3, 3))
    w = (axes / np.linalg.norm(axes, axis=-1, keepdims=True) * THETAS[regime]).astype(np.float32)
    u = rng.normal(size=(3, 3)).astype(np.float32)
    wu = np.concatenate([w, u], -1)
    q = np.asarray(jlg.quat_exp(w))
    T = np.asarray(jse3.se3_exp(wu))
    w2 = w[::-1].copy()
    q2 = np.asarray(jlg.quat_exp(w2))
    return {
        "w": w, "u": wu, "q": (q * 1.3).astype(np.float32), "R": np.asarray(jse3.so3_exp(w)), "T": T,
        "v": np.concatenate([q, u], -1), "p": rng.normal(size=(3, 3)).astype(np.float32),
        "P": rng.normal(size=(3, 5, 3)).astype(np.float32), "q2": q2,
        "v2": np.concatenate([q2, u[::-1].copy()], -1), "u2": np.concatenate([w2, u], -1) * 0.5,
    }


def lie_args(ins, fn):
    kinds = LIE_FNS[fn]
    second = {"q": ins["q2"], "v": ins["v2"], "u": ins["u2"], "p": ins["p"], "P": ins["P"]}
    return (ins[kinds[0]],) + tuple(second[k] for k in kinds[1:])


@pytest.fixture(scope="module")
def lie_jax():
    """Values and gradients (of sum(f(x)·cot) with respect to the first
    argument) of every Lie-group function in every regime: one jitted JAX
    function per Lie-group function."""
    inputs = {r: lie_inputs(r) for r in THETAS}
    rng = np.random.RandomState(22)
    out = {}
    for fn in LIE_FNS:
        f = getattr(jlg, fn)

        @jax.jit
        def run(args, cot):
            return f(*args), jax.grad(lambda a0: jnp.sum(f(a0, *args[1:]) * cot))(args[0])

        for r in THETAS:
            args = lie_args(inputs[r], fn)
            cot = rng.normal(size=jax.eval_shape(f, *args).shape).astype(np.float32)
            val, grad = run(args, cot)
            out[(fn, r)] = (np.asarray(val), np.asarray(grad), args, cot)
    return out


@pytest.mark.parametrize("regime", list(THETAS))
@pytest.mark.parametrize("fn", list(LIE_FNS))
def test_lie_group(lie_jax, fn, regime):
    """Values atol 1e-5 (rtol 1e-5); gradients atol 1e-5 of the largest
    entry (at least 1), where JAX's are finite. Near π, se3q_log's gradient
    goes through so3_log, whose 1/sin θ JAX's own docstring calls unsafe
    there: atol 1e-2 of the largest entry (measured 4.1e-3: float32
    rounding of the trace, magnified by 1/sin θ ~ 100).

    Every gradient of the port is finite, at θ = 0 too, but se3q_log's at
    the identity: it goes through se3_log, whose θ = sqrt(Σw²) has an
    infinite derivative at w = 0 in both packages (ROADMAP Queue 3). Where
    JAX's gradient is NaN elsewhere (quat_log at the identity, where
    jnp.linalg.norm's derivative at 0 is 0/0 though the branch taken does
    not use it) the port's is the derivative of the branch taken."""
    val_j, grad_j, args, cot = lie_jax[(fn, regime)]
    a0 = t(args[0]).requires_grad_(True)
    val_t = getattr(tlg, fn)(a0, *(t(a) for a in args[1:]))
    close(val_t.detach(), val_j, rtol=1e-5, atol=1e-5)
    (val_t * t(cot)).sum().backward()
    grad_t = a0.grad.numpy()
    finite = np.isfinite(grad_j)
    scale = max(np.abs(grad_j[finite]).max(initial=0.0), 1.0)
    loose = (fn, regime) == ("se3q_log", "near_pi")
    close(grad_t[finite], grad_j[finite], rtol=1e-5, atol=(1e-2 if loose else 1e-5) * scale)
    if (fn, regime) == ("se3q_log", "zero"):
        assert not np.isfinite(grad_t).all()
    else:
        assert np.isfinite(grad_t).all()
    if (fn, regime) == ("quat_log", "zero"):
        assert not finite.all()      # JAX's NaN; the port's is 2/w on the vector part
        close(grad_t[..., 1:], np.asarray(cot) * 2.0 / 1.3, rtol=1e-5)


def test_identities():
    close(tlg.quat_identity((2,)), jlg.quat_identity((2,)), rtol=0, atol=0)
    close(tlg.se3q_identity((2, 3)), jlg.se3q_identity((2, 3)), rtol=0, atol=0)


def rotation_about(axis, angle):
    axis = np.asarray(axis, np.float64)
    return Rotation.from_rotvec(axis / np.linalg.norm(axis) * angle).as_matrix().astype(np.float32)


# Rotations whose pivot magnitudes tie: π about (1, -1, 0) (x and y tie, and
# their candidates are negatives of each other), π/2 about x (w and x), π
# about (1, 1, 1) (x, y and z), and the identity's exact 4 against 0s.
TIES = {
    "xy_opposite": rotation_about([1, -1, 0], math.pi),
    "xy_same": rotation_about([1, 1, 0], math.pi),
    "wx": np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32),
    "xyz": rotation_about([1, 1, 1], math.pi),
    "identity": np.eye(3, dtype=np.float32),
}


@pytest.mark.parametrize("case", list(TIES))
def test_R_to_quat_breaks_ties_as_jax(case):
    """The same quaternion, sign included (atol 1e-6): torch.argmax and
    jnp.argmax both take the first of tied magnitudes."""
    R = TIES[case]
    mags = np.array([1 + np.trace(R), 1 + R[0, 0] - R[1, 1] - R[2, 2], 1 - R[0, 0] + R[1, 1] - R[2, 2],
                     1 - R[0, 0] - R[1, 1] + R[2, 2]], np.float32)
    if case != "identity":
        assert (np.isclose(mags, mags.max(), atol=1e-6)).sum() >= 2
    close(tlg.R_to_quat(t(R)), jax.jit(jlg.R_to_quat)(R), rtol=0, atol=1e-6)
    if case == "xy_opposite":
        # The other tied pivot would give the opposite sign.
        assert float(tlg.R_to_quat(t(R))[1]) > 0


# --- pose accuracy -----------------------------------------------------------------

def write_vertices(path, c2w):
    """A g2o file of VERTEX_SE3:QUAT lines (id, tx ty tz, qx qy qz qw) of the
    world-to-camera poses of `c2w`."""
    lines = []
    for i, T in enumerate(np.linalg.inv(c2w)):
        qx, qy, qz, qw = Rotation.from_matrix(T[:3, :3]).as_quat()
        tx, ty, tz = T[:3, 3]
        lines.append(f"VERTEX_SE3:QUAT {i} {tx} {ty} {tz} {qx} {qy} {qz} {qw}")
    lines.append("EDGE_SE3:QUAT 0 1 0.1 0.2 0.3 0 0 0 1 " + " ".join(["1"] * 21))
    path.write_text("\n".join(lines) + "\n")


def ring_poses(n, rng, noise=0.0):
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = 2 * np.pi * i / n
        out[i, :3, :3] = Rotation.from_rotvec(rng.normal(size=3) * 0.2 + [0, a, 0]).as_matrix()
        out[i, :3, 3] = [np.cos(a), 0.1 * i, np.sin(a)] + noise * rng.normal(size=3)
    return out


def test_pose_accuracy_matches_jax(tmp_path):
    """read_g2o_file and qt_rows_to_c2w exactly; the protocol's statistics
    rtol 1e-4, atol 1e-3 (degrees or units: float32 arccos near 1, as
    test_torch_eval's pose-error gate)."""
    rng = np.random.RandomState(23)
    gt = ring_poses(7, rng)
    pred = ring_poses(7, np.random.RandomState(23), noise=0.05)
    write_vertices(tmp_path / "gt.g2o", gt)
    write_vertices(tmp_path / "pred.g2o", pred)
    for name in ("gt.g2o", "pred.g2o"):
        for a, b in zip(tpa.read_g2o_file(str(tmp_path / name)), jpa.read_g2o_file(str(tmp_path / name))):
            np.testing.assert_array_equal(a, b)
    rows = jpa.read_g2o_file(str(tmp_path / "pred.g2o"))[0]
    np.testing.assert_array_equal(tpa.qt_rows_to_c2w(rows), jpa.qt_rows_to_c2w(rows))
    close(tpa.qt_rows_to_c2w(rows), pred, rtol=0, atol=1e-9)
    out_t = tpa.evaluate_g2o_pose_accuracy(str(tmp_path / "pred.g2o"), str(tmp_path / "gt.g2o"))
    out_j = jpa.evaluate_g2o_pose_accuracy(str(tmp_path / "pred.g2o"), str(tmp_path / "gt.g2o"))
    assert set(out_t) == set(out_j) and out_t["n_poses"] == 7
    for k, v in out_j.items():
        close(out_t[k], v, rtol=1e-4, atol=1e-3, err_msg=k)
    assert all(math.isfinite(v) for v in out_t.values())


# --- tracks, pose initialisation, disambiguation ----------------------------------------------

def test_tracks_match_jax():
    """The same tracks from the same seeded matches, including tracks with
    two observations in one image (dropped) and short ones."""
    rng = np.random.RandomState(24)
    builders = (ttracks.TrackBuilder(), jtracks.TrackBuilder())
    for i in range(6):
        for j in range(i + 1, 6):
            matches = rng.randint(0, 100, size=(20, 2))
            for b in builders:
                b.add_matches((i, j), matches)
    for k in (2, 3):
        got, want = builders[0].build(min_length=k), builders[1].build(min_length=k)
        assert got == want and len(want) > 0


def random_w2c(n, seed):
    rs = np.random.RandomState(seed)
    T = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        T[i, :3, :3] = Rotation.from_rotvec(rs.randn(3) * 0.4).as_matrix()
        T[i, :3, 3] = rs.randn(3)
    return T


@pytest.mark.parametrize("metric_scale", [True, False])
def test_pose_init_matches_jax(metric_scale):
    """mst_rotations, solve_positions and PoseInitializer on a seeded view
    graph with noisy relative poses (inlier counts vary), and
    init_poses_from_noisy_gt from the same seed: the same numpy and scipy
    calls, so equal to float32 rounding (rtol 1e-6, atol 1e-6)."""
    n = 7
    T = random_w2c(n, 25)
    rs = np.random.RandomState(26)
    pairs = [(i, i + 1) for i in range(n - 1)] + [(0, 3), (2, 6), (1, 5)]
    edges = {}
    for i, j in pairs:
        rel = T[j] @ np.linalg.inv(T[i])
        rel[:3, :3] = Rotation.from_rotvec(rs.randn(3) * 0.01).as_matrix() @ rel[:3, :3]
        edges[(i, j)] = (rel.astype(np.float32), int(rs.randint(20, 500)))
    ref = T[2].astype(np.float32)
    rot_edges = {k: (v[0][:3, :3], v[1]) for k, v in edges.items()}
    R_t, R_j = tpi.mst_rotations(rot_edges, n, 2, ref[:3, :3]), jpi.mst_rotations(rot_edges, n, 2, ref[:3, :3])
    close(R_t, R_j, rtol=0, atol=0)
    close(tpi.solve_positions(edges, R_j, 2, ref[:3, 3], metric_scale=metric_scale),
          jpi.solve_positions(edges, R_j, 2, ref[:3, 3], metric_scale=metric_scale), rtol=1e-6, atol=1e-6)
    got = tpi.PoseInitializer(edges, n, 2, ref, metric_scale=metric_scale).init_poses_from_mst()
    want = jpi.PoseInitializer(edges, n, 2, ref, metric_scale=metric_scale).init_poses_from_mst()
    close(got, want, rtol=1e-6, atol=1e-6)
    c2w = np.linalg.inv(T).astype(np.float32)
    close(tpi.init_poses_from_noisy_gt(c2w, rng=np.random.RandomState(3)),
          jpi.init_poses_from_noisy_gt(c2w, rng=np.random.RandomState(3)), rtol=0, atol=0)


@pytest.mark.parametrize("filter_type", ["threshold", "percentile", "knn"])
def test_disambiguation_matches_jax(filter_type):
    """Scores and kept edges equal on a seeded view graph with two corrupt
    edges and a pair with no common neighbour."""
    rs = np.random.RandomState(27)
    n = 8
    R_gt = [Rotation.from_rotvec(rs.randn(3) * 0.2).as_matrix() for _ in range(n)]
    geoms = [(i, j) for i in range(n) for j in range(i + 1, min(i + 4, n))] + [(0, 7)]
    bad = Rotation.from_euler("XYZ", [1.2, 0.5, -0.8]).as_matrix()
    out = {}
    for pkg, tv in (("t", ttv), ("j", jtv)):
        gs = [tv.TwoViewGeometry(i, j, R_gt[j] @ R_gt[i].T, np.zeros(3), 100) for i, j in geoms]
        gs[0], gs[7] = gs[0]._replace(R=bad), gs[7]._replace(R=bad.T)
        out[pkg] = gs
    s_t, s_j = tdis.geodesic_consistency_scores(out["t"], n), jdis.geodesic_consistency_scores(out["j"], n)
    assert s_t == s_j and s_j[(0, 7)] == 0.5
    kw = {"percentile": 30.0} if filter_type == "percentile" else {}
    kept_t = tdis.filter_edges(out["t"], s_t, filter_type=filter_type, **kw)
    kept_j = jdis.filter_edges(out["j"], s_j, filter_type=filter_type, **kw)
    assert [(g.i, g.j) for g in kept_t] == [(g.i, g.j) for g in kept_j] and kept_j


# --- retrieval and the SfM tools ------------------------------------------------------

@pytest.fixture(scope="module")
def plane_views(tmp_path_factory):
    """test_sfm's rendered views: 4 PNGs of two textured planes from a camera
    arc (240x320), with K and the c2w poses."""
    d = tmp_path_factory.mktemp("views")
    K, poses = _render_plane_views(str(d / "images"), n_views=4)
    return str(d / "images"), K, poses


@pytest.mark.parametrize("kind", ["rgb_png", "grey_png", "rgba_png", "jpeg"])
def test_retrieval_descriptor_matches_jax(tmp_path, plane_views, kind):
    """The descriptor of each view read as OpenCV reads it (cv2.imread
    IMREAD_GRAYSCALE, INTER_AREA to 8x8 uint8 cells, calcHist), read by the
    port with PIL and numpy: equal to float32 rounding (atol 1e-6), for a
    colour, a grey and an RGBA PNG and a JPEG; and the same pairs."""
    import cv2

    img_dir = plane_views[0]
    files = sorted(os.listdir(img_dir))
    out = tmp_path / kind
    out.mkdir()
    names = []
    for f in files:
        rgb = np.asarray(Image.open(os.path.join(img_dir, f)).convert("RGB"))
        name = f.replace(".png", ".jpg" if kind == "jpeg" else ".png")
        im = Image.fromarray(rgb)
        if kind == "grey_png":
            im = im.convert("L")
        elif kind == "rgba_png":
            im = im.convert("RGBA")
        im.save(out / name)
        names.append(name)
    for name in names:
        path = str(out / name)
        np.testing.assert_array_equal(read_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
        gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        close(tret.global_descriptor(gray), jret.global_descriptor(gray), rtol=0, atol=1e-6)
    assert tret.pairs_from_retrieval(str(out), names, 2) == jret.pairs_from_retrieval(str(out), names, 2)


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scene_views(tmp_path_factory):
    """chip_smoke phase 19's scene rendered on the CPU: its 8 views at 378x504
    (a back plane and a 4x3 grid of patches at other depths, each with its
    own texture), and a folder with the first 4 of them; with K and the
    c2w poses.

    Not test_sfm's views (two planes, the second texture mirrored, 240x320):
    there JAX's own OpenCV poses are off the truth by up to 8.8 degrees in
    rotation and 86 in translation direction on some pairs, and move from
    0.20 to 8.79 degrees on one pair when only cv2's seed changes (FLANN's
    trees; 10 seeds), so no pose there can be held to JAX's."""
    d = tmp_path_factory.mktemp("scene")
    K, c2w = load_chip_smoke().render_plane_views(d / "all", device="cpu")
    (d / "four").mkdir()
    for f in sorted(os.listdir(d / "all"))[:4]:
        shutil.copy(d / "all" / f, d / "four" / f)
    return str(d / "all"), str(d / "four"), K, c2w


def seeded_runs(fn, *args, seeds=5, **kw):
    """fn's result with OpenCV's random generator (FLANN's trees draw from
    it) seeded 0, 1, ..., seeds - 1."""
    import cv2

    out = []
    for s in range(seeds):
        cv2.setRNGSeed(s)
        out.append(fn(*args, **kw))
    return out


def pose_errors(R, t, c2w, i, j):
    """(rotation, translation direction) errors in degrees of a relative pose
    x_j = R x_i + t against the views' true poses."""
    w2c_i, w2c_j = np.linalg.inv(c2w[i]), np.linalg.inv(c2w[j])
    R_true = w2c_j[:3, :3] @ w2c_i[:3, :3].T
    t_true = w2c_j[:3, 3] - R_true @ w2c_i[:3, 3]
    return pose_difference(R, t, R_true, t_true)


def pose_difference(R, t, R2, t2):
    """The angle between two rotations and between two translation
    directions, in degrees."""
    rot = np.degrees(np.linalg.norm(Rotation.from_matrix(R @ R2.T).as_rotvec()))
    cos = np.dot(t, t2) / (np.linalg.norm(t) * np.linalg.norm(t2))
    return rot, np.degrees(np.arccos(np.clip(cos, -1, 1)))


def check_edges(got, runs, c2w):
    """The port's edges [(i, j, R, t, inliers)] against JAX's OpenCV ones from
    the same views at 5 cv2 seeds (`runs`, seed 0 first), pair by pair.

    >= 90% of JAX's seed-0 pairs are kept; a kept pair's inlier count is
    within 5% of JAX's; R is a rotation and t a unit vector (1e-9); R lies
    within 0.5 degrees and t within 2 degrees of JAX's R and t at one of the
    seeds; and the rotation and translation-direction errors against the
    true poses are each at most JAX's largest over the seeds + 0.5 degrees.

    JAX is taken over 5 seeds because its own pose moves with FLANN's seed:
    on this scene two of its seeds differ by up to 1.10 degrees on a pair
    (19 pairs, 5 seeds). OpenCV's RANSAC keeps the five-point model with
    the most inliers and refines nothing, so a pose is as good as the best
    of a few samples; on the same correspondences the port's RANSAC over 10
    generator seeds and OpenCV's over 10 orders of the points err by 0.25
    and 0.22 degrees on average, 1.09 and 1.26 at most. The port's largest
    distance to the nearest seed was 0.33 degrees in rotation."""
    g = {(i, j): (R, t, n) for i, j, R, t, n in got}
    want = [{(i, j): (R, np.asarray(t).reshape(3), n) for i, j, R, t, n in run} for run in runs]
    kept = set(g) & set(want[0])
    assert len(want[0]) >= 3 and len(kept) >= 0.9 * len(want[0]), (sorted(g), sorted(want[0]))
    for p in sorted(kept):
        R, t, n = g[p]
        assert abs(n - want[0][p][2]) <= 0.05 * want[0][p][2], (p, n, want[0][p][2])
        assert isinstance(R, np.ndarray) and R.dtype == np.float64 and t.shape == (3,) and isinstance(n, int)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-9)
        assert abs(np.linalg.det(R) - 1) < 1e-9 and abs(np.linalg.norm(t) - 1) < 1e-9
        theirs = [w[p] for w in want if p in w]
        near = np.min([pose_difference(R, t, Rj, tj) for Rj, tj, _ in theirs], axis=0)
        assert near[0] <= 0.5 and near[1] <= 2.0, (p, near)
        worst = np.max([pose_errors(Rj, tj, c2w, *p) for Rj, tj, _ in theirs], axis=0)
        err = pose_errors(R, t, c2w, *p)
        assert err[0] <= worst[0] + 0.5 and err[1] <= worst[1] + 0.5, (p, err, worst)


def test_two_view_matches_jax(scene_views):
    """build_view_graph on the CPU on phase 19's 8 views and retrieval's pairs
    (4 a view, as phase 19 runs it) against JAX's OpenCV one at 5 cv2 seeds:
    check_edges' tolerances."""
    img_dir, _, K, c2w = scene_views
    files = sorted(os.listdir(img_dir))
    pairs = jret.pairs_from_retrieval(img_dir, files, 4)
    got = ttv.build_view_graph(img_dir, files, pairs, K, 30, device="cpu")
    runs = seeded_runs(jtv.build_view_graph, img_dir, files, pairs, K, 30)
    check_edges([(g.i, g.j, g.R, g.t, g.num_inliers) for g in got],
                [[(g.i, g.j, g.R, g.t, g.num_inliers) for g in run] for run in runs], c2w)


def relative_rotation_errors(c2w, gt):
    """test_sfm's measure: the mean over view pairs of the error of the
    relative rotation between two global poses, in degrees."""
    errs = []
    for a in range(len(gt)):
        for b in range(a + 1, len(gt)):
            Rp = c2w[b][:3, :3].T @ c2w[a][:3, :3]
            Rg = gt[b][:3, :3].T @ gt[a][:3, :3]
            errs.append(np.degrees(np.linalg.norm(Rotation.from_matrix(Rp @ Rg.T).as_rotvec())))
    return float(np.mean(errs))


def test_sfm_pipeline_matches_jax(scene_views, tmp_path):
    """run_sfm_pipeline on the CPU end to end on 4 of phase 19's views against
    JAX's at 5 cv2 seeds: the same files; the geometries within
    check_edges' tolerances; >= 90% of JAX's (seed 0) scored pairs scored;
    view_graph.g2o with a vertex per view and an edge per kept geometry;
    poses_bounds.npy of JAX's shape with the same h, w, f and bounds
    columns (exact); the global poses' mean relative rotation error at most
    JAX's largest over the seeds + 0.5 degrees."""
    _, img_dir, K, c2w = scene_views
    got = tpipe.run_sfm_pipeline(img_dir, str(tmp_path / "t"), K, num_matches=3, min_inliers=20, device="cpu")
    runs = seeded_runs(jpipe.run_sfm_pipeline, img_dir, str(tmp_path / "j"), K, num_matches=3, min_inliers=20)
    assert got["files"] == runs[0]["files"]
    check_edges([(g.i, g.j, g.R, g.t, g.num_inliers) for g in got["geometries"]],
                [[(g.i, g.j, g.R, g.t, g.num_inliers) for g in run["geometries"]] for run in runs], c2w)
    assert len(set(got["scores"]) & set(runs[0]["scores"])) >= 0.9 * len(runs[0]["scores"])
    absolute, pairs, _ = tpa.read_g2o_file(str(tmp_path / "t" / "view_graph.g2o"))
    assert absolute.shape == (4, 7) and len(pairs) == len(got["geometries"])
    pb_t, pb_j = np.load(tmp_path / "t" / "poses_bounds.npy"), np.load(tmp_path / "j" / "poses_bounds.npy")
    assert pb_t.shape == pb_j.shape == (4, 17)
    hwf_bounds = [4, 9, 14, 15, 16]
    np.testing.assert_array_equal(pb_t[:, hwf_bounds], pb_j[:, hwf_bounds])
    gt = c2w[:4]
    worst = max(relative_rotation_errors(run["poses_c2w"], gt) for run in runs)
    assert relative_rotation_errors(got["poses_c2w"], gt) <= worst + 0.5


def test_extract_relative_poses_matches_jax(scene_views, tmp_path):
    """rotmat_to_quat on every pivot branch (exact); the CLI on the CPU on 4 of
    phase 19's views against the root script's OpenCV extraction at 5 cv2
    seeds: the same files, the edges within check_edges' tolerances, and
    its g2o equal to the root script's write_g2o of the port's edges
    (exact)."""
    for R in (*TIES.values(), rotation_about([0.2, -0.5, 0.9], 2.5), rotation_about([0.9, 0.1, 0.1], 3.0)):
        np.testing.assert_array_equal(textract.rotmat_to_quat(R), jextract.rotmat_to_quat(R))
    _, img_dir, K, c2w = scene_views
    fx = float(K[0, 0])
    files, edges = textract.main(["--image_dir", img_dir, "--out", str(tmp_path / "t.g2o"), "--fx", str(fx),
                                  "--device", "cpu", "--seed", "0"])
    runs = seeded_runs(jextract.extract_relative_poses, img_dir, K)
    assert files == runs[0][0]
    check_edges(edges, [run[1] for run in runs], c2w)
    jextract.write_g2o(str(tmp_path / "j.g2o"), len(files), edges)
    assert (tmp_path / "t.g2o").read_text() == (tmp_path / "j.g2o").read_text()
    absolute, pairs, rels = tpa.read_g2o_file(str(tmp_path / "t.g2o"))
    assert absolute.shape == (4, 7) and len(pairs) == len(edges)
