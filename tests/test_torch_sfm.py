"""The port's OpenCV-free SfM pieces against OpenCV, on the CPU: SIFT
(`sfm/sift.py`) against cv2.SIFT_create on test_sfm's plane views at
240x320, its blur, upsampling and atan2 against OpenCV's; the exact 2-NN
ratio matching against a brute-force and a FLANN matcher; the five-point
solver, RANSAC and recoverPose (`sfm/essential.py`) against
cv2.findEssentialMat and cv2.recoverPose on synthetic correspondences.

OpenCV is installed here, not on the card's machine; the port imports none
of it. Inputs are made with numpy from a seed. Each test states its
tolerance.
"""
import os

import cv2
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from ggrt_official_torch.data.image_io import read_gray
from ggrt_official_torch.sfm import essential, sift, two_view
from tests.test_sfm import _render_plane_views


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grays(tmp_path_factory):
    """test_sfm's 4 plane views (240x320) as OpenCV reads them in grey."""
    d = tmp_path_factory.mktemp("views")
    _render_plane_views(str(d), n_views=4)
    return [read_gray(os.path.join(d, f)) for f in sorted(os.listdir(d))]


def cv2_sift(gray, nfeatures):
    kp, desc = cv2.SIFT_create(nfeatures=nfeatures).detectAndCompute(gray, None)
    return (np.array([k.pt for k in kp]), np.array([k.size for k in kp]), np.array([k.angle for k in kp]),
            np.array([k.octave for k in kp]), desc)


def counterparts(pt_a, size_a, ang_a, pt_b, size_b, ang_b):
    """For each keypoint of a, the index of a keypoint of b within 0.5 px,
    size within 5% and angle within 5 degrees (-1 where none)."""
    d = np.linalg.norm(pt_a[:, None] - pt_b[None], axis=-1)
    da = np.abs((ang_a[:, None] - ang_b[None] + 180) % 360 - 180)
    ok = (d < 0.5) & (np.abs(size_a[:, None] / size_b[None] - 1) < 0.05) & (da < 5)
    cost = np.where(ok, d + da / 360, np.inf)
    return np.where(ok.any(1), cost.argmin(1), -1)


@pytest.mark.parametrize("nfeatures", [0, 4096, 100])
def test_sift_matches_opencv(grays, nfeatures):
    """Keypoints as sets (retainBest's nth_element orders OpenCV's its own
    way): >= 90% of each side has a counterpart within 0.5 px, size within
    5% and angle within 5 degrees; a matched pair's descriptors differ by
    < 5% of OpenCV's norm; the octave codes of matched pairs agree."""
    for gray in grays:
        kp, desc = sift.detect_and_compute(gray, nfeatures, device="cpu")
        pt, size, ang = kp.pt.numpy(), kp.size.numpy(), kp.angle.numpy()
        c_pt, c_size, c_ang, c_oct, c_desc = cv2_sift(gray, nfeatures)
        fwd = counterparts(pt, size, ang, c_pt, c_size, c_ang)
        back = counterparts(c_pt, c_size, c_ang, pt, size, ang)
        assert (fwd >= 0).mean() >= 0.9 and (back >= 0).mean() >= 0.9, ((fwd >= 0).mean(), (back >= 0).mean())
        m = fwd >= 0
        rel = np.linalg.norm(desc.numpy()[m] - c_desc[fwd[m]], axis=1) / np.linalg.norm(c_desc[fwd[m]], axis=1)
        assert rel.max() < 0.05, rel.max()
        assert (kp.octave.numpy()[m] == c_oct[fwd[m]]).mean() >= 0.9
        assert desc.dtype == torch.float32 and desc.shape == (len(pt), 128)
        assert ((desc >= 0) & (desc <= 255) & (desc == desc.round())).all()
        if nfeatures:
            assert len(pt) >= min(nfeatures, len(c_pt)) * 0.9


def test_sift_result_does_not_depend_on_cap(grays, monkeypatch):
    """Too few candidate slots (16) make detect_and_compute run again with
    enough: the same keypoints and descriptors, bit for bit."""
    a = sift.detect_and_compute(grays[0], 4096, device="cpu")
    caps = []
    compact = sift._compact

    def spy(mask, cap):
        caps.append(cap)
        return compact(mask, cap)
    monkeypatch.setattr(sift, "_default_cap", lambda shape: 16)
    monkeypatch.setattr(sift, "_compact", spy)
    b = sift.detect_and_compute(grays[0], 4096, device="cpu")
    assert caps[0] == 16 and len(caps) == 2 and caps[1] > 16
    for x, y in zip((*a[0], a[1]), (*b[0], b[1])):
        assert torch.equal(x, y)


def test_sift_building_blocks_match_opencv():
    """The pyramid's blurs at every σ SIFT uses (and on an image smaller than
    the kernel: reflect-101 folds more than once) against cv2.GaussianBlur,
    atol 1e-3 on 0-255 values; the 2x INTER_LINEAR upsampling against
    cv2.resize, atol 1e-4; fast_atan2 against cv2.fastAtan2, 1e-3 degrees."""
    rng = np.random.RandomState(0)
    img = (rng.rand(37, 53) * 255).astype(np.float32)
    sigmas = [float(np.sqrt(np.float32(1.6) ** 2 - 1)), *sift.layer_sigmas()[1:]]
    for im in (img, img[:5, :7].copy()):
        for s in sigmas:
            want = cv2.GaussianBlur(im, (0, 0), s)
            np.testing.assert_allclose(sift.gaussian_blur(torch.from_numpy(im), s).numpy(), want, atol=1e-3)
    np.testing.assert_allclose(sift.upsample2(torch.from_numpy(img)).numpy(),
                               cv2.resize(img, (106, 74), interpolation=cv2.INTER_LINEAR), atol=1e-4)
    y, x = rng.randn(2, 500).astype(np.float32)
    y[:4], x[:4] = (0, 1, -1, 0), (1, 0, 0, -1)
    got = sift.fast_atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.array([cv2.fastAtan2(float(a), float(b)) for a, b in zip(y, x)])
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_ratio_matches_are_exact_2nn(grays):
    """The ratio test on the exact 2-NN: the same (query, train) pairs as
    OpenCV's brute-force L2 matcher, exactly; and >= 90% of the pairs JAX's
    FLANN matcher (5 trees, 50 checks, seeded) keeps."""
    feats = [sift.detect_and_compute(g, 4096, device="cpu") for g in grays[:2]]
    (_, di), (_, dj) = feats
    q, t = two_view.ratio_matches(di, dj, 0.8)
    got = set(zip(q.tolist(), t.tolist()))
    bf = cv2.BFMatcher(cv2.NORM_L2).knnMatch(di.numpy(), dj.numpy(), k=2)
    want = {(m.queryIdx, m.trainIdx) for m, nn in bf if m.distance < 0.8 * nn.distance}
    assert got == want and len(want) > 50
    cv2.setRNGSeed(0)
    flann = cv2.FlannBasedMatcher(dict(algorithm=1, trees=5), dict(checks=50)).knnMatch(di.numpy(), dj.numpy(), k=2)
    approx = {(m.queryIdx, m.trainIdx) for m, nn in flann if m.distance < 0.8 * nn.distance}
    assert len(approx & got) >= 0.9 * len(approx)


K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
# A 1280x960 camera for the RANSAC tests: at f = 300 a pose a fifth of a
# degree off still keeps every exact inlier within the 1 px threshold and
# may win by catching outliers; at f = 1200 the threshold is 4x tighter.
K_LONG = np.array([[1200.0, 0, 640], [0, 1200.0, 480], [0, 0, 1]])


def synthetic_pair(n, seed, outliers=0.3, noise=0.0, dtype=np.float32, K=K):
    """n correspondences of points 4-8 units in front of camera 1 seen from a
    camera rotated ~6 degrees and moved one unit; the first `outliers`
    share of camera 2's points replaced by uniform pixels of the image
    (2·cx by 2·cy)."""
    rs = np.random.RandomState(seed)
    R = Rotation.from_rotvec(rs.randn(3) * 0.1).as_matrix()
    t = rs.randn(3)
    t /= np.linalg.norm(t)
    X = np.c_[rs.uniform(-3, 3, (n, 2)), rs.uniform(4, 8, n)]
    x1 = (K @ X.T).T
    x2 = (K @ ((R @ X.T).T + t).T).T
    x1, x2 = x1[:, :2] / x1[:, 2:] + rs.randn(n, 2) * noise, x2[:, :2] / x2[:, 2:] + rs.randn(n, 2) * noise
    k = int(outliers * n)
    x2[:k] = rs.uniform(0, 1, (k, 2)) * 2 * K[:2, 2]
    return x1.astype(dtype), x2.astype(dtype), R, t


def rot_deg(Ra, Rb):
    return np.degrees(np.linalg.norm(Rotation.from_matrix(Ra @ Rb.T).as_rotvec()))


@pytest.mark.parametrize("seed", range(4))
def test_five_point_matches_opencv(seed):
    """On exactly 5 exact correspondences findEssentialMat returns every
    solution: the port's set equals OpenCV's, each E up to scale and sign
    within 1e-5, and holds the true E."""
    x1, x2, R, t = synthetic_pair(5, seed, outliers=0.0, dtype=np.float64)
    E_cv, _ = cv2.findEssentialMat(x1, x2, K, cv2.RANSAC, 0.999, 1.0)
    E_t, mask = essential.find_essential_mat(torch.from_numpy(x1), torch.from_numpy(x2), K)
    a = E_cv.reshape(-1, 3, 3) / np.linalg.norm(E_cv.reshape(-1, 3, 3), axis=(1, 2), keepdims=True)
    b = E_t.numpy().reshape(-1, 3, 3)

    def dist(e, f):
        return min(np.abs(e - f).max(), np.abs(e + f).max())
    assert len(a) == len(b) and mask.all()
    assert max(min(dist(e, f) for f in b) for e in a) < 1e-5
    assert max(min(dist(e, f) for f in a) for e in b) < 1e-5
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    true = tx @ R / np.linalg.norm(tx @ R)
    assert min(dist(true, f) for f in b) < 1e-5


@pytest.mark.parametrize("seed", range(3))
def test_recover_pose_matches_opencv(seed):
    """For OpenCV's RANSAC E, points and mask: R and t within 1e-5, the same
    count, the same mask (noisy points, 30% outliers); and
    decompose_essential_mat's four candidates are OpenCV's."""
    x1, x2, _, _ = synthetic_pair(200, seed, noise=0.3)
    E, mask = cv2.findEssentialMat(x1, x2, K, cv2.RANSAC, 0.999, 1.0)
    n, R, t, m = cv2.recoverPose(E, x1, x2, K, mask=mask.copy())
    cnt, Rt, tt, mt = essential.recover_pose(torch.from_numpy(E), torch.from_numpy(x1), torch.from_numpy(x2), K,
                                             torch.from_numpy(mask[:, 0]))
    assert int(cnt) == n > 100
    np.testing.assert_allclose(Rt.numpy(), R, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), t[:, 0], atol=1e-5)
    assert np.array_equal(mt.numpy(), m[:, 0] > 0)
    R1, R2, tc = cv2.decomposeEssentialMat(E)
    want = [(r, s * tc[:, 0]) for r in (R1, R2) for s in (1, -1)]
    R1t, R2t, t_ = essential.decompose_essential_mat(torch.from_numpy(E))
    got = [(r.numpy(), s * t_.numpy()) for r in (R1t, R2t) for s in (1, -1)]
    for r, v in want:
        assert min(np.abs(r - a).max() + np.abs(v - b).max() for a, b in got) < 1e-9


def test_ransac_recovers_the_pose():
    """findEssentialMat + recover_pose on 300 correspondences, 30% of them
    outliers (uniform pixels), the inliers exact: the rotation within 0.1
    degrees of the truth, the translation direction within 1 degree, every
    inlier in the mask and at most 3 outliers (a uniform pixel lands within
    the 1 px threshold of its epipolar line by chance); the same generator
    seed gives a bit-equal E and mask twice, another seed draws other
    samples. (Noisy inliers do not test the solver: with the 1 px threshold
    every hypothesis within a few tenths of a degree counts them all.)"""
    x1, x2, R, t = synthetic_pair(300, 7, K=K_LONG)
    p1, p2 = torch.from_numpy(x1), torch.from_numpy(x2)

    def run(seed):
        return essential.find_essential_mat(p1, p2, K_LONG, generator=torch.Generator().manual_seed(seed))
    E, mask = run(0)
    _, Rt, tt, _ = essential.recover_pose(E, p1, p2, K_LONG, mask)
    assert rot_deg(Rt.numpy(), R) < 0.1
    assert np.degrees(np.arccos(np.clip(tt.numpy() @ t, -1, 1))) < 1.0
    assert mask[:90].sum() <= 3 and mask[90:].all()
    E2, mask2 = run(0)
    assert torch.equal(E, E2) and torch.equal(mask, mask2)
    E3, _ = run(1)
    assert not torch.equal(E, E3)


def test_ransac_matches_opencv_on_the_same_correspondences():
    """RANSAC + recoverPose against OpenCV's on the same noisy
    correspondences (300 a pair, 30% outliers, inliers with 0.5 px noise, a
    1280x960 camera; 4 pairs). Neither draws the other's samples, so they
    are compared as distributions: the port over 8 generator seeds, OpenCV
    over 8 orders of the points (its RANSAC generator has a fixed seed).
    The port's mean rotation error is at most 1.2x OpenCV's and its mean
    inlier count within 2% of OpenCV's (measured: 0.149 and 0.147 degrees,
    186.8 and 185.1 inliers)."""
    err_t, err_cv, n_t, n_cv = [], [], [], []
    for scene in range(4):
        x1, x2, R, _ = synthetic_pair(300, 100 + scene, noise=0.5, K=K_LONG)
        p1, p2 = torch.from_numpy(x1), torch.from_numpy(x2)
        for s in range(8):
            E, mask = essential.find_essential_mat(p1, p2, K_LONG, generator=torch.Generator().manual_seed(s))
            _, Rt, _, _ = essential.recover_pose(E, p1, p2, K_LONG, mask)
            err_t.append(rot_deg(Rt.numpy(), R))
            n_t.append(int(mask.sum()))
            order = np.random.RandomState(s).permutation(len(x1))
            E_cv, mask_cv = cv2.findEssentialMat(x1[order], x2[order], K_LONG, cv2.RANSAC, 0.999, 1.0)
            _, R_cv, _, _ = cv2.recoverPose(E_cv[:3], x1[order], x2[order], K_LONG, mask=mask_cv)
            err_cv.append(rot_deg(R_cv, R))
            n_cv.append(int(mask_cv.sum()))
    assert np.mean(err_t) <= 1.2 * np.mean(err_cv), (np.mean(err_t), np.mean(err_cv))
    assert abs(np.mean(n_t) / np.mean(n_cv) - 1) <= 0.02, (np.mean(n_t), np.mean(n_cv))


def test_ransac_iteration_count_is_opencvs():
    """RANSACUpdateNumIters: OpenCV's values (log(1 - p) / log(1 - (1 - ep)^5),
    rounded, capped at the current count; 0 when no sample can hold an
    outlier)."""
    assert essential.ransac_update_num_iters(0.999, 0.5, 5, 1000) == int(np.rint(np.log(0.001) / np.log(1 - 0.5**5)))
    assert essential.ransac_update_num_iters(0.999, 0.9, 5, 1000) == 1000
    assert essential.ransac_update_num_iters(0.999, 0.0, 5, 1000) == 0


def test_two_view_geometry_semantics():
    """JAX's failure semantics: None with fewer than 5 points, and where the
    inliers fall short of min_inliers; numpy R, t and an int count else."""
    x1, x2, R, _ = synthetic_pair(120, 3, K=K_LONG)
    p1, p2 = torch.from_numpy(x1), torch.from_numpy(x2)
    assert essential.find_essential_mat(p1[:4], p2[:4], K_LONG) == (None, None)
    assert two_view.two_view_geometry(p1, p2, K_LONG, min_inliers=200, generator=torch.Generator()) is None
    Rt, tt, n = two_view.two_view_geometry(p1, p2, K_LONG, min_inliers=30, generator=torch.Generator())
    assert isinstance(Rt, np.ndarray) and Rt.shape == (3, 3) and tt.shape == (3,) and isinstance(n, int)
    assert rot_deg(Rt, R) < 0.1 and n >= 80


def test_poly_roots_find_numpys_real_roots():
    """poly_roots' fixed 25 Aberth steps on the degree-10 polynomials of 500
    random five-point samples: as many real roots (|Im| <= 1e-8·max(1, |z|))
    as numpy's companion-matrix roots in every sample, each within 1e-6 of
    one of numpy's (relative to max(1, |z|))."""
    rng = np.random.RandomState(11)
    q1 = torch.from_numpy(rng.rand(500, 5, 2) - 0.5)
    q2 = q1 + 0.05 * torch.from_numpy(rng.randn(500, 5, 2))
    seen = []
    orig = essential.poly_roots

    def spy(c):
        seen.append(c.clone())
        return orig(c)
    essential.poly_roots = spy
    try:
        essential.five_point(q1, q2)
    finally:
        essential.poly_roots = orig
    (c,) = seen
    z = orig(c).numpy()
    for row, got in zip(c.numpy(), z):
        want = np.roots(row[::-1])
        want = np.sort(want[np.abs(want.imag) <= 1e-8 * np.maximum(1, np.abs(want))].real)
        got = np.sort(got[np.abs(got.imag) <= 1e-8 * np.maximum(1, np.abs(got))].real)
        assert len(got) == len(want)
        assert np.all(np.abs(got - want) <= 1e-6 * np.maximum(1, np.abs(want)))
