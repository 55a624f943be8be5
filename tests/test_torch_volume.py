"""The port's legacy volume-rendering path (rendering/{rays,projector,volume}.py)
against the JAX package's on the CPU: rays, projections, ray angles,
project_and_gather with and without predicted relative poses, sample_pdf
(deterministic and with injected draws), the depth samplings (uniform,
inverse-uniform, around an inverse-depth prior), raw2outputs, render_rays
coarse+fine (its gradient stops at the coarse weights) and the chunked
render_image with padding.

Inputs are made with numpy from a seed; where JAX draws, its own draws are
passed to the port. The module fixture computes every JAX result once,
each through jax.jit. Each test states its tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrt_official_torch.rendering import projector as tproj
from ggrt_official_torch.rendering import rays as trays
from ggrt_official_torch.rendering import volume as tvol
from ggrt_official_tpu.rendering import projector as jproj
from ggrt_official_tpu.rendering import rays as jrays
from ggrt_official_tpu.rendering import volume as jvol

H, W, V, D = 24, 32, 3, 5
N_SAMPLES, N_IMPORTANCE = 8, 6
RNG_KEY = 7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.tensor(np.asarray(x))


def close(actual, expected, **tol):
    np.testing.assert_allclose(np.asarray(actual.detach() if isinstance(actual, torch.Tensor) else actual,
                                          np.float64),
                               np.asarray(expected, np.float64), **tol)


def rodrigues(w):
    th = np.linalg.norm(w)
    k = w / max(th, 1e-12)
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def camera(h, w, c2w, f=30.0):
    K = np.eye(4)
    K[:3, :3] = [[f, 0, w / 2], [0, f * 1.1, h / 2], [0, 0, 1]]
    return np.concatenate([[h, w], K.ravel(), c2w.ravel()]).astype(np.float32)


def scene(seed=0, h=H, w=W, v=V, d=D):
    """A query camera and v source cameras near the origin looking down +z,
    source images, feature maps at half size, relative poses."""
    rng = np.random.RandomState(seed)

    def pose():
        c2w = np.eye(4)
        c2w[:3, :3] = rodrigues(rng.normal(size=3) * 0.08)
        c2w[:3, 3] = rng.uniform(-0.3, 0.3, 3) * [1, 1, 0.2]
        return c2w

    return dict(
        query=camera(h, w, pose()),
        src_cameras=np.stack([camera(h, w, pose()) for _ in range(v)]),
        src_rgbs=rng.uniform(size=(v, h, w, 3)).astype(np.float32),
        feats=rng.normal(size=(v, h // 2, w // 2, d)).astype(np.float32),
        fine_feats=rng.normal(size=(v, h // 2, w // 2, d)).astype(np.float32),
        rel_poses=(rng.normal(size=(v, 6)) * [0.05, 0.05, 0.05, 0.03, 0.03, 0.03]).astype(np.float32),
        depth_range=np.array([1.5, 6.0], np.float32),
        theta=np.array([0.7, -0.4, 1.3], np.float32),
    )


def j_apply(theta):
    """A smooth stand-in for IBRNet: (rgb_feat, ray_diff, mask) -> (r, s, 4)."""
    def apply(rgb_feat, ray_diff, mask):
        m = mask / (jnp.sum(mask, axis=2, keepdims=True) + 1e-3)
        rgb = jax.nn.sigmoid(theta[0] * jnp.sum(rgb_feat[..., :3] * m, axis=2))
        s = jnp.sum(jnp.mean(rgb_feat[..., 3:], axis=-1, keepdims=True) * m, axis=2) * theta[1]
        sigma = jax.nn.softplus(s + theta[2] * jnp.mean(ray_diff[..., 3:], axis=2))
        return jnp.concatenate([rgb, sigma], axis=-1)
    return apply


def t_apply(theta):
    def apply(rgb_feat, ray_diff, mask):
        m = mask / (torch.sum(mask, dim=2, keepdim=True) + 1e-3)
        rgb = torch.sigmoid(theta[0] * torch.sum(rgb_feat[..., :3] * m, dim=2))
        s = torch.sum(torch.mean(rgb_feat[..., 3:], dim=-1, keepdim=True) * m, dim=2) * theta[1]
        sigma = torch.nn.functional.softplus(s + theta[2] * torch.mean(ray_diff[..., 3:], dim=2))
        return torch.cat([rgb, sigma], dim=-1)
    return apply


def ray_batch(sc, ray_o, ray_d, lib):
    arr = jnp.asarray if lib == "jax" else t
    return {"ray_o": ray_o, "ray_d": ray_d, "depth_range": arr(sc["depth_range"]), "camera": arr(sc["query"]),
            "src_rgbs": arr(sc["src_rgbs"]), "src_cameras": arr(sc["src_cameras"])}


def query_rays(sc, stride, lib):
    cam = sc["query"]
    K, c2w = cam[2:18].reshape(1, 4, 4), cam[18:34].reshape(1, 4, 4)
    if lib == "jax":
        return jrays.get_rays_single_image(H, W, jnp.asarray(K), jnp.asarray(c2w), render_stride=stride)
    return trays.get_rays_single_image(H, W, t(K), t(c2w), render_stride=stride)


def render_kwargs(inv_uniform):
    return dict(inv_uniform=inv_uniform, n_importance=N_IMPORTANCE, det=False)


@pytest.fixture(scope="module")
def jx():
    """Every JAX result the tests compare with, each from a jitted call."""
    sc = scene()
    out = {"scene": sc}
    for stride in (1, 3):
        out[f"rays{stride}"] = [np.asarray(a) for a in jax.jit(lambda s=stride: query_rays(sc, s, "jax"))()]
    ro, rd = query_rays(sc, 2, "jax")
    pts, z = jvol.sample_along_camera_ray(None, ro, rd, jnp.asarray(sc["depth_range"]), N_SAMPLES, det=True)
    out["pts"] = np.asarray(pts)
    cams = jnp.asarray(sc["src_cameras"])
    poses, Ks = cams[:, 18:34].reshape(-1, 4, 4), cams[:, 2:18].reshape(-1, 4, 4)
    out["proj"] = [np.asarray(a) for a in jax.jit(jproj.compute_projections)(pts.reshape(-1, 3), Ks, poses)]
    out["angle"] = np.asarray(jax.jit(jproj.compute_angle)(pts.reshape(-1, 3), jnp.asarray(sc["query"][18:34]).reshape(4, 4), poses))
    gather = jax.jit(lambda p, rel: jproj.project_and_gather(p, jnp.asarray(sc["query"]), jnp.asarray(sc["src_rgbs"]), cams,
                                                             jnp.asarray(sc["feats"]), rel_poses=rel))
    out["gather"] = [np.asarray(a) for a in gather(pts, None)]
    out["gather_rel"] = [np.asarray(a) for a in gather(pts, jnp.asarray(sc["rel_poses"]))]

    # Draws for the sampling tests and for render_rays.
    r = ro.shape[0]
    key = jax.random.PRNGKey(RNG_KEY)
    k1, k2, _ = jax.random.split(key, 3)
    out["t_rand"] = np.asarray(jax.random.uniform(k1, (r, N_SAMPLES)))
    out["u_pdf"] = np.asarray(jax.random.uniform(k2, (r, N_IMPORTANCE)))
    rng = np.random.RandomState(3)
    out["bins"] = np.sort(rng.uniform(1, 5, (r, 11)), axis=1).astype(np.float32)
    out["pdf_w"] = rng.uniform(0.05, 1.0, (r, 10)).astype(np.float32)
    out["prior"] = rng.uniform(1 / 5.5, 1 / 2.0, r).astype(np.float32)
    sample_pdf = jax.jit(jvol.sample_pdf, static_argnums=(3, 4))
    out["pdf_det"] = np.asarray(sample_pdf(None, out["bins"], out["pdf_w"], N_IMPORTANCE, True))
    out["pdf_rand"] = np.asarray(sample_pdf(k2, out["bins"], out["pdf_w"], N_IMPORTANCE, False))
    along = jax.jit(jvol.sample_along_camera_ray, static_argnums=(4, 5, 6))
    dr = jnp.asarray(sc["depth_range"])
    for inv in (False, True):
        for det in (False, True):
            out[f"along_{inv}_{det}"] = [np.asarray(a) for a in along(k1, ro, rd, dr, N_SAMPLES, inv, det)]
    out["along_prior"] = [np.asarray(a) for a in jax.jit(
        lambda: jvol.sample_along_camera_ray(k1, ro, rd, dr, N_SAMPLES, det=False,
                                             inv_depth_prior=jnp.asarray(out["prior"])))()]
    raw = rng.normal(size=(r, N_SAMPLES, 4)).astype(np.float32)
    raw[..., 3] = np.abs(raw[..., 3]) * 2
    out["raw"], out["pixel_mask"] = raw, rng.uniform(size=(r, N_SAMPLES)) > 0.2
    for white in (False, True):
        res = jax.jit(jvol.raw2outputs, static_argnums=3)(raw, out["along_True_True"][1], out["pixel_mask"], white)
        out[f"raw2_{white}"] = {k: np.asarray(v) for k, v in res.items()}

    theta = jnp.asarray(sc["theta"])
    feats = (jnp.asarray(sc["feats"]), jnp.asarray(sc["fine_feats"]))
    for inv in (False, True):
        def fine_rgb(th, inv=inv):
            ret = jvol.render_rays(key, ray_batch(sc, ro, rd, "jax"), j_apply(th), feats, N_SAMPLES,
                                   apply_fine=j_apply(th * 1.1), rel_poses=jnp.asarray(sc["rel_poses"]),
                                   **render_kwargs(inv))
            return ret["outputs_fine"]["rgb"].sum(), ret
        (_, ret), grad = jax.jit(jax.value_and_grad(fine_rgb, has_aux=True))(theta)
        out[f"render_{inv}"] = jax.tree_util.tree_map(np.asarray, ret)
        out[f"render_grad_{inv}"] = np.asarray(grad)

    # render_image: 8 x 11 = 88 rays at stride 3 in chunks of 32 (8 padded).
    ro3, rd3 = query_rays(sc, 3, "jax")
    image = jax.jit(lambda det, rng_key: jvol.render_image(
        rng_key, ray_batch(sc, ro3, rd3, "jax"), j_apply(theta), feats, N_SAMPLES, chunk_size=32, det=det,
        inv_uniform=True), static_argnums=0)
    out["image_det"] = [np.asarray(a) for a in image(True, key)]
    out["image_rand"] = [np.asarray(a) for a in image(False, key)]
    out["image_draws"] = [(np.asarray(jax.random.uniform(jax.random.split(ck, 3)[0], (32, N_SAMPLES))), None)
                          for ck in jax.random.split(key, 3)]
    return out


@pytest.mark.parametrize("stride", [1, 3])
def test_rays(jx, stride):
    """Pixel-corner rays (not normalised) at render_stride 1 and 3: rtol
    1e-5, atol 1e-5 (K's inverse by LU in both, in another order)."""
    ro, rd = query_rays(jx["scene"], stride, "torch")
    assert ro.shape == rd.shape == jx[f"rays{stride}"][0].shape
    close(ro, jx[f"rays{stride}"][0], rtol=1e-6, atol=1e-6)
    close(rd, jx[f"rays{stride}"][1], rtol=1e-5, atol=1e-5)
    w, h, K, c2w = trays.parse_camera(t(jx["scene"]["query"][None]))
    assert (float(w[0]), float(h[0])) == (W, H) and K.shape == c2w.shape == (1, 4, 4)


def test_projections_and_angles(jx):
    """Pixel locations (up to ~40 px): atol 2e-4 (the pose inverse and the
    three-operand einsum contract in another order); the in-front mask
    equal; the angle features rtol 1e-5, atol 2e-5."""
    sc = jx["scene"]
    cams = t(sc["src_cameras"])
    xyz = t(jx["pts"]).reshape(-1, 3)
    pix, front = tproj.compute_projections(xyz, cams[:, 2:18].reshape(-1, 4, 4), cams[:, 18:34].reshape(-1, 4, 4))
    close(pix, jx["proj"][0], rtol=1e-5, atol=2e-4)
    np.testing.assert_array_equal(front.numpy(), jx["proj"][1])
    ang = tproj.compute_angle(xyz, t(sc["query"][18:34]).reshape(4, 4), cams[:, 18:34].reshape(-1, 4, 4))
    close(ang, jx["angle"], rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("rel", [False, True])
def test_project_and_gather(jx, rel):
    """rgb and features gathered bilinearly (align_corners=True), ray-angle
    features, the mask; with rel_poses the source poses come from the
    query pose and the predicted target->source 6-vectors. rgb_feat and
    ray_diff atol 1e-4 (a pixel location off by 2e-4 moves a bilinear
    sample of unit-variance features by about that); ray_diff atol 1e-4
    (its direction divides the difference of two unit vectors by its norm,
    ~1e-2 where the rays are near parallel, so the poses' rounding grows a
    hundredfold); the mask equal but for samples within 1e-3 px of an image
    edge."""
    sc = jx["scene"]
    got = tproj.project_and_gather(t(jx["pts"]), t(sc["query"]), t(sc["src_rgbs"]), t(sc["src_cameras"]),
                                   t(sc["feats"]), rel_poses=t(sc["rel_poses"]) if rel else None)
    want = jx["gather_rel" if rel else "gather"]
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert 0 < want[2].mean() < 1
    close(got[0], want[0], rtol=1e-4, atol=1e-4)
    close(got[1], want[1], rtol=1e-5, atol=1e-4)
    assert (got[2].numpy() != want[2]).mean() < 1e-3


def test_sample_pdf(jx):
    """Deterministic and injected-draw importance samples: rtol 1e-5,
    atol 1e-5 (bins in [1, 5]). The weights lie in [0.05, 1]: a bin of far
    less mass makes t divide by a cdf difference of ~1e-5, which multiplies
    the two cumsums' different rounding ~1e4-fold (weights**4 put 14 of
    1,152 samples 2e-3 apart)."""
    bins, w = t(jx["bins"]), t(jx["pdf_w"])
    close(tvol.sample_pdf(bins, w, N_IMPORTANCE, det=True), jx["pdf_det"], rtol=1e-5, atol=1e-5)
    close(tvol.sample_pdf(bins, w, N_IMPORTANCE, uniforms=t(jx["u_pdf"])), jx["pdf_rand"], rtol=1e-5, atol=1e-5)
    g = torch.Generator().manual_seed(0)
    drawn = tvol.sample_pdf(bins, w, N_IMPORTANCE, generator=g)
    assert drawn.shape == (bins.shape[0], N_IMPORTANCE) and bool(((drawn >= 1) & (drawn <= 5)).all())


def test_sample_pdf_one_deterministic_sample():
    """det with n_samples = 1 on 4 rays of 8 bins: jnp.linspace(0, 1, 1) =
    [0] puts the one sample at the first bin's edge where JAX's does, finite
    and within 1e-6 (u = arange(1)/0 would make it NaN)."""
    rng = np.random.RandomState(3)
    bins = np.sort(rng.uniform(1.0, 5.0, (4, 9)), axis=-1).astype(np.float32)
    w = rng.uniform(0.05, 1.0, (4, 8)).astype(np.float32)
    want = np.asarray(jax.jit(jvol.sample_pdf, static_argnums=(3, 4))(None, bins, w, 1, True))
    got = tvol.sample_pdf(t(bins), t(w), 1, det=True)
    assert got.shape == (4, 1) and bool(torch.isfinite(got).all())
    close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("inv", [False, True])
@pytest.mark.parametrize("det", [False, True])
def test_sample_along_camera_ray(jx, inv, det):
    """Uniform and inverse-uniform depths, deterministic and jittered by
    JAX's draws: rtol 1e-5, atol 1e-5."""
    ro, rd = query_rays(jx["scene"], 2, "torch")
    pts, z = tvol.sample_along_camera_ray(ro, rd, t(jx["scene"]["depth_range"]), N_SAMPLES, inv_uniform=inv,
                                          det=det, uniforms=None if det else t(jx["t_rand"]))
    close(z, jx[f"along_{inv}_{det}"][1], rtol=1e-5, atol=1e-5)
    close(pts, jx[f"along_{inv}_{det}"][0], rtol=1e-5, atol=1e-5)


def test_sample_around_depth_prior(jx):
    """inv_depth_prior: samples in [1/prior - 1, 1/prior + 1] clipped to the
    depth range, jittered: rtol 1e-5, atol 1e-5."""
    ro, rd = query_rays(jx["scene"], 2, "torch")
    pts, z = tvol.sample_along_camera_ray(ro, rd, t(jx["scene"]["depth_range"]), N_SAMPLES,
                                          inv_depth_prior=t(jx["prior"]), uniforms=t(jx["t_rand"]))
    close(z, jx["along_prior"][1], rtol=1e-5, atol=1e-5)
    close(pts, jx["along_prior"][0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("white", [False, True])
def test_raw2outputs(jx, white):
    """Alpha compositing with and without a white background: every output
    rtol 1e-5, atol 1e-6; the ray mask equal."""
    want = jx[f"raw2_{white}"]
    got = tvol.raw2outputs(t(jx["raw"]), t(jx["along_True_True"][1]), t(jx["pixel_mask"]), white)
    assert set(got) == set(want)
    for k in want:
        if k == "mask":
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        else:
            close(got[k], want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("inv", [False, True])
def test_render_rays_coarse_fine(jx, inv):
    """Coarse and fine passes with relative poses, jittered depths and
    importance samples at JAX's draws, uniform and inverse-uniform: rgb,
    depth, weights and z_vals rtol 1e-4, atol 1e-4 (importance samples
    follow a cumsum of the coarse weights). The gradient of the fine rgb's
    sum by the stand-in's parameters flows only through the fine pass (the
    coarse weights are detached): rtol 1e-3, atol 1e-3 of its sum over 48
    rays."""
    sc = jx["scene"]
    ro, rd = query_rays(sc, 2, "torch")
    theta = t(sc["theta"]).requires_grad_(True)
    ret = tvol.render_rays(ray_batch(sc, ro, rd, "torch"), t_apply(theta), (t(sc["feats"]), t(sc["fine_feats"])),
                           N_SAMPLES, apply_fine=t_apply(theta * 1.1), rel_poses=t(sc["rel_poses"]),
                           uniforms=(t(jx["t_rand"]), t(jx["u_pdf"])), **render_kwargs(inv))
    want = jx[f"render_{inv}"]
    for level in ("outputs_coarse", "outputs_fine"):
        for k in ("rgb", "depth", "weights", "z_vals"):
            close(ret[level][k], want[level][k], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(ret[level]["mask"].numpy(), want[level]["mask"])
    ret["outputs_fine"]["rgb"].sum().backward()
    close(theta.grad, jx[f"render_grad_{inv}"], rtol=1e-3, atol=1e-3)
    assert ret["outputs_coarse"]["weights"].requires_grad


@pytest.mark.parametrize("det", [True, False])
def test_render_image_pads_the_last_chunk(jx, det):
    """88 rays in chunks of 32 (the last padded by 8): coarse rgb and depth
    of the unpadded rays, deterministic or at each chunk's JAX draws: rtol
    1e-4, atol 1e-4."""
    sc = jx["scene"]
    ro, rd = query_rays(sc, 3, "torch")
    assert ro.shape[0] == 88
    rgb, depth = tvol.render_image(ray_batch(sc, ro, rd, "torch"), t_apply(t(sc["theta"])),
                                   (t(sc["feats"]), t(sc["fine_feats"])), N_SAMPLES, chunk_size=32, det=det,
                                   inv_uniform=True,
                                   uniforms=None if det else [(t(a), b) for a, b in jx["image_draws"]])
    want = jx["image_det" if det else "image_rand"]
    assert rgb.shape == (88, 3) and depth.shape == (88,)
    close(rgb, want[0], rtol=1e-4, atol=1e-4)
    close(depth, want[1], rtol=1e-4, atol=1e-4)
