"""The port's "tiled" and "reference" backends, its banked kernel-backend
render, every depth mode and the quality-aware capacity policy, against
the JAX package on the CPU on the same numpy-seeded inputs.

Images agree within test_torch_rasterizer.py's tolerance (mean abs < 1e-5,
under 2e-3 of pixels off by more than 2e-3); gradients within 2e-4 of each
gradient's largest entry, as in test_torch_rasterizer_bwd.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrt_official_tpu.ops.rasterizer import api as japi
from ggrt_official_torch.ops.rasterizer import api as tapi
from tests.test_torch_banked import population
from tests.test_torch_rasterizer import SHAPE, image_close, make_scene
from tests.test_torch_rasterizer_bwd import close_to_scale

CAMS = ("extrinsics", "intrinsics", "near", "far")
LEAVES = ("means", "covariances", "sh_coeffs", "opacities", "extrinsics")
DEPTH_MODES = ("depth", "disparity", "relative_disparity", "log")
TINY = (16, 32)
POLICY_SHAPE = (32, 128)


def jrender(scene, shape, **kw):
    return japi.render(*(jnp.asarray(scene[k]) for k in CAMS), shape,
                       *(jnp.asarray(scene[k]) for k in ("background", "means", "covariances",
                                                         "sh_coeffs", "opacities")), **kw)


def trender(scene, shape, **kw):
    return tapi.render(*(torch.tensor(scene[k]) for k in CAMS), shape,
                       *(torch.tensor(scene[k]) for k in ("background", "means", "covariances",
                                                          "sh_coeffs", "opacities")), **kw)


def policy_scene():
    """test_torch_banked.py's population over four 8x128 tiles: demand far
    above the floor, so several K are probed."""
    pop = population(seed=11, n=3000)
    pop = {k: np.asarray(v, np.float32)[None] for k, v in pop.items()}
    pop["background"] = np.zeros((1, 3), np.float32)
    return pop


def policy_args(scene, lib):
    arr = jnp.asarray if lib == "jax" else torch.tensor
    return ([arr(scene[k]) for k in CAMS] + [POLICY_SHAPE]
            + [arr(scene[k]) for k in ("background", "means", "covariances", "sh_coeffs",
                                       "opacities")])


@pytest.fixture(scope="module")
def jax_side():
    """Everything computed by the JAX package, once per module."""
    scene = make_scene()
    cot = np.random.RandomState(2).normal(size=(1, 3, *SHAPE)).astype(np.float32)
    kw = dict(backend="tiled", max_per_tile=256)
    out = {"scene": scene, "cot": cot}
    out["tiled"] = np.asarray(jrender(scene, SHAPE, **kw))

    def loss(m, c, s, o, e):
        img = japi.render(e, *(jnp.asarray(scene[k]) for k in CAMS[1:]), SHAPE,
                          jnp.asarray(scene["background"]), m, c, s, o, **kw)
        return jnp.sum(img * cot)

    out["grads"] = [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(scene[k]) for k in LEAVES))]
    out["banked"] = np.asarray(jrender(scene, SHAPE, binning_mode="banked", max_dup=8, **kw))
    depth_args = [jnp.asarray(scene[k]) for k in CAMS] + [SHAPE] + [
        jnp.asarray(scene[k]) for k in ("means", "covariances", "opacities")]
    for mode in DEPTH_MODES:
        out[mode] = np.asarray(japi.render_depth(*depth_args, mode=mode, **kw))
    tiny = make_scene(seed=3, n=60)
    out["tiny"] = tiny
    out["reference"] = np.asarray(jrender(tiny, TINY, backend="reference", tile_shape=(8, 16)))
    out["policy"] = japi.choose_max_per_tile(*policy_args(policy_scene(), "jax"),
                                             target_db=45.0, max_dup=8, floor=64)
    return out


def test_tiled_forward_matches_jax(jax_side):
    for chunk in (4, 16):
        img = trender(jax_side["scene"], SHAPE, backend="tiled", max_per_tile=256, tile_chunk=chunk)
        image_close(img.numpy(), jax_side["tiled"], f"tile_chunk {chunk}")


@pytest.mark.parametrize("tile_chunk", [4, 16])
def test_tiled_gradients_match_jax(jax_side, tile_chunk):
    """torch autograd through the checkpointed chunks (6 tiles: chunks of 4
    pad the last one) against jax.grad of the JAX tiled render, with
    respect to means, covariances, SH, opacities and extrinsics."""
    scene = jax_side["scene"]
    leaves = [torch.tensor(scene[k], requires_grad=True) for k in LEAVES]
    img = tapi.render(leaves[4], *(torch.tensor(scene[k]) for k in CAMS[1:]), SHAPE,
                      torch.tensor(scene["background"]), *leaves[:4], backend="tiled",
                      max_per_tile=256, tile_chunk=tile_chunk)
    grads = torch.autograd.grad((img * torch.tensor(jax_side["cot"])).sum(), leaves)
    for name, a, b in zip(LEAVES, grads, jax_side["grads"]):
        close_to_scale(a.numpy(), b, rtol=2e-4, name=name)


def test_reference_matches_jax(jax_side):
    img = trender(jax_side["tiny"], TINY, backend="reference", tile_shape=(8, 16))
    assert img.shape == (1, 3, *TINY)
    image_close(img.numpy(), jax_side["reference"], "reference")
    # The oracle and the binned backends cull alike: the tiled render of the
    # same scene at the same tile shape agrees with it.
    tiled = trender(jax_side["tiny"], TINY, backend="tiled", tile_shape=(8, 16), max_per_tile=128)
    image_close(tiled.numpy(), img.numpy(), "tiled against reference")


def test_banked_kernel_backend_matches_jax_tiled(jax_side):
    """The bench's configuration at test size: backend "cuda" (the plain
    compositor on the CPU) with banked binning, against JAX's tiled render
    with banked binning."""
    img = trender(jax_side["scene"], SHAPE, backend="cuda", binning_mode="banked", max_dup=8,
                  max_per_tile=256)
    image_close(img.numpy(), jax_side["banked"], "banked")
    counting = trender(jax_side["scene"], SHAPE, backend="cuda", binning_mode="counting",
                       max_per_tile=256)
    sort = trender(jax_side["scene"], SHAPE, backend="cuda", max_per_tile=256)
    torch.testing.assert_close(counting, sort, rtol=0, atol=0)


@pytest.mark.parametrize("mode", DEPTH_MODES)
def test_render_depth_modes_match_jax(jax_side, mode):
    scene = jax_side["scene"]
    args = [torch.tensor(scene[k]) for k in CAMS] + [SHAPE] + [
        torch.tensor(scene[k]) for k in ("means", "covariances", "opacities")]
    depth = tapi.render_depth(*args, mode=mode, backend="tiled", max_per_tile=256)
    assert depth.shape == (1, *SHAPE)
    image_close(depth.numpy(), jax_side[mode], mode)


def test_choose_max_per_tile_matches_jax(jax_side):
    ref = dict(jax_side["policy"])
    got = tapi.choose_max_per_tile(*policy_args(policy_scene(), "torch"), target_db=45.0,
                                   max_dup=8, floor=64)
    psnr, ref_psnr = got.pop("psnr_at_k"), ref.pop("psnr_at_k")
    assert got == ref
    assert list(psnr) == list(ref_psnr) and len(psnr) > 1
    # The same renders in float32, summed in another order.
    np.testing.assert_allclose(list(psnr.values()), list(ref_psnr.values()), rtol=0, atol=0.05)

