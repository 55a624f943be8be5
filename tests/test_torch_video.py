"""The port's novel-view video renderer against the JAX package on the CPU:
the trajectory generators (utils/trajectories.py) on the same numpy
inputs, `render_video.render_frames` against the JAX script's
encode-once / decode-per-frame loop (scripts/render_video.py:66-89, rebuilt
here from the JAX package's own calls) at __graft_entry__._tiny_cfg()
widths on a 16x24 synthetic scene with the same weights
(`weights.params_from_jax`), and the CLI writing its PNG frames.
"""
import ast
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import __graft_entry__ as graft
from ggrt_official_torch import weights
from ggrt_official_torch.data import datasets as tds
from ggrt_official_torch.data.shims import get_data_shim as tshim
from ggrt_official_torch.geometry import se3 as tse3
from ggrt_official_torch.models import pixelsplat as tps
from ggrt_official_torch.scripts import render_video
from ggrt_official_torch.training.trainer import prepare_batch
from ggrt_official_torch.utils import trajectories as ttraj
from ggrt_official_tpu.data import datasets as jds
from ggrt_official_tpu.data.shims import get_data_shim as jshim
from ggrt_official_tpu.geometry import se3 as jse3
from ggrt_official_tpu.models import pixelsplat as jps
from ggrt_official_tpu.models.decoder_splatting import DecoderSplatting as JDecoder
from ggrt_official_tpu.utils import trajectories as jtraj
from tests.test_torch_models import port_cfg

ROOT = Path(__file__).resolve().parents[1]
N_FRAMES = 3
SPEC = dict(n_views=8, image_size=(16, 24))


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


# --- trajectories ------------------------------------------------------------------

def two_cameras(seed, angle):
    """Two c2w matrices `angle` radians apart (about a random axis) with
    different centres, as two LLFF views of one scene."""
    rng = np.random.RandomState(seed)
    axis = rng.normal(size=3)
    e0 = np.eye(4, dtype=np.float32)
    e0[:3, :3] = np.asarray(jse3.so3_exp(rng.normal(size=3).astype(np.float32) * 0.3))
    e0[:3, 3] = rng.normal(size=3)
    e1 = e0.copy()
    e1[:3, :3] = e0[:3, :3] @ np.asarray(jse3.so3_exp((axis / np.linalg.norm(axis) * angle).astype(np.float32)))
    e1[:3, 3] += rng.normal(size=3) * 0.3
    return e0, e1


@pytest.mark.parametrize("angle", [0.0, 1e-4, 0.05, 0.3, 1.2])
def test_so3_log_between_views(angle):
    """interpolate_extrinsics takes so3_log(R0ᵀ R1): the port's equals
    JAX's (both with eps 1e-7) over the angles between two LLFF views (the
    identity, under a degree, up to ~70 degrees), rtol 1e-5 atol 1e-6."""
    e0, e1 = two_cameras(41, angle)
    rel = e0[:3, :3].T @ e1[:3, :3]
    close(tse3.so3_log(t(rel)), jse3.so3_log(rel), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("angle", [0.0, 0.05, 1.2])
def test_trajectories_match_jax(angle):
    """cosine_ease, interpolate_extrinsics/intrinsics and the wobbles: rtol
    1e-5, atol 2e-6 (the same float32 operations, torch's linspace and cos
    against jnp's); spiral_path on the port's llff helpers, exactly."""
    n = 7
    close(ttraj.cosine_ease(n), jtraj.cosine_ease(n), rtol=0, atol=1e-6)
    tt = jtraj.cosine_ease(n)
    e0, e1 = two_cameras(42, angle)
    close(ttraj.interpolate_extrinsics(t(e0), t(e1), t(tt)), jtraj.interpolate_extrinsics(e0, e1, tt),
          rtol=1e-5, atol=2e-6)
    k0 = np.array([[0.9, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]], np.float32)
    k1 = k0 * np.float32(1.05)
    close(ttraj.interpolate_intrinsics(t(k0), t(k1), t(tt)), jtraj.interpolate_intrinsics(k0, k1, tt),
          rtol=1e-6, atol=1e-7)
    close(ttraj.generate_wobble(t(e0), 0.1, t(tt)), jtraj.generate_wobble(e0, 0.1, tt), rtol=1e-5, atol=2e-6)
    close(ttraj.generate_wobble_transformation(0.2, t(tt), 2, False),
          jtraj.generate_wobble_transformation(0.2, tt, 2, False), rtol=1e-5, atol=2e-6)
    c2w = np.concatenate([e0[:3, :4], np.array([[20.0], [30.0], [25.0]])], 1)
    args = (c2w, np.array([0.1, 0.9, 0.2]), np.array([0.5, 0.4, 0.1]), 4.0)
    np.testing.assert_array_equal(ttraj.spiral_path(*args, n_frames=9), jtraj.spiral_path(*args, n_frames=9))


# --- the renderer ------------------------------------------------------------------

@pytest.fixture(scope="module")
def video_case():
    """The JAX script's loop at _tiny_cfg() widths ("tiled" backend) on the
    first example of a 16x24 synthetic scene with 3 source views: the
    context encoded once, each of N_FRAMES frames decoded at the eased
    camera, clipped, scaled by 255 and cast to uint8. The port's PixelSplat
    gets the same weights."""
    cfg = graft._tiny_cfg()
    pcfg = port_cfg(cfg)
    ex = jds.collate_batch(jds.SyntheticPlanesDataset(jds.SyntheticSceneSpec(**SPEC), num_source_views=3)[0])
    jbatch = jshim(cfg.encoder)({"context": ex["context"], "target": ex["target"]})
    jbatch = jax.tree_util.tree_map(jnp.asarray, jbatch)
    model = jps.PixelSplat(cfg.encoder, cfg.decoder)
    ctx = jbatch["context"]
    # The weights and the encoded context from one compile: PixelSplat's
    # parameters are its encoder's, which encode_pairs initialises whole.
    gaussians, params = jax.jit(lambda c: model.init_with_output(
        {"params": jax.random.PRNGKey(3)}, c, 0, deterministic=True, method=jps.PixelSplat.encode_pairs))(ctx)
    decoder = JDecoder(cfg.decoder)
    h, w = jbatch["target"]["image"].shape[-2:]

    @jax.jit
    def decode(g, e, k, near, far):
        return decoder(g, e[None, None], k[None, None], near, far, (h, w)).color

    @jax.jit
    def trajectory(ctx):
        tt = jtraj.cosine_ease(N_FRAMES)
        return (jtraj.interpolate_extrinsics(ctx["extrinsics"][0, 0], ctx["extrinsics"][0, -1], tt),
                jtraj.interpolate_intrinsics(ctx["intrinsics"][0, 0], ctx["intrinsics"][0, -1], tt))

    extr, intr = trajectory(ctx)
    frames = []
    for i in range(N_FRAMES):
        color = decode(gaussians, extr[i], intr[i], ctx["near"][:, :1], ctx["far"][:, :1])
        img = np.clip(np.asarray(color[0, 0]).transpose(1, 2, 0), 0, 1)
        frames.append((img * 255).astype(np.uint8))

    port = tps.PixelSplat(pcfg.encoder, pcfg.decoder, device="cpu")
    port.load_state_dict(weights.params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg.encoder))
    tex = tds.collate_batch(tds.SyntheticPlanesDataset(tds.SyntheticSceneSpec(**SPEC), num_source_views=3)[0])
    return dict(cfg=pcfg, model=SimpleNamespace(gaussian=port.eval()),
                batch=prepare_batch(tex, tshim(pcfg.encoder), "cpu"), frames=np.stack(frames))


def test_render_frames_match_jax(video_case):
    """(N_FRAMES, 16, 24, 3) uint8 frames. The float images follow the
    render parity tests' rule (test_torch_rasterizer.image_close: the two
    compositors sum in another order, so a pixel may flip across a
    cut-off); after the cast to uint8 a level may flip where the float
    value sits at a level's edge: every level within 1 of JAX's and under
    2e-3 of them off, the share image_close allows its outliers."""
    c = video_case
    times = {}
    got = render_video.render_frames(c["model"], c["cfg"], c["batch"], N_FRAMES, times)
    want = c["frames"]
    assert got.dtype == np.uint8 and got.shape == want.shape == (N_FRAMES, 16, 24, 3)
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() < 2e-3, (diff.max(), (diff > 0).mean())
    assert len(times["frame_ms"]) == N_FRAMES and times["encode_ms"] > 0
    assert got.std() > 0 and not np.array_equal(got[0], got[-1])


def test_render_video_cli(tmp_path, monkeypatch):
    """The CLI on the synthetic scene (64x96, 4 source views) for 2 frames on
    the CPU, its model at tiny_config() widths in place of
    pretrain_config()'s (the CLI has no --tiny, as JAX's has none): the
    frames as 0000.png, 0001.png in <out without its suffix>, equal to the
    returned uint8 frames."""
    from ggrt_official_torch import config

    monkeypatch.setattr(render_video, "pretrain_config", config.tiny_config)
    out = tmp_path / "clip" / "video.mp4"
    res = render_video.main(["--synthetic", "--n_frames", "2", "--device", "cpu", "--out", str(out)])
    folder = tmp_path / "clip" / "video"
    assert res["folder"] == folder and sorted(p.name for p in folder.iterdir()) == ["0000.png", "0001.png"]
    for i, frame in enumerate(res["frames"]):
        np.testing.assert_array_equal(np.asarray(Image.open(folder / f"{i:04d}.png")), frame)
    assert res["frames"].shape == (2, 64, 96, 3) and res["frames"].std() > 0
    assert len(res["frame_ms"]) == 2


def cli_arguments(path: Path) -> dict:
    """option -> (default, type, action) of every add_argument call in a
    script's source."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords}
            out[node.args[0].value] = (kw.get("default"), kw.get("type"), kw.get("action"), kw.get("required"))
    return out


@pytest.mark.parametrize("name", ["render_video", "eval_crop", "extract_relative_poses"])
def test_cli_arguments_are_jax(name):
    """Each new CLI has the JAX script's arguments and defaults, and
    --device (default cuda); extract_relative_poses also --seed (default 0)
    for its RANSAC draws, which OpenCV takes from its own generator."""
    got = cli_arguments(ROOT / "ggrt_official_torch" / "scripts" / f"{name}.py")
    want = cli_arguments(ROOT / "scripts" / f"{name}.py")
    assert got.pop("--device") == ("'cuda'", None, None, None)
    if name == "extract_relative_poses":
        assert got.pop("--seed") == ("0", "int", None, None)
    assert got == want
