"""The port's eval_dbarf CLI (scripts/eval_dbarf.py) against the JAX
script's loop on the CPU: the CLI with --synthetic --limit 1 --device cpu
at the script's own widths (pretrain_config(), IBRNetModel with 64 coarse
feature channels, 64 samples, chunks of 2048, render_stride 2, 4 source
views of 64x96), its model given the weights the JAX script initialises
(weights.ibrnet_model_params_from_jax), against the JAX script's loop
rebuilt here from the JAX package's own calls (scripts/eval_dbarf.py:
63-98). Its arguments are the JAX script's, taken with ast.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrt_official_torch import weights
from ggrt_official_torch.scripts import eval_dbarf
from ggrt_official_tpu.config import pretrain_config
from ggrt_official_tpu.data.datasets import SyntheticPlanesDataset, SyntheticSceneSpec, collate_batch
from ggrt_official_tpu.evaluation import metrics
from ggrt_official_tpu.models.dbarf import IBRNetModel
from ggrt_official_tpu.rendering import rays as rays_mod
from ggrt_official_tpu.rendering import volume
from tests.test_torch_video import cli_arguments

ROOT = Path(__file__).resolve().parents[1]
N_SAMPLES, CHUNK, STRIDE = 64, 2048, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX script's model, weights and first view, its render jitted."""
    cfg = pretrain_config()
    ds = SyntheticPlanesDataset(SyntheticSceneSpec(n_views=12, image_size=(64, 96)), mode="test", num_source_views=4)
    model = IBRNetModel(cfg, coarse_feat_dim=64, coarse_only=True, n_samples=N_SAMPLES)
    ex = collate_batch(ds[0])
    v = ex["src_rgbs"].shape[1]
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ex["src_rgbs"][0]),
                        jnp.asarray(np.zeros((4, 2, v, 64 + 3), np.float32)),
                        jnp.asarray(np.zeros((4, 2, v, 4), np.float32)),
                        jnp.asarray(np.ones((4, 2, v, 1), np.float32)))

    camera = jnp.asarray(ex["camera"][0])
    h, w = int(camera[0]), int(camera[1])

    @jax.jit
    def render(p, src_rgbs, camera, depth_range, src_cameras):
        feats = model.apply(p, src_rgbs, method="extract_features")
        ray_o, ray_d = rays_mod.get_rays_single_image(h, w, camera[2:18].reshape(4, 4)[None],
                                                      camera[18:34].reshape(4, 4)[None], render_stride=STRIDE)
        ray_batch = {"ray_o": ray_o, "ray_d": ray_d, "depth_range": depth_range, "camera": camera,
                     "src_rgbs": src_rgbs, "src_cameras": src_cameras}
        rgb, _ = volume.render_image(jax.random.PRNGKey(0), ray_batch,
                                     lambda f, d, m: model.apply(p, f, d, m, method="coarse"),
                                     (feats[0], None), N_SAMPLES, chunk_size=CHUNK, det=True, inv_uniform=True)
        return rgb

    rgb = render(params, jnp.asarray(ex["src_rgbs"][0]), camera, jnp.asarray(ex["depth_range"][0]),
                 jnp.asarray(ex["src_cameras"][0]))
    hs, ws = len(range(0, h, STRIDE)), len(range(0, w, STRIDE))
    pred = rgb.reshape(hs, ws, 3).transpose(2, 0, 1)
    gt = jnp.asarray(ex["rgb"][0])[::STRIDE, ::STRIDE].transpose(2, 0, 1)
    row = {"psnr": float(metrics.psnr(pred, gt)), "ssim": float(metrics.ssim(pred, gt))}
    return dict(params=jax.tree_util.tree_map(np.asarray, params), pred=np.asarray(pred), row=row)


def test_cli_matches_the_jax_loop(jax_run, tmp_path, monkeypatch):
    """The CLI's one view against the JAX loop's: PSNR within 1e-3 dB and
    SSIM within 1e-5 (the renders agree to ~1e-5 per pixel: ResUNet's and
    IBRNet's sums in another order), the render itself rtol 1e-4, atol 1e-4;
    results.json holds {"summary", "per_view"} with the JAX keys."""
    built = {}

    def build_model(cfg, n_samples, device):
        model = torch_model(cfg, n_samples, device)
        model.load_state_dict(weights.ibrnet_model_params_from_jax(jax_run["params"], coarse_only=True))
        built["model"] = model
        return model

    torch_model = eval_dbarf.build_model
    monkeypatch.setattr(eval_dbarf, "build_model", build_model)
    out = tmp_path / "ed"
    res = eval_dbarf.main(["--synthetic", "--limit", "1", "--device", "cpu", "--out", str(out)])
    saved = json.loads((out / "results.json").read_text())
    assert saved == json.loads(json.dumps(res)) and set(saved) == {"summary", "per_view"}
    assert len(saved["per_view"]) == 1 and set(saved["per_view"][0]) == {"psnr", "ssim"}
    got, want = saved["per_view"][0], jax_run["row"]
    assert abs(got["psnr"] - want["psnr"]) < 1e-3, (got, want)
    assert abs(got["ssim"] - want["ssim"]) < 1e-5, (got, want)
    assert saved["summary"] == got

    ds = eval_dbarf.SyntheticPlanesDataset(eval_dbarf.SyntheticSceneSpec(n_views=12, image_size=(64, 96)),
                                           mode="test", num_source_views=4)
    with torch.inference_mode():
        pred, gt = eval_dbarf.render_view(built["model"], eval_dbarf.collate_batch(ds[0]), N_SAMPLES, CHUNK, STRIDE,
                                          "cpu")
    assert pred.shape == gt.shape == (3, 32, 48)
    np.testing.assert_allclose(pred.numpy(), jax_run["pred"], rtol=1e-4, atol=1e-4)


def test_cli_arguments_are_jax():
    """The JAX script's arguments and defaults, and --device (default cuda)."""
    got = cli_arguments(ROOT / "ggrt_official_torch" / "scripts" / "eval_dbarf.py")
    want = cli_arguments(ROOT / "scripts" / "eval_dbarf.py")
    assert got.pop("--device") == ("'cuda'", None, None, None)
    assert got == want
