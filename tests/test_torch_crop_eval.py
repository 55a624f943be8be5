"""The port's crop-tiled evaluation (evaluation/crop_eval.py and
scripts/eval_crop.py) against the JAX package's evaluation/crop_eval.py
on the CPU: the crop grid with its inward-shifted boundary crops, the crop
of a batch with its shifted intrinsics, the stitch with its trims, the
PSNR, and a whole view rendered crop by crop and stitched, on the same
numpy inputs; then the eval_crop CLI at --tiny on a synthetic scene.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ggrt_official_torch.evaluation import crop_eval as tce
from ggrt_official_torch.scripts import eval_crop
from ggrt_official_tpu.evaluation import crop_eval as jce

# (h, w, crop_h, crop_w): divisible, the reference's 378x504 by 160x224
# (boundary crops shifted inward on both axes), and a crop as large as the view.
GRIDS = [(64, 96, 16, 32), (378, 504, 160, 224), (50, 70, 16, 32), (16, 32, 16, 32)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("grid", GRIDS)
def test_crop_centers(grid):
    assert tce.crop_centers(*grid) == jce.crop_centers(*grid)


def views(rng, v, h, w):
    """A (1, v) view set with images and normalized intrinsics."""
    K = np.tile(np.array([[0.9, 0.0, 0.5], [0.0, 1.2, 0.48], [0.0, 0.0, 1.0]], np.float32), (1, v, 1, 1))
    K[..., :2, :] += 0.01 * rng.normal(size=(1, v, 2, 3)).astype(np.float32)
    return {"image": rng.uniform(size=(1, v, 3, h, w)).astype(np.float32), "intrinsics": K,
            "near": np.full((1, v), 1.0, np.float32)}


@pytest.mark.parametrize("grid", GRIDS)
def test_crop_batch(grid):
    """Every crop of the grid: the same pixels (exact) and intrinsics (rtol
    1e-6: the same float32 operations), tensors kept as tensors."""
    h, w, ch, cw = grid
    rng = np.random.RandomState(31)
    batch = {"context": views(rng, 3, h, w), "target": views(rng, 1, h, w), "other": 7}
    tbatch = {**batch, "context": {k: torch.tensor(v) for k, v in batch["context"].items()},
              "target": {k: torch.tensor(v) for k, v in batch["target"].items()}}
    for _, _, cy, cx in jce.crop_centers(h, w, ch, cw):
        got = tce.crop_batch(tbatch, (ch, cw), (cy, cx))
        want = jce.crop_batch(batch, (ch, cw), (cy, cx))
        assert got["other"] == 7
        for part in ("context", "target"):
            assert isinstance(got[part]["image"], torch.Tensor)
            np.testing.assert_array_equal(got[part]["image"].numpy(), want[part]["image"])
            np.testing.assert_allclose(got[part]["intrinsics"].numpy(), want[part]["intrinsics"], rtol=1e-6)
            np.testing.assert_array_equal(got[part]["near"].numpy(), want[part]["near"])
    assert torch.equal(tbatch["target"]["intrinsics"], torch.tensor(batch["target"]["intrinsics"]))


@pytest.mark.parametrize("grid", GRIDS)
def test_stitch_tiles(grid):
    """Random tiles, so the trims show: the same image, exactly."""
    h, w, ch, cw = grid
    rng = np.random.RandomState(32)
    tiles = {(i, j): rng.uniform(size=(ch, cw, 3)).astype(np.float32) for i, j, _, _ in jce.crop_centers(*grid)}
    np.testing.assert_array_equal(tce.stitch_tiles(tiles, h, w, ch, cw), jce.stitch_tiles(tiles, h, w, ch, cw))


def test_psnr_compare():
    rng = np.random.RandomState(33)
    a, b = rng.uniform(-0.2, 1.2, size=(2, 20, 30, 3)).astype(np.float32)
    assert tce.psnr_compare(a, b) == jce.psnr_compare(a, b)
    assert tce.psnr_compare(b, b) == jce.psnr_compare(b, b)


@pytest.mark.parametrize("grid", GRIDS)
def test_eval_crop_view(grid):
    """A whole view crop by crop with a render that depends on the crop's
    pixels and intrinsics (so a wrong crop or shift shows): the stitched
    view exactly (rtol 1e-6) and the same PSNR (rtol 1e-6)."""
    h, w, ch, cw = grid
    rng = np.random.RandomState(34)
    batch = {"context": views(rng, 2, h, w), "target": views(rng, 1, h, w)}
    tbatch = {part: {k: torch.tensor(v) for k, v in batch[part].items()} for part in batch}

    def render(b, lib):
        img = b["target"]["image"][0, 0]
        return img * 0.9 + b["target"]["intrinsics"][0, 0, 0, 2] * 0.1 + b["context"]["image"][0, 1] * 0.05

    got, psnr_t = tce.eval_crop_view(lambda b: render(b, torch), tbatch, ch, cw)
    want, psnr_j = jce.eval_crop_view(lambda b: render(b, np), batch, ch, cw)
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(psnr_t, psnr_j, rtol=1e-6)


def test_crop_that_the_encoder_cannot_take_is_refused():
    from ggrt_official_torch.config import pretrain_config, tiny_config

    eval_crop.check_crop(pretrain_config(), 160, 224)
    eval_crop.check_crop(tiny_config(), 16, 32)
    with pytest.raises(ValueError, match="multiples of 16"):
        eval_crop.check_crop(pretrain_config(), 160, 200)
    with pytest.raises(ValueError, match="multiples of 16"):
        eval_crop.main(["--synthetic", "--crop-h", "150", "--device", "cpu"])


def test_eval_crop_cli(tmp_path):
    """--tiny on the synthetic scene (64x96 test views, 16x32 crops: 12 per
    view), one view on the CPU: results.json with the JAX script's keys,
    the stitched view as stitched_000.npy, its PSNR recomputed from the
    file and the view's GT."""
    from ggrt_official_torch.data.datasets import SyntheticPlanesDataset, SyntheticSceneSpec

    out = tmp_path / "ec"
    summary = eval_crop.main(["--synthetic", "--tiny", "--limit", "1", "--device", "cpu", "--out", str(out)])
    res = json.loads((out / "results.json").read_text())
    assert res == json.loads(json.dumps(summary))
    assert set(res) == {"n_views", "psnr_mean", "crop", "views"} and res["crop"] == [16, 32]
    assert res["n_views"] == 1 and set(res["views"][0]) == {"view", "psnr_stitched"}
    stitched = np.load(out / "stitched_000.npy")
    assert stitched.shape == (64, 96, 3) and np.isfinite(stitched).all() and stitched.std() > 0
    gt = SyntheticPlanesDataset(SyntheticSceneSpec(n_views=12, image_size=(64, 96)), mode="test",
                                num_source_views=4)[0]["rgb"]
    np.testing.assert_allclose(res["psnr_mean"], jce.psnr_compare(stitched, gt), rtol=1e-6)
    assert sorted(p.name for p in Path(out).iterdir()) == ["results.json", "stitched_000.npy"]
