"""The port stands alone: no module of ggrt_official_torch/ and nothing in
chip_smoke.py imports jax, flax, optax or the JAX package, nor OpenCV (the
card's machine has none); the SfM entry points run on the card unless the
caller asks for the CPU."""
import ast
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ggrt_official_tpu"}
FILES = sorted((ROOT / "ggrt_official_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.exists()
    assert not imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_opencv_imports(path):
    """Not even inside a function: the SfM path's SIFT, matching and
    essential matrix are the port's own (sfm/sift.py, sfm/essential.py)."""
    assert "cv2" not in imported_roots(path)


def test_sfm_entry_points_default_to_the_card():
    """run_sfm_pipeline, build_view_graph, extract_features, the
    extract_relative_poses function and its CLI's --device default to
    "cuda"; SIFT's detect_and_compute too."""
    from ggrt_official_torch.scripts import extract_relative_poses as erp
    from ggrt_official_torch.sfm import pipeline, sift, two_view

    for fn in (pipeline.run_sfm_pipeline, two_view.build_view_graph, two_view.extract_features,
               erp.extract_relative_poses, sift.detect_and_compute):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    tree = ast.parse(inspect.getsource(erp.main))
    defaults = {node.args[0].value: kw.value.value for node in ast.walk(tree)
                if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"
                for kw in node.keywords if kw.arg == "default"}
    assert defaults["--device"] == "cuda" and defaults["--seed"] == 0


def test_walk_sees_the_package():
    assert len(FILES) > 20
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for sub in ("evaluation/harness.py", "evaluation/metrics.py", "geometry/alignment.py",
                "training/loop.py", "training/checkpoint.py", "scripts/train_ggrt.py", "scripts/eval_ggrt.py",
                "training/gaussian_cache.py", "training/trainer_cached.py", "scripts/finetune_ggrt.py",
                "scripts/run_flagship.py", "training/pretrained.py", "data/image_io.py", "data/llff.py",
                "data/collections.py", "data/mixing.py", "data/nerf_synthetic.py", "data/scannet.py",
                "data/waymo.py", "data/extra_datasets.py", "data/registry.py", "data/colmap.py",
                "data/verifier.py", "utils/trajectories.py", "scripts/render_video.py",
                "evaluation/crop_eval.py", "scripts/eval_crop.py", "evaluation/lpips.py",
                "geometry/lie_group.py", "evaluation/pose_accuracy.py", "geometry/tracks.py",
                "geometry/pose_init.py", "sfm/disambiguation.py", "sfm/retrieval.py", "sfm/two_view.py",
                "sfm/pipeline.py", "scripts/extract_relative_poses.py", "rendering/rays.py",
                "rendering/projector.py", "rendering/volume.py", "models/ibrnet.py", "models/feature_unet.py",
                "models/dbarf.py", "models/nerf.py", "training/barf_trainer.py", "scripts/eval_dbarf.py",
                "tools/diag_exp_precision.py", "native.py", "utils/benchmarker.py", "utils/step_tracker.py",
                "utils/visualization.py", "utils/encoder_visualizer.py", "visualization/__init__.py",
                "visualization/annotation.py", "visualization/cameras.py", "visualization/color_map.py",
                "visualization/color_tables.py", "visualization/drawing.py", "visualization/feature_visualizer.py",
                "visualization/layout.py", "training/convert.py", "parallel/__init__.py", "parallel/mesh.py",
                "parallel/sharded_step.py", "parallel/tile_parallel.py", "parallel/dryrun.py", "scripts/bench.py",
                "sfm/sift.py", "sfm/essential.py"):
        assert f"ggrt_official_torch/{sub}" in names, sub
    assert "jax" in imported_roots(ROOT / "ggrt_official_tpu" / "ops" / "rasterizer" / "api.py")
    assert "cv2" in imported_roots(ROOT / "ggrt_official_tpu" / "sfm" / "two_view.py")
