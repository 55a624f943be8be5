"""The port's visualization modules (visualization/*, utils/visualization.py)
against the JAX package's on the CPU, on the same seeded numpy inputs:
colour maps and depth colouring bit for bit for the five committed maps,
layout, resize, drawing and cameras within 1e-6, the label strips and the
matplotlib camera plot as decoded arrays. Each test states its tolerance.
"""
import sys

import jax.numpy as jnp
import matplotlib
import matplotlib.pyplot
import numpy as np
import pytest
import torch
from PIL import Image

from ggrt_official_torch.utils import visualization as tuv
from ggrt_official_torch.visualization import annotation as tann
from ggrt_official_torch.visualization import cameras as tcam
from ggrt_official_torch.visualization import color_map as tcm
from ggrt_official_torch.visualization import drawing as tdraw
from ggrt_official_torch.visualization import feature_visualizer as tfv
from ggrt_official_torch.visualization import layout as tlay
from ggrt_official_torch.visualization.color_tables import TABLES
from ggrt_official_tpu.utils import visualization as juv
from ggrt_official_tpu.visualization import annotation as jann
from ggrt_official_tpu.visualization import cameras as jcam
from ggrt_official_tpu.visualization import color_map as jcm
from ggrt_official_tpu.visualization import drawing as jdraw
from ggrt_official_tpu.visualization import feature_visualizer as jfv
from ggrt_official_tpu.visualization import layout as jlay

MAPS = ("jet", "viridis", "magma", "turbo", "inferno")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.tensor(np.asarray(x))


def close(actual, expected, atol=1e-6):
    actual = actual.numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape
    np.testing.assert_allclose(actual, expected, rtol=0, atol=atol)


def cams(b=3, seed=0):
    rng = np.random.RandomState(seed)
    ext = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    ext[:, :3, 3] = rng.randn(b, 3) * 0.5
    K = np.tile(np.array([[0.9, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]], np.float32), (b, 1, 1))
    return ext, K, rng.rand(b, 3).astype(np.float32)


# --- colour maps ----------------------------------------------------------------

@pytest.mark.parametrize("cmap", MAPS)
def test_committed_tables_are_matplotlibs(cmap):
    """Each committed table is the map's 256 entries as matplotlib gives
    them (its lookup table in float64), bit for bit."""
    want = matplotlib.colormaps[cmap](np.linspace(0.0, 1.0, 256))[:, :3]
    np.testing.assert_array_equal(np.asarray(TABLES[cmap], np.float64), want)


@pytest.mark.parametrize("cmap", MAPS)
def test_apply_color_map_bit_equal(cmap):
    """On values in and outside [0, 1] and at every entry's edge, the
    colours of JAX's map, bit for bit, as (..., 3) and as (3, h, w)."""
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.uniform(-0.2, 1.2, 500), np.arange(256) / 255.0, np.arange(256) / 256.0])
    x = x.astype(np.float32).reshape(2, -1)
    np.testing.assert_array_equal(tcm.apply_color_map(t(x), cmap).numpy(), np.asarray(jcm.apply_color_map(x, cmap)))
    img = rng.uniform(size=(2, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(tcm.apply_color_map_to_image(t(img), cmap).numpy(),
                                  np.asarray(jcm.apply_color_map_to_image(img, cmap)))


@pytest.mark.parametrize("cmap", MAPS)
def test_colorize_depth_bit_equal(cmap):
    """colorize_depth takes matplotlib's indexing (x·256, 256 -> 255,
    truncated), not apply_color_map's: bit for bit on a depth map with
    non-finite pixels, with a given mask, and on a constant map."""
    rng = np.random.RandomState(2)
    d = rng.uniform(1.0, 9.0, (17, 23)).astype(np.float32)
    d[0, :3] = [np.nan, np.inf, -np.inf]
    d[5, 5], d[6, 6] = d[np.isfinite(d)].min(), d[np.isfinite(d)].max()
    mask = np.isfinite(d) & (d < 8.0)
    for args in ((d,), (d, cmap, mask), (np.full((4, 5), 3.0, np.float32),)):
        args = args if len(args) > 1 else (*args, cmap)
        np.testing.assert_array_equal(tuv.colorize_depth(*args), juv.colorize_depth(*args))


def test_other_maps_go_to_matplotlib(monkeypatch):
    """A map outside the tables comes from matplotlib, bit-equal to JAX's;
    without matplotlib it is an error that names the committed maps."""
    x = np.linspace(0, 1, 300, dtype=np.float32)
    np.testing.assert_array_equal(tcm.apply_color_map(t(x), "plasma").numpy(),
                                  np.asarray(jcm.apply_color_map(x, "plasma")))
    tcm.host_table.cache_clear()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    try:
        with pytest.raises(ValueError, match="inferno"):
            tcm.host_table("cividis")
        tcm.apply_color_map(t(x), "jet")  # the committed maps need no matplotlib
    finally:
        tcm.host_table.cache_clear()


# --- layout and resize -----------------------------------------------------------

@pytest.mark.parametrize("align", ["start", "center", "end", "top", "left"])
def test_layout(align):
    """hcat/vcat with each alignment, gap and gap colour; add_border:
    within 1e-6 (plain copies and pads)."""
    rng = np.random.RandomState(3)
    a, b, c = (rng.rand(3, h, w).astype(np.float32) for h, w in ((5, 7), (9, 4), (6, 6)))
    for fn_t, fn_j in ((tlay.hcat, jlay.hcat), (tlay.vcat, jlay.vcat)):
        close(fn_t(t(a), t(b), t(c), align=align), fn_j(a, b, c, align=align))
        close(fn_t(t(a), t(b), align=align, gap=0, gap_color=0.3), fn_j(a, b, align=align, gap=0, gap_color=0.3))
    close(tlay.add_border(t(a), 3, 0.5), jlay.add_border(a, 3, 0.5))


@pytest.mark.parametrize("method", ["bilinear", "nearest", "cubic", "lanczos3", "lanczos5"])
def test_resize(method):
    """layout.resize by shape, width and height, shrinking and growing:
    jax.image.resize's kernels with its antialiasing, within 1e-6."""
    img = np.random.RandomState(4).rand(3, 13, 17).astype(np.float32)
    for kw in ({"shape": (26, 40)}, {"shape": (5, 7)}, {"width": 9}, {"height": 40}):
        close(tlay.resize(t(img), method=method, **kw), jlay.resize(jnp.asarray(img), method=method, **kw))


# --- drawing ---------------------------------------------------------------------

@pytest.mark.parametrize("cap", ["round", "butt", "square"])
def test_draw_lines(cap):
    """Five segments of random widths and colours over a random image, in
    pixels and in a world range: within 1e-6. The distance sums are taken
    as XLA's fused reductions take them (drawing._dot2)."""
    rng = np.random.RandomState(5)
    img = rng.rand(3, 24, 32).astype(np.float32)
    s, e = (rng.uniform(0, 32, (5, 2)).astype(np.float32) for _ in range(2))
    col, wd = rng.rand(5, 3).astype(np.float32), rng.uniform(1, 3, 5).astype(np.float32)
    close(tdraw.draw_lines(t(img), s, e, col, wd, cap=cap), jdraw.draw_lines(img, s, e, col, wd, cap=cap))
    kw = dict(x_range=(-1.0, 3.0), y_range=(0.0, 2.0))
    close(tdraw.draw_lines(t(img), s / 8, e / 10, 0.7, 2.0, cap=cap, **kw),
          jdraw.draw_lines(img, s / 8, e / 10, 0.7, 2.0, cap=cap, **kw))


def test_draw_points():
    """Discs and rings (inner radius), one colour or one each: within 1e-6."""
    rng = np.random.RandomState(6)
    img = rng.rand(3, 20, 28).astype(np.float32)
    p, r = rng.uniform(0, 28, (6, 2)).astype(np.float32), rng.uniform(1, 4, 6).astype(np.float32)
    col = rng.rand(6, 3).astype(np.float32)
    close(tdraw.draw_points(t(img), p, col, radius=r, inner_radius=0.5),
          jdraw.draw_points(img, p, col, radius=r, inner_radius=0.5))
    close(tdraw.draw_points(t(img), p, (0.2, 0.4, 0.9), radius=2.0),
          jdraw.draw_points(img, p, (0.2, 0.4, 0.9), radius=2.0))


# --- annotation, features, cameras -----------------------------------------------

def test_annotation():
    """The PIL strip and the labelled image: bit for bit."""
    img = np.random.RandomState(7).rand(3, 20, 90).astype(np.float32)
    close(tann.draw_text("plane xy", 90), jann.draw_text("plane xy", 90), atol=0)
    close(tann.add_label(t(img), "label 1"), jann.add_label(img, "label 1"), atol=0)


@pytest.mark.parametrize("seed", range(3))
def test_visualize_features(seed):
    """PCA-RGB within 1e-5 of JAX's, each channel as is or mirrored (1 - x):
    an eigenvector's sign is the solver's own choice (LAPACK's in JAX on the
    CPU, another in torch), and a flipped component maps to 1 - x through
    the percentile normalisation; the two eigensolvers differ in the last
    bits of the (8, 8) covariance's vectors."""
    rng = np.random.RandomState(seed)
    f = (rng.randn(8, 12, 16) * rng.uniform(0.5, 3, (8, 1, 1))).astype(np.float32)
    got, want = tfv.visualize_features(t(f)).numpy(), np.asarray(jfv.visualize_features(jnp.asarray(f)))
    assert got.shape == want.shape == (3, 12, 16)
    for c in range(3):
        assert min(np.abs(got[c] - want[c]).max(), np.abs(got[c] - (1 - want[c])).max()) <= 1e-5, c


def test_visualize_attention():
    """Heat overlay, the map resized up and down to the image: within 1e-6."""
    rng = np.random.RandomState(8)
    img = rng.rand(3, 24, 32).astype(np.float32)
    for shape, cmap in (((6, 8), "inferno"), ((30, 40), "jet")):
        a = rng.rand(*shape).astype(np.float32)
        close(tfv.visualize_attention(t(a), t(img), cmap=cmap),
              jfv.visualize_attention(jnp.asarray(a), jnp.asarray(img), cmap=cmap))


def test_cameras():
    """Frustum corners, draw_cameras with near/far planes (labelled),
    render_projections with and without cameras, side_by_side: within 1e-6."""
    ext, K, col = cams()
    close(tcam.unproject_frustum_corners(t(ext), t(K), t(np.array([0.5, 1.0, 2.0], np.float32))),
          jcam.unproject_frustum_corners(jnp.asarray(ext), jnp.asarray(K), jnp.asarray([0.5, 1.0, 2.0])))
    close(tcam.draw_cameras(48, t(ext), t(K), col, near=0.5, far=2.0), jcam.draw_cameras(48, ext, K, col, 0.5, 2.0))
    pts = np.random.RandomState(9).randn(40, 3).astype(np.float32)
    views = tcam.render_projections(t(pts), 40, ext, K)
    close(views, jcam.render_projections(pts, 40, ext, K))
    close(tcam.render_projections(t(pts), 32, radius=2.0), jcam.render_projections(pts, 32, radius=2.0))
    close(tcam.side_by_side(views), jcam.side_by_side(jnp.asarray(views.numpy())))


# --- utils/visualization.py (host numpy) -----------------------------------------

def test_host_helpers():
    """Frustum lines, side_by_side, the HWC layout helpers and the stamped
    points and lines: equal to JAX's (the same numpy code)."""
    ext, K, _ = cams(1)
    np.testing.assert_array_equal(tuv.camera_frustum_lines(ext[0], K[0], 0.2),
                                  juv.camera_frustum_lines(ext[0], K[0], 0.2))
    rng = np.random.RandomState(10)
    a, b = rng.rand(3, 8, 10).astype(np.float32), rng.rand(12, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(tuv.side_by_side(a, a), juv.side_by_side(a, a))
    for name in ("hcat", "vcat"):
        np.testing.assert_array_equal(getattr(tuv, name)(a, b), getattr(juv, name)(a, b))
    np.testing.assert_array_equal(tuv.add_border(a, width=3), juv.add_border(a, width=3))
    xy = rng.rand(7, 2)
    np.testing.assert_array_equal(tuv.draw_points(b, xy, radius=1), juv.draw_points(b, xy, radius=1))
    np.testing.assert_array_equal(tuv.draw_lines(b, xy[:3], xy[3:6]), juv.draw_lines(b, xy[:3], xy[3:6]))


def test_plot_cameras(tmp_path):
    """The matplotlib camera plot of predicted and GT poses: the PNGs
    decode to the same array, and the figure's canvas to the same pixels."""
    ext, _, _ = cams(4, seed=11)
    gt = ext.copy()
    gt[:, 0, 3] += 0.1
    figs = []
    for name, mod in (("port", tuv), ("jax", juv)):
        figs.append(mod.plot_cameras(ext, out_path=str(tmp_path / f"{name}.png"), gt_c2ws=gt))
    a, b = (np.asarray(Image.open(tmp_path / f"{n}.png")) for n in ("port", "jax"))
    assert a.shape == b.shape and a.ndim == 3
    np.testing.assert_array_equal(a, b)
    canvases = []
    for mod in (tcam, jcam):
        fig = mod.plot_cameras_matplotlib(ext)
        fig.canvas.draw()
        canvases.append(np.asarray(fig.canvas.buffer_rgba()).copy())
        matplotlib.pyplot.close(fig)
    np.testing.assert_array_equal(*canvases)
