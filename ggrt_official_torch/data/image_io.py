"""Image reading, blurring and resizing for the readers (host-side numpy).

The JAX package's readers call imageio and OpenCV; neither is installed on
every machine the port runs on. These functions give the same arrays with
PIL and numpy alone:

  * `read_image`: imageio.v2.imread of a PNG or JPEG (PIL decodes both for
    imageio too); palette images are expanded to RGB(A) as imageio does.
  * `read_gray`: cv2.imread(path, IMREAD_GRAYSCALE) of an 8-bit PNG or a
    JPEG: libjpeg's own grey decode, libpng's fixed-point luma.
  * `gaussian_blur`: cv2.GaussianBlur with OpenCV's kernel from sigma (or
    its fixed small tables) and the reflect-101 border.
  * `resize(..., "linear")`: cv2.resize INTER_LINEAR on a float image:
    half-pixel centres, edge clamp, float32 weights.
  * `resize(..., "area")`: cv2.resize INTER_AREA: exact area weights when
    both axes shrink, else OpenCV's area-flavoured bilinear weights.
"""
from __future__ import annotations

import math

import numpy as np
from PIL import Image

# OpenCV's fixed kernels for odd ksize <= 9 when sigma <= 0.
_SMALL_GAUSSIAN_TAB = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    9: [4 / 256, 13 / 256, 30 / 256, 51 / 256, 60 / 256, 51 / 256, 30 / 256, 13 / 256, 4 / 256],
}


def read_image(path: str) -> np.ndarray:
    """The decoded image as a uint8 array: (h, w) grey, (h, w, 3) or (h, w, 4)."""
    with Image.open(path) as im:
        if im.mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        return np.asarray(im)


def read_gray(path: str) -> np.ndarray:
    """The image as (h, w) uint8 grey levels, as OpenCV's IMREAD_GRAYSCALE
    gives them: a JPEG is decoded to grey by libjpeg (its Y channel); a
    colour PNG is reduced with libpng's rgb_to_gray weights 0.299 and
    0.587 in 15-bit fixed point, truncated; alpha is dropped."""
    with Image.open(path) as im:
        if im.format == "JPEG":
            im.draft("L", im.size)
        if im.mode == "L":
            return np.asarray(im)
        rgb = np.asarray(im.convert("RGB")).astype(np.uint32)
    gray = (9797 * rgb[..., 0] + 19234 * rgb[..., 1] + 3737 * rgb[..., 2]) >> 15
    return gray.astype(np.uint8)


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel for a float image: a fixed table for small
    ksize when sigma <= 0, else exp(-x²/2σ²) normalized in float64 and
    stored as float32 (sigma <= 0 derives σ from ksize)."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN_TAB:
        return np.asarray(_SMALL_GAUSSIAN_TAB[ksize], np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(image: np.ndarray, ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.GaussianBlur(image, (ksize, ksize), sigma) for a float32 image
    (h, w) or (h, w, c), reflect-101 border; ksize 0 derives it from sigma
    as OpenCV does for float images."""
    if ksize == 0:
        ksize = int(np.rint(sigma * 8 + 1)) | 1
    k = _gaussian_kernel(ksize, sigma).astype(np.float64)
    r = ksize // 2
    h, w = image.shape[:2]
    pad = ((r, r), (r, r)) + ((0, 0),) * (image.ndim - 2)
    padded = np.pad(image.astype(np.float64), pad, mode="reflect")  # reflect-101
    rows = sum(k[i] * padded[:, i:i + w] for i in range(ksize))
    return sum(k[i] * rows[i:i + h] for i in range(ksize)).astype(np.float32)


def _linear_taps(src: int, dst: int, area_mode: bool):
    """OpenCV's two-tap weights along one axis: (index0, index1, w0, w1).
    area_mode gives INTER_AREA's weights for an axis it cannot average."""
    inv_scale = dst / src
    scale = 1.0 / inv_scale
    d = np.arange(dst, dtype=np.float64)
    if area_mode:
        sx = np.floor(d * scale).astype(np.int64)
        fx = ((d + 1) - (sx + 1) * inv_scale).astype(np.float32)
        fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx)).astype(np.float32)
    else:
        f = (d + 0.5) * scale - 0.5
        sx = np.floor(f).astype(np.int64)
        fx = (f - sx).astype(np.float32)
    low = sx < 0
    fx[low], sx[low] = 0, 0
    high = sx >= src - 1
    fx[high], sx[high] = 0, src - 1
    return sx, np.minimum(sx + 1, src - 1), (np.float32(1) - fx).astype(np.float32), fx


def _area_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) INTER_AREA weights of a shrinking axis
    (OpenCV's computeResizeAreaTab), float32 values."""
    scale = src / dst
    m = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            m[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            m[dx, sx] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            m[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return m


def resize(image: np.ndarray, out_hw: tuple[int, int], interpolation: str = "linear") -> np.ndarray:
    """cv2.resize(image, (w, h), interpolation=INTER_LINEAR or INTER_AREA)
    for a float32 image (h, w) or (h, w, c)."""
    if interpolation not in ("linear", "area"):
        raise ValueError(f"unknown interpolation: {interpolation}")
    h, w = image.shape[:2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    image = image.astype(np.float32, copy=False)
    if (oh, ow) == (h, w):
        return image.copy()
    area = interpolation == "area"
    if area and h >= oh and w >= ow:
        wy, wx = _area_matrix(h, oh), _area_matrix(w, ow)
        out = np.einsum("yh,hw...->yw...", wy, image.astype(np.float64))
        return np.einsum("xw,yw...->yx...", wx, out).astype(np.float32)
    y0, y1, b0, b1 = _linear_taps(h, oh, area)
    x0, x1, a0, a1 = _linear_taps(w, ow, area)
    tail = (1,) * (image.ndim - 2)
    a0, a1 = a0.reshape(1, -1, *tail), a1.reshape(1, -1, *tail)
    rows = image[:, x0] * a0 + image[:, x1] * a1
    b0, b1 = b0.reshape(-1, 1, *tail), b1.reshape(-1, 1, *tail)
    return (rows[y0] * b0 + rows[y1] * b1).astype(np.float32)
