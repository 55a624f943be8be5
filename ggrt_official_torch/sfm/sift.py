"""SIFT keypoints and descriptors in PyTorch, on the card or the CPU.

What OpenCV's `cv2.SIFT_create(nfeatures).detectAndCompute(gray, None)`
returns, with OpenCV's algorithm and defaults (its sift.dispatch.cpp and
sift.simd.hpp):

  * the base image: the grey levels (0-255, float32) upsampled 2x with
    INTER_LINEAR, blurred to σ = sqrt(1.6² - (2·0.5)²);
  * 3 layers per octave, 6 Gaussian images per octave, each blurred from
    the one before; an octave's base is the previous octave's layer 3 at
    every second pixel (INTER_NEAREST); DoG = differences of neighbours;
  * extrema of the DoG over their 26 neighbours (ties count), |D| above
    floor(0.5·0.04/3·255), 5 pixels from the border;
  * at most 5 steps of sub-pixel refinement (Cramer's rule on the 3x3
    Hessian), the contrast threshold 0.04/3 and the edge threshold 10;
  * a 36-bin orientation histogram (Gaussian window σ = 1.5·scale, radius
    4.5·scale, OpenCV's polynomial atan2), smoothed (1 4 6 4 1)/16, a
    keypoint at every peak >= 0.8 of the highest, its bin interpolated
    by a parabola; OpenCV's angle is 360 - θ, in degrees;
  * keypoints sorted by (x, y, size descending, angle, ...), duplicates
    removed, `retainBest(nfeatures)` when nfeatures > 0 (every keypoint
    whose response reaches the nfeatures-th is kept), then scaled from
    the doubled image to the input's pixels;
  * a 4x4x8 descriptor: gradients in a window of radius
    3·scale·sqrt(2)·5/2 rotated to the keypoint's angle, weighted by a
    Gaussian of half the window, spread trilinearly over (row, column,
    orientation) bins, clamped at 0.2 of its norm, renormalised, scaled
    by 512 and rounded to [0, 255].

On the card everything stays there: the blurs are separable `conv2d`s
(TF32 off) with `data/image_io.py`'s kernels and the reflect-101 border,
the extrema a 3x3x3 max/min pool (separable), and the refinement, orientation and
descriptors are batched over all candidates of the image, the histograms
summed by `scatter_add_`. The candidates are gathered into a fixed number
of slots (one per 512 DoG positions of the first octave) without reading
their count, so an image makes one host read: the keypoint count, the
candidate count and the largest descriptor radius, in one copy. Where the
candidates outnumber the slots the image is run again with enough of
them; the result does not depend on the number of slots.

Keypoints come in the sorted order above: OpenCV's `retainBest` reorders
them (`nth_element`), so compare the two as sets.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import device_constant
from ..data.image_io import _gaussian_kernel, _linear_taps
from ..utils.tracing import span

N_LAYERS = 3
SIGMA = 1.6
INIT_SIGMA = 0.5
CONTRAST_THRESHOLD = 0.04
EDGE_THRESHOLD = 10.0
IMG_BORDER = 5
MAX_INTERP_STEPS = 5
ORI_HIST_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_RADIUS = 4.5
ORI_PEAK_RATIO = 0.8
DESCR_WIDTH = 4
DESCR_HIST_BINS = 8
DESCR_SCL_FCTR = 3.0
DESCR_MAG_THR = 0.2
INT_DESCR_FCTR = 512.0
FLT_EPSILON = float(np.finfo(np.float32).eps)
# The largest orientation radius: round(4.5 · 1.6 · 2^(3.5/3)), layer + xi < 3.5.
ORI_RMAX = 17
# Descriptor window samples held at once (keypoints go in chunks of this).
DESCR_CHUNK_SAMPLES = 1 << 23

_f32 = np.float32
# OpenCV's fastAtan2 polynomial (core/src/mathfuncs_core.simd.hpp), in degrees.
_ATAN_P = [float(_f32(c) * _f32(180 / math.pi))
           for c in (0.9997878412794807, -0.3258083974640975, 0.1555786518463281, -0.04432655554792128)]
_ATAN_EPS = float(_f32(np.finfo(np.float64).eps))


class Keypoints(NamedTuple):
    """OpenCV's KeyPoint fields, one row per keypoint (tensors on one device)."""
    pt: torch.Tensor        # (n, 2) float32 (x, y) in the input's pixels
    size: torch.Tensor      # (n,) float32 diameter
    angle: torch.Tensor     # (n,) float32 degrees, 360 - θ in image coordinates
    response: torch.Tensor  # (n,) float32 |contrast|
    octave: torch.Tensor    # (n,) int32: octave | layer << 8 | round((xi + 0.5)·255) << 16


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cv::fastAtan2 in degrees, [0, 360), float32."""
    ax, ay = x.abs(), y.abs()
    c = torch.minimum(ax, ay) / (torch.maximum(ax, ay) + _ATAN_EPS)
    c2 = c * c
    a = (((_ATAN_P[3] * c2 + _ATAN_P[2]) * c2 + _ATAN_P[1]) * c2 + _ATAN_P[0]) * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def _reflect101(n: int, r: int) -> np.ndarray:
    """Indices of [-r, n + r) folded into [0, n) as OpenCV's BORDER_REFLECT_101."""
    p = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(p)
    while ((p < 0) | (p >= n)).any():
        p = np.where(p < 0, -p, p)
        p = np.where(p >= n, 2 * n - 2 - p, p)
    return p


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(img, (0, 0), sigma) of a float32 (h, w) image:
    ksize round(8σ + 1) | 1, the reflect-101 border, separable conv2d."""
    ksize = int(np.rint(sigma * 8 + 1)) | 1
    dev = img.device
    k = device_constant(tuple(_gaussian_kernel(ksize, sigma).tolist()), torch.float32, dev)
    r = ksize // 2
    h, w = img.shape
    cols = device_constant(tuple(_reflect101(w, r).tolist()), torch.long, dev)
    rows = device_constant(tuple(_reflect101(h, r).tolist()), torch.long, dev)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True, allow_tf32=False):
        x = F.conv2d(img.index_select(1, cols)[None, None], k.view(1, 1, 1, -1))[0, 0]
        return F.conv2d(x.index_select(0, rows)[None, None], k.view(1, 1, -1, 1))[0, 0]


def _taps(n: int, dev: torch.device):
    """_linear_taps(n, 2n) as device tensors: (index0, index1, w0, w1)."""
    i0, i1, w0, w1 = _linear_taps(n, 2 * n, False)
    return (device_constant(tuple(i0.tolist()), torch.long, dev), device_constant(tuple(i1.tolist()), torch.long, dev),
            device_constant(tuple(w0.tolist()), torch.float32, dev), device_constant(tuple(w1.tolist()), torch.float32, dev))


def upsample2(img: torch.Tensor) -> torch.Tensor:
    """cv2.resize(img, (2w, 2h), interpolation=INTER_LINEAR) of a float32
    (h, w) image: the horizontal taps, then the vertical."""
    h, w = img.shape
    y0, y1, b0, b1 = _taps(h, img.device)
    x0, x1, a0, a1 = _taps(w, img.device)
    rows = img[:, x0] * a0 + img[:, x1] * a1
    return rows[y0] * b0[:, None] + rows[y1] * b1[:, None]


def layer_sigmas() -> list[float]:
    """The blur from each Gaussian image of an octave to the next (index 0:
    the octave's own σ)."""
    k = 2.0 ** (1.0 / N_LAYERS)
    sig = [SIGMA]
    for i in range(1, N_LAYERS + 3):
        prev = k ** (i - 1) * SIGMA
        sig.append(math.sqrt((prev * k) ** 2 - prev ** 2))
    return sig


def gaussian_pyramid(gray: torch.Tensor) -> list[list[torch.Tensor]]:
    """The Gaussian images of every octave that can hold a keypoint (both
    sides > 2·IMG_BORDER), from a float32 (h, w) image of grey levels."""
    f = _f32
    sig_diff = float(np.sqrt(np.maximum(f(SIGMA) * f(SIGMA) - f(INIT_SIGMA) * f(INIT_SIGMA) * f(4), f(0.01))))
    base = gaussian_blur(upsample2(gray), sig_diff)
    n_octaves = int(np.rint(math.log(min(base.shape)) / math.log(2.0) - 2)) + 1
    sig = layer_sigmas()
    pyr = []
    for o in range(n_octaves):
        img = base if o == 0 else pyr[-1][N_LAYERS][::2, ::2]
        img = img[: (img.shape[0] if o == 0 else pyr[-1][N_LAYERS].shape[0] // 2),
                  : (img.shape[1] if o == 0 else pyr[-1][N_LAYERS].shape[1] // 2)].contiguous()
        if min(img.shape) <= 2 * IMG_BORDER:
            break
        octave = [img]
        for i in range(1, N_LAYERS + 3):
            octave.append(gaussian_blur(octave[-1], sig[i]))
        pyr.append(octave)
    return pyr


def _pool3(x: torch.Tensor, op) -> torch.Tensor:
    """op (torch.maximum or torch.minimum) over each 3x3x3 neighbourhood of
    a (d, h, w) stack, as separable passes: (d - 2, h - 2, w - 2)."""
    x = op(op(x[..., :-2], x[..., 1:-1]), x[..., 2:])
    x = op(op(x[:, :-2], x[:, 1:-1]), x[:, 2:])
    return op(op(x[:-2], x[1:-1]), x[2:])


def _extrema(dog: torch.Tensor) -> torch.Tensor:
    """(N_LAYERS, h, w) bool: DoG layers 1..N_LAYERS of one octave, the
    points at least as large (positive) or as small (negative) as their 26
    neighbours, above the threshold and inside the border."""
    thr = math.floor(0.5 * CONTRAST_THRESHOLD / N_LAYERS * 255)
    mx, mn = _pool3(dog, torch.maximum), _pool3(dog, torch.minimum)
    v = dog[1:-1, 1:-1, 1:-1]
    ext = (v.abs() > thr) & (((v > 0) & (v >= mx)) | ((v < 0) & (v <= mn)))
    out = torch.zeros(dog.shape[0] - 2, *dog.shape[1:], dtype=torch.bool, device=dog.device)
    h, w = dog.shape[1:]
    b = IMG_BORDER
    out[:, b:h - b, b:w - b] = ext[:, b - 1:h - b - 1, b - 1:w - b - 1]
    return out


def _compact(mask: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The indices of `mask`'s true entries in order, in `cap` slots (-1
    past the last), without reading their count."""
    pos = torch.cumsum(mask, 0) - 1
    dest = torch.where(mask & (pos < cap), pos, cap)
    out = torch.full((cap + 1,), -1, dtype=torch.long, device=mask.device)
    out.scatter_(0, dest, torch.arange(mask.numel(), device=mask.device))
    return out[:cap]


def _cramer(H, b):
    """Matx33f::solve(b, DECOMP_LU) for 3x3: Cramer's rule in float32; 0
    where the determinant is 0. H is ((a00, a01, a02), (a10, ...), ...)."""
    (a00, a01, a02), (a10, a11, a12), (a20, a21, a22) = H
    b0, b1, b2 = b
    d = a00 * (a11 * a22 - a21 * a12) - a01 * (a10 * a22 - a20 * a12) + a02 * (a10 * a21 - a20 * a11)
    ok = d != 0
    inv = torch.where(ok, 1.0 / torch.where(ok, d, 1.0), 0.0)
    x0 = inv * (b0 * (a11 * a22 - a12 * a21) - a01 * (b1 * a22 - a12 * b2) + a02 * (b1 * a21 - a11 * b2))
    x1 = inv * (a00 * (b1 * a22 - a12 * b2) - b0 * (a10 * a22 - a12 * a20) + a02 * (a10 * b2 - b1 * a20))
    x2 = inv * (a00 * (a11 * b2 - b1 * a21) - a01 * (a10 * b2 - b1 * a20) + b0 * (a10 * a21 - a11 * a20))
    return x0, x1, x2


class _Flat:
    """Images of several octaves in one flat buffer: `at(octave, plane, r, c)`
    gathers from plane `plane` of each octave's stack."""

    def __init__(self, stacks: list[torch.Tensor]):
        dev = stacks[0].device
        self.buf = torch.cat([s.reshape(-1) for s in stacks])
        sizes = [s.numel() for s in stacks]
        self.off = device_constant((0, *np.cumsum(sizes)[:-1].tolist()), torch.long, dev)
        self.h = device_constant(tuple(s.shape[1] for s in stacks), torch.long, dev)
        self.w = device_constant(tuple(s.shape[2] for s in stacks), torch.long, dev)

    def at(self, o, plane, r, c):
        return self.buf[self.off[o] + (plane * self.h[o] + r) * self.w[o] + c]

    def neighbourhood(self, o, plane, r, c):
        """(K, 3, 3, 3): the values at (plane + dl, r + dr, c + dc), each of
        dl, dr, dc in (-1, 0, 1), in one gather."""
        h, w = self.h[o].view(-1, 1, 1, 1), self.w[o].view(-1, 1, 1, 1)
        d = torch.arange(-1, 2, device=o.device)
        offs = d.view(1, 3, 1, 1) * h * w + d.view(1, 1, 3, 1) * w + d.view(1, 1, 1, 3)    # (K, 3, 3, 3)
        base = self.off[o] + (plane * self.h[o] + r) * self.w[o] + c
        return self.buf[base.view(-1, 1, 1, 1) + offs]


def _refine(dogs: _Flat, o, layer, r, c, alive):
    """adjustLocalExtrema for every candidate at once. Returns the keypoint
    fields in the doubled image (x, y, size, response, octave code), the
    final (layer, r, c) and the survivors."""
    img_scale = 1.0 / 255
    deriv, second, cross = img_scale * 0.5, img_scale, img_scale * 0.25
    h, w = dogs.h[o], dogs.w[o]
    done = torch.zeros_like(alive)
    zero = torch.zeros(alive.shape, dtype=torch.float32, device=alive.device)
    xi = xr = xc = zero
    dD = (zero, zero, zero)
    v = dxx = dyy = dxy = zero
    for _ in range(MAX_INTERP_STEPS):
        nb = dogs.neighbourhood(o, layer, r, c)

        def at(dl, dr, dc):
            return nb[:, dl + 1, dr + 1, dc + 1]
        v_ = at(0, 0, 0)
        g = (
            ((at(0, 0, 1) - at(0, 0, -1)) * deriv),
            ((at(0, 1, 0) - at(0, -1, 0)) * deriv),
            ((at(1, 0, 0) - at(-1, 0, 0)) * deriv),
        )
        v2 = v_ * 2
        dxx_ = (at(0, 0, 1) + at(0, 0, -1) - v2) * second
        dyy_ = (at(0, 1, 0) + at(0, -1, 0) - v2) * second
        dss = (at(1, 0, 0) + at(-1, 0, 0) - v2) * second
        dxy_ = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1)) * cross
        dxs = (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1)) * cross
        dys = (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0)) * cross
        X = _cramer(((dxx_, dxy_, dxs), (dxy_, dyy_, dys), (dxs, dys, dss)), g)
        xi_, xr_, xc_ = -X[2], -X[1], -X[0]
        live = alive & ~done
        conv = live & (xi_.abs() < 0.5) & (xr_.abs() < 0.5) & (xc_.abs() < 0.5)
        xi, xr, xc = (torch.where(conv, a, b) for a, b in ((xi_, xi), (xr_, xr), (xc_, xc)))
        dD = tuple(torch.where(conv, a, b) for a, b in zip(g, dD))
        v, dxx, dyy, dxy = (torch.where(conv, a, b) for a, b in ((v_, v), (dxx_, dxx), (dyy_, dyy), (dxy_, dxy)))
        done = done | conv
        move = live & ~conv
        huge = (xi_.abs() > (2**31 - 1) // 3) | (xr_.abs() > (2**31 - 1) // 3) | (xc_.abs() > (2**31 - 1) // 3)
        alive = alive & ~(move & huge)
        move = move & ~huge
        c_n = c + torch.where(move, torch.round(xc_), 0).long()
        r_n = r + torch.where(move, torch.round(xr_), 0).long()
        l_n = layer + torch.where(move, torch.round(xi_), 0).long()
        out = (l_n < 1) | (l_n > N_LAYERS) | (c_n < IMG_BORDER) | (c_n >= w - IMG_BORDER) | \
            (r_n < IMG_BORDER) | (r_n >= h - IMG_BORDER)
        alive = alive & ~(move & out)
        keep = move & ~out
        c, r, layer = (torch.where(keep, a, b) for a, b in ((c_n, c), (r_n, r), (l_n, layer)))
    alive = alive & done
    t = dD[0] * xc + dD[1] * xr + dD[2] * xi
    contr = v * img_scale + t * 0.5
    alive = alive & ~(contr.abs() * N_LAYERS < CONTRAST_THRESHOLD)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    alive = alive & (det > 0) & ~(tr * tr * EDGE_THRESHOLD >= (EDGE_THRESHOLD + 1) ** 2 * det)
    scale = torch.pow(2.0, o.float())
    x = (c.float() + xc) * scale
    y = (r.float() + xr) * scale
    size = SIGMA * torch.pow(2.0, (layer.float() + xi) / N_LAYERS) * scale * 2
    code = o + (layer << 8) + (torch.round((xi.double() + 0.5) * 255).long() << 16)
    return (x, y, size, contr.abs(), code), (layer, r, c), alive


def _orientations(gauss: _Flat, o, layer, r, c, size, alive):
    """calcOrientationHist and its peaks: (K, 36) angles and a (K, 36) mask
    of the bins that make a keypoint."""
    n = ORI_HIST_BINS
    dev = o.device
    scl = size * 0.5 / torch.pow(2.0, o.float())
    radius = torch.round(ORI_RADIUS * scl).long()
    sig = ORI_SIG_FCTR * scl
    expf_scale = -1.0 / (2.0 * sig * sig)
    off = torch.arange(-ORI_RMAX, ORI_RMAX + 1, device=dev)
    i, j = off.view(1, -1, 1), off.view(1, 1, -1)
    h, w = gauss.h[o].view(-1, 1, 1), gauss.w[o].view(-1, 1, 1)
    y, x = r.view(-1, 1, 1) + i, c.view(-1, 1, 1) + j
    rad = radius.view(-1, 1, 1)
    ok = (i.abs() <= rad) & (j.abs() <= rad) & (y > 0) & (y < h - 1) & (x > 0) & (x < w - 1) & alive.view(-1, 1, 1)
    yc, xc = y.clamp(1, None), x.clamp(1, None)
    yc = torch.minimum(yc, h - 2)
    xc = torch.minimum(xc, w - 2)
    ob, pl = o.view(-1, 1, 1), layer.view(-1, 1, 1)
    dx = gauss.at(ob, pl, yc, xc + 1) - gauss.at(ob, pl, yc, xc - 1)
    dy = gauss.at(ob, pl, yc - 1, xc) - gauss.at(ob, pl, yc + 1, xc)
    wgt = torch.exp((i * i + j * j).float() * expf_scale.view(-1, 1, 1))
    ori = fast_atan2(dy, dx)
    mag = torch.sqrt(dx * dx + dy * dy)
    b = torch.round(_f32(n / 360.0) * ori).long()
    b = torch.where(b >= n, b - n, b)
    b = torch.where(b < 0, b + n, b)
    hist = torch.zeros(o.shape[0], n, dtype=torch.float32, device=dev)
    hist.scatter_add_(1, b.view(o.shape[0], -1), torch.where(ok, wgt * mag, 0.0).view(o.shape[0], -1))
    t = hist
    sm = (t.roll(2, 1) + t.roll(-2, 1)) * (1.0 / 16) + (t.roll(1, 1) + t.roll(-1, 1)) * (4.0 / 16) + t * (6.0 / 16)
    omax = sm.max(1, keepdim=True).values
    thr = omax * _f32(ORI_PEAK_RATIO)
    left, right = sm.roll(1, 1), sm.roll(-1, 1)
    peak = (sm > left) & (sm > right) & (sm >= thr) & alive.view(-1, 1)
    jj = torch.arange(n, device=dev, dtype=torch.float32).view(1, -1)
    den = left - 2 * sm + right
    binf = jj + 0.5 * (left - right) / torch.where(peak, den, 1.0)
    binf = torch.where(binf < 0, n + binf, torch.where(binf >= n, binf - n, binf))
    angle = 360.0 - _f32(360.0 / n) * binf
    angle = torch.where((angle - 360.0).abs() < FLT_EPSILON, 0.0, angle)
    return angle, peak


def _sort_dedup_retain(fields, valid, nfeatures: int):
    """removeDuplicatedSorted then retainBest, on flat keypoint fields:
    returns the fields sorted by (kept first, x, y, size desc, angle,
    response desc, octave desc) and the kept mask in that order."""
    x, y, size, angle, resp, code = fields
    order = torch.arange(x.numel(), device=x.device)
    for key, desc in ((code, True), (resp, True), (angle, False), (size, True), (y, False), (x, False), (~valid, False)):
        k = key[order]
        order = order[torch.sort(k.to(torch.uint8) if k.dtype == torch.bool else k, stable=True, descending=desc).indices]
    x, y, size, angle, resp, code, valid = (a[order] for a in (x, y, size, angle, resp, code, valid))
    same = (x[1:] == x[:-1]) & (y[1:] == y[:-1]) & (size[1:] == size[:-1]) & (angle[1:] == angle[:-1])
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=x.device), same & valid[:-1]])
    keep = valid & ~dup
    if 0 < nfeatures < x.numel():
        kth = torch.topk(torch.where(keep, resp, -math.inf), nfeatures).values[-1]
        keep = keep & (resp >= kth)
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices
    return tuple(a[order] for a in (x, y, size, angle, resp, code)), keep[order]


def _descriptors(gauss: _Flat, o, layer, xo, yo, size_o, angle, rmax: int):
    """calcSIFTDescriptor for keypoints at (xo, yo) in their octave's pixels,
    with size `size_o` there; (n, 128) float32."""
    d, n = DESCR_WIDTH, DESCR_HIST_BINS
    dev = o.device
    out = []
    step = max(1, DESCR_CHUNK_SAMPLES // (2 * rmax + 1) ** 2)
    off = torch.arange(-rmax, rmax + 1, device=dev)
    i, j = off.view(1, -1, 1), off.view(1, 1, -1)
    fi, fj = i.float(), j.float()
    for s in range(0, o.shape[0], step):
        sl = slice(s, s + step)
        ob, pl = o[sl].view(-1, 1, 1), layer[sl].view(-1, 1, 1)
        k = ob.shape[0]
        ori = 360.0 - angle[sl]
        ori = torch.where((ori - 360.0).abs() < FLT_EPSILON, 0.0, ori)
        scl = size_o[sl] * 0.5
        hist_width = DESCR_SCL_FCTR * scl
        h, w = gauss.h[o[sl]], gauss.w[o[sl]]
        radius = torch.round(hist_width * _f32(1.4142135623730951) * (d + 1) * 0.5).long()
        radius = torch.minimum(radius, torch.sqrt((w * w + h * h).double()).long())
        rad_t = _f32(math.pi / 180)
        cos_t = (torch.cos(ori * rad_t) / hist_width).view(-1, 1, 1)
        sin_t = (torch.sin(ori * rad_t) / hist_width).view(-1, 1, 1)
        px = torch.round(xo[sl]).long().view(-1, 1, 1)
        py = torch.round(yo[sl]).long().view(-1, 1, 1)
        c_rot = fj * cos_t - fi * sin_t
        r_rot = fj * sin_t + fi * cos_t
        rbin = (r_rot + d // 2) - 0.5
        cbin = (c_rot + d // 2) - 0.5
        rr, cc = py + i, px + j
        hh, ww, rad = h.view(-1, 1, 1), w.view(-1, 1, 1), radius.view(-1, 1, 1)
        ok = ((rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d) & (rr > 0) & (rr < hh - 1) & (cc > 0)
              & (cc < ww - 1) & (i.abs() <= rad) & (j.abs() <= rad))
        rc = torch.minimum(rr.clamp(1, None), hh - 2)
        ccl = torch.minimum(cc.clamp(1, None), ww - 2)
        dx = gauss.at(ob, pl, rc, ccl + 1) - gauss.at(ob, pl, rc, ccl - 1)
        dy = gauss.at(ob, pl, rc - 1, ccl) - gauss.at(ob, pl, rc + 1, ccl)
        wgt = torch.exp((c_rot * c_rot + r_rot * r_rot) * (-1.0 / (d * d * 0.5)))
        g_ori = fast_atan2(dy, dx)
        g_mag = torch.sqrt(dx * dx + dy * dy)
        obin = (g_ori - ori.view(-1, 1, 1)) * _f32(n / 360.0)
        mag = torch.where(ok, g_mag * wgt, 0.0)
        r0, c0, o0 = torch.floor(rbin), torch.floor(cbin), torch.floor(obin)
        rbin, cbin, obin = rbin - r0, cbin - c0, obin - o0
        r0, c0, o0 = r0.long(), c0.long(), o0.long()
        o0 = torch.where(o0 < 0, o0 + n, o0)
        o0 = torch.where(o0 >= n, o0 - n, o0)
        v_r1 = mag * rbin
        v_r0 = mag - v_r1
        v_rc11 = v_r1 * cbin
        v_rc10 = v_r1 - v_rc11
        v_rc01 = v_r0 * cbin
        v_rc00 = v_r0 - v_rc01
        v111 = v_rc11 * obin
        v110 = v_rc11 - v111
        v101 = v_rc10 * obin
        v100 = v_rc10 - v101
        v011 = v_rc01 * obin
        v010 = v_rc01 - v011
        v001 = v_rc00 * obin
        v000 = v_rc00 - v001
        idx = ((r0 + 1) * (d + 2) + c0 + 1) * (n + 2) + o0
        idx = torch.where(ok, idx, 0)
        row = (d + 2) * (n + 2)
        parts = ((0, v000), (1, v001), (n + 2, v010), (n + 3, v011),
                 (row, v100), (row + 1, v101), (row + n + 2, v110), (row + n + 3, v111))
        hist = torch.zeros(k, (d + 2) * (d + 2) * (n + 2), dtype=torch.float32, device=dev)
        hist.scatter_add_(1, torch.cat([(idx + a).view(k, -1) for a, _ in parts], 1),
                          torch.cat([torch.where(ok, v, 0.0).view(k, -1) for _, v in parts], 1))
        hist = hist.view(k, d + 2, d + 2, n + 2)
        raw = hist[:, 1:d + 1, 1:d + 1, :n].clone()
        raw[..., 0] += hist[:, 1:d + 1, 1:d + 1, n]
        raw[..., 1] += hist[:, 1:d + 1, 1:d + 1, n + 1]
        raw = raw.reshape(k, -1)
        thr = torch.sqrt((raw * raw).sum(1, keepdim=True)) * DESCR_MAG_THR
        raw = torch.minimum(raw, thr)
        nrm = INT_DESCR_FCTR / torch.clamp(torch.sqrt((raw * raw).sum(1, keepdim=True)), min=FLT_EPSILON)
        out.append(torch.clamp(torch.round(raw * nrm), 0, 255))
    if not out:
        return torch.zeros(0, d * d * n, dtype=torch.float32, device=dev)
    return torch.cat(out)


def _default_cap(shape) -> int:
    """Candidate slots for an image of `shape` (h, w): one per 512 DoG
    positions of the first octave."""
    return max(1024, 3 * 4 * shape[0] * shape[1] // 512)


def detect_and_compute(gray, nfeatures: int = 0, device="cuda"):
    """SIFT keypoints and descriptors of one grey image.

    gray: (h, w) uint8 array or tensor (grey levels). nfeatures: keep the
    best `nfeatures` by response (0 keeps all). Returns (Keypoints, (n, 128)
    float32 descriptors), both on `device`."""
    dev = torch.device(device)
    img = gray if torch.is_tensor(gray) else torch.from_numpy(np.ascontiguousarray(gray))
    if dev.type == "cuda" and img.device.type == "cpu":
        img = img.pin_memory()          # so the copy does not wait for the card
    img = img.to(dev, non_blocking=True).to(torch.float32)
    if img.ndim != 2:
        raise ValueError(f"detect_and_compute takes a grey (h, w) image, not {tuple(img.shape)}")
    with span("sift.pyramid"):
        pyr = gaussian_pyramid(img)
    if not pyr:
        empty = torch.zeros(0, dtype=torch.float32, device=dev)
        return (Keypoints(empty.view(0, 2), empty, empty, empty, empty.int()),
                torch.zeros(0, 128, dtype=torch.float32, device=dev))
    with span("sift.extrema"):
        gauss = _Flat([torch.stack(octave) for octave in pyr])
        dog_stacks = [torch.stack([b - a for a, b in zip(octave[:-1], octave[1:])]) for octave in pyr]
        ext = torch.cat([_extrema(d).reshape(-1) for d in dog_stacks])
    return _from_candidates(ext, pyr, gauss, _Flat(dog_stacks), nfeatures, _default_cap(img.shape))


def _from_candidates(ext, pyr, gauss, dogs, nfeatures, cap):
    dev = ext.device
    hw = [octave[0].shape for octave in pyr]
    ext_off = device_constant((0, *np.cumsum([N_LAYERS * h * w for h, w in hw])[:-1].tolist()), torch.long, dev)
    while True:
        idx = _compact(ext, cap)
        alive = idx >= 0
        g = idx.clamp(min=0)
        o = torch.searchsorted(ext_off, g, right=True) - 1
        local = g - ext_off[o]
        h, w = dogs.h[o], dogs.w[o]
        layer = local // (h * w) + 1
        r = (local % (h * w)) // w
        c = local % w
        # Dead slots sit at a harmless interior point of octave 0.
        layer = torch.where(alive, layer, 1)
        r = torch.where(alive, r, IMG_BORDER)
        c = torch.where(alive, c, IMG_BORDER)
        o = torch.where(alive, o, 0)
        with span("sift.refine"):
            (x, y, size, resp, code), (layer, r, c), alive = _refine(dogs, o, layer, r, c, alive)
        with span("sift.orientation"):
            angle, peak = _orientations(gauss, o, layer, r, c, size, alive)
        nb = ORI_HIST_BINS
        fields = tuple(a.view(-1, 1).expand(-1, nb).reshape(-1) for a in (x, y, size)) + (angle.reshape(-1),) + \
            tuple(a.view(-1, 1).expand(-1, nb).reshape(-1) for a in (resp, code))
        with span("sift.sort"):
            (x, y, size, angle, resp, code), keep = _sort_dedup_retain(fields, peak.reshape(-1), nfeatures)
        o_k = code & 255
        scl = size * 0.5 / torch.pow(2.0, o_k.float())
        hist_width = DESCR_SCL_FCTR * scl
        radius = torch.round(hist_width * _f32(1.4142135623730951) * (DESCR_WIDTH + 1) * 0.5).long()
        # The one host read: keypoints, candidates, the largest radius.
        n, n_cand, rmax = torch.stack([keep.sum(), ext.sum(),
                                       torch.where(keep, radius, 0).max()]).tolist()
        if n_cand <= cap:
            break
        cap = n_cand
    x, y, size, angle, resp, code = (a[:n] for a in (x, y, size, angle, resp, code))
    o_k = code & 255
    layer_k = (code >> 8) & 255
    inv = torch.pow(2.0, -o_k.float())
    with span("sift.descriptors"):
        desc = _descriptors(gauss, o_k, layer_k, x * inv, y * inv, size * inv, angle, max(int(rmax), 1))
    octave = ((code & ~255) | ((code - 1) & 255)).int()
    kp = Keypoints(torch.stack([x * 0.5, y * 0.5], 1), size * 0.5, angle, resp, octave)
    return kp, desc
