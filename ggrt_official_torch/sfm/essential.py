"""The essential matrix of two views and the relative pose it holds, in
PyTorch on the points' device: what OpenCV's
`findEssentialMat(pts1, pts2, K, RANSAC, prob, threshold)` and
`recoverPose(E, pts1, pts2, K, mask=mask)` compute (calib3d five-point.cpp
and ptsetreg.cpp), in float64.

  * The points are normalised by K; the pixel threshold is divided by
    (fx + fy) / 2, as OpenCV scales it.
  * `five_point`: Nistér's minimal solver, batched over samples. The null
    space of the 5x9 epipolar system (Householder QR), the ten cubic
    constraints det(E) = 0 and 2·E·Eᵀ·E - tr(E·Eᵀ)·E = 0 as a 10x20 matrix
    over Nistér's monomial order, Gauss-Jordan on its left 10x10 block,
    the 3x3 matrix B(z) whose determinant is the degree-10 polynomial in
    z, its roots (25 Aberth-Ehrlich steps in complex128, then Newton on
    the real ones: no eigen-solver, so no host read), and (x, y) from
    B(z)'s null vector. Real roots only (|Im z| <= 1e-8·max(1, |z|)).
  * `find_essential_mat`: RANSAC. Each round draws its 5-point samples
    together from a `torch.Generator`, solves them in one batch and scores
    every solution by the squared Sampson error (float32, as OpenCV keeps
    it) in one pass. OpenCV's sequential loop is then replayed over the
    round's models in draw order, on the card: a model replaces the best
    where it has more inliers (goodCount > max(best, 4)), each improvement
    shrinks the iteration count as RANSACUpdateNumIters says (from at most
    1000), and the round is cut after the sample where OpenCV would
    stop, so as many samples count as OpenCV would draw. A round ends with
    one host read. With exactly 5 points every solution is returned,
    stacked (3k, 3), as OpenCV does.
  * `recover_pose`: the four (R, ±t) of `decompose_essential_mat`, each
    point triangulated linearly for each (the null vector of the 4x4 DLT
    system), and the cheirality count with OpenCV's distance threshold
    50; the first candidate with the most points in front wins, as in
    OpenCV's if-chain.

`decompose_essential_mat` takes the singular vectors without an SVD call
(torch's CUDA SVD reads its status back to the host): V's last column by
inverse iteration on EᵀE through its adjugate, the first by power
iteration, U by E·V. For an essential matrix (two equal singular values)
any orthonormal pair of V's first columns gives the same four candidates,
so these are OpenCV's, possibly with R1, R2 and the sign of t permuted.

The library's batched `linalg.eigvals` and `linalg.svd` in place of the
Aberth steps, the Householder null space and the SVD-free decompositions
give the same edges, but made a pair about 3x slower on an H100 (11 host
reads and ~19,000 launches a pair against 3 and ~2,000; PERF.md).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import device_constant
from ..utils.tracing import span

# Nistér's monomial order for the 10x20 system: the first ten are
# eliminated; rows 4-9 lead with x²z, x², y²z, y², xyz, xy.
_MONOMIALS = ((3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1), (2, 0, 0), (0, 2, 1), (0, 2, 0),
              (1, 1, 1), (1, 1, 0), (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1), (0, 1, 0),
              (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0))
ROOT_ITERS = 25
REAL_TOL = 1e-8
MAX_ITERS = 1000         # OpenCV's default cap on RANSAC's samples
ROUND = 128              # samples drawn and solved together
DISTANCE_THRESH = 50.0   # recoverPose's bound on a triangulated point's depth


def normalize_points(pts: torch.Tensor, K) -> torch.Tensor:
    """(n, 2) pixels -> (n, 2) float64 ((x - cx)/fx, (y - cy)/fy)."""
    K = np.asarray(K, np.float64)
    p = pts.to(torch.float64)
    return torch.stack([(p[:, 0] - K[0, 2]) / K[0, 0], (p[:, 1] - K[1, 2]) / K[1, 1]], 1)


def _null_space(A: torch.Tensor) -> torch.Tensor:
    """(B, m, 9) with m < 9 -> (B, 9, 9 - m): an orthonormal basis of each
    null space, from a Householder QR of Aᵀ."""
    b, m, n = A.shape
    R = A.transpose(1, 2).clone()
    Q = torch.eye(n, dtype=A.dtype, device=A.device).expand(b, n, n).clone()
    for k in range(m):
        x = R[:, k:, k]
        norm = x.norm(dim=1)
        alpha = -torch.where(x[:, 0] < 0, -1.0, 1.0).to(A.dtype) * norm
        v = x.clone()
        v[:, 0] -= alpha
        v = v / v.norm(dim=1, keepdim=True).clamp(min=1e-300)
        R[:, k:, :] -= 2 * v[:, :, None] * (v[:, None, :] @ R[:, k:, :])
        Q[:, :, k:] -= 2 * (Q[:, :, k:] @ v[:, :, None]) * v[:, None, :]
    return Q[:, :, m:]


def _lin(l: torch.Tensor) -> torch.Tensor:
    """A linear form in (x, y, z, 1), (..., 4), as a dense cubic (..., 4, 4, 4)
    indexed by the powers of x, y, z."""
    p = l.new_zeros(*l.shape[:-1], 4, 4, 4)
    p[..., 1, 0, 0], p[..., 0, 1, 0], p[..., 0, 0, 1], p[..., 0, 0, 0] = l.unbind(-1)
    return p


def _mul_lin(p: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The dense polynomial p (degree <= 2) times the linear form l."""
    lx, ly, lz, l1 = (l[..., k, None, None, None] for k in range(4))
    out = p * l1
    out[..., 1:, :, :] += p[..., :-1, :, :] * lx
    out[..., :, 1:, :] += p[..., :, :-1, :] * ly
    out[..., :, :, 1:] += p[..., :, :, :-1] * lz
    return out


def _polymul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of polynomials in z with ascending coefficients on the last axis."""
    out = a.new_zeros(*torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]), a.shape[-1] + b.shape[-1] - 1)
    for i in range(a.shape[-1]):
        out[..., i:i + b.shape[-1]] += a[..., i:i + 1] * b
    return out


def _polyval(c: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Horner's rule: c (..., d + 1) ascending; each c[..., i:i + 1] broadcasts
    against z."""
    out = torch.zeros_like(z) + c[..., -1:]
    for i in range(c.shape[-1] - 2, -1, -1):
        out = out * z + c[..., i:i + 1]
    return out


def poly_roots(c: torch.Tensor) -> torch.Tensor:
    """All complex roots of polynomials with real ascending coefficients
    c (B, d + 1), by Aberth-Ehrlich iteration (a fixed number of steps, so
    nothing is read back) from a circle at the roots' geometric mean
    |c_0 / c_d|^(1/d): (B, d) complex128. On five-point polynomials the
    real roots are numpy's (test_torch_sfm.py)."""
    d = c.shape[-1] - 1
    c = c / c[..., -1:]
    dc = c[..., 1:] * torch.arange(1, d + 1, dtype=c.dtype, device=c.device)
    radius = c[..., 0].abs() ** (1.0 / d)
    radius = torch.where(torch.isfinite(radius) & (radius > 0), radius, 1.0)
    ang = torch.arange(d, dtype=c.dtype, device=c.device) * (2 * math.pi / d) + 0.4
    z = radius[:, None] * torch.polar(torch.ones_like(ang), ang)
    # p and p' by one Horner pass: p' padded to p's length.
    both = torch.stack([c, torch.cat([dc, torch.zeros_like(dc[..., :1])], -1)]).to(torch.complex128)
    eye = torch.eye(d, dtype=torch.bool, device=c.device)
    for _ in range(ROOT_ITERS):
        p, dp = _polyval(both, z)
        w = p / dp
        diff = z[:, :, None] - z[:, None, :]
        s = torch.where(eye, 0, 1.0 / torch.where(eye, 1, diff)).sum(-1)
        step = w / (1 - w * s)
        z = torch.where(torch.isfinite(step), z - step, z)
    return z


def five_point(q1: torch.Tensor, q2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Essential matrices from 5 normalised correspondences per sample.

    q1, q2: (B, 5, 2) float64. Returns E (B, 10, 3, 3), unit Frobenius norm,
    and valid (B, 10): one slot per root of the degree-10 polynomial, valid
    where the root is real and gives a finite solution."""
    x1, y1 = q1[..., 0], q1[..., 1]
    x2, y2 = q2[..., 0], q2[..., 1]
    one = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], -1)
    basis = _null_space(A)                                   # (B, 9, 4): X, Y, Z, W
    l = basis.reshape(-1, 3, 3, 4)                           # E_ij = x X_ij + y Y_ij + z Z_ij + W_ij
    EEt = _mul_lin(_lin(l)[:, :, None], l[:, None]).sum(3)   # (B, 3, 3, 4, 4, 4)
    tr = EEt[:, 0, 0] + EEt[:, 1, 1] + EEt[:, 2, 2]
    C = 2 * _mul_lin(EEt[:, :, :, None], l[:, None]).sum(2) - _mul_lin(tr[:, None, None], l)
    L = _lin(l)

    def minor(a, b, c, d):
        return _mul_lin(L[:, a[0], a[1]], l[:, b[0], b[1]]) - _mul_lin(L[:, c[0], c[1]], l[:, d[0], d[1]])
    det = (_mul_lin(minor((1, 1), (2, 2), (1, 2), (2, 1)), l[:, 0, 0])
           - _mul_lin(minor((1, 0), (2, 2), (1, 2), (2, 0)), l[:, 0, 1])
           + _mul_lin(minor((1, 0), (2, 1), (1, 1), (2, 0)), l[:, 0, 2]))
    polys = torch.cat([det[:, None], C.reshape(-1, 9, 4, 4, 4)], 1)          # (B, 10, 4, 4, 4)
    mono = device_constant(_MONOMIALS, torch.long, q1.device)
    M = polys[:, :, mono[:, 0], mono[:, 1], mono[:, 2]]                    # (B, 10, 20)
    G, _ = torch.linalg.solve_ex(M[:, :, :10], M[:, :, 10:])                # rows: lead + G·tail = 0

    def zpolys(r):
        """Row r's tail as polynomials in z (ascending): of x, of y, of 1."""
        g = G[:, r]
        return g[:, 0:3].flip(1), g[:, 3:6].flip(1), g[:, 6:10].flip(1)

    def times_z(p):
        return torch.cat([torch.zeros_like(p[:, :1]), p], 1)

    def pad(p):
        return torch.cat([p, p.new_zeros(p.shape[0], 5 - p.shape[1])], 1)
    # Row e minus z times row f cancels e's lead (x²z - z·x², and so on):
    # B(z)·(x, y, 1) = 0, entries of degree 3, 3 and 4.
    rows = [[pad(a) - pad(times_z(b)) for a, b in zip(zpolys(e), zpolys(f))] for e, f in ((4, 5), (6, 7), (8, 9))]
    Bz = torch.stack([torch.stack(r, 1) for r in rows], 1)                 # (B, 3, 3, 5)
    b = Bz
    detB = (_polymul(b[:, 0, 0], _polymul(b[:, 1, 1], b[:, 2, 2]) - _polymul(b[:, 1, 2], b[:, 2, 1]))
            - _polymul(b[:, 0, 1], _polymul(b[:, 1, 0], b[:, 2, 2]) - _polymul(b[:, 1, 2], b[:, 2, 0]))
            + _polymul(b[:, 0, 2], _polymul(b[:, 1, 0], b[:, 2, 1]) - _polymul(b[:, 1, 1], b[:, 2, 0])))
    coeffs = detB[:, :11]
    roots = poly_roots(coeffs)
    real = roots.imag.abs() <= REAL_TOL * roots.abs().clamp(min=1.0)
    z = roots.real
    dcoef = coeffs[:, 1:] * torch.arange(1, 11, dtype=z.dtype, device=z.device)
    for _ in range(2):
        step = _polyval(coeffs, z) / _polyval(dcoef, z)
        z = torch.where(torch.isfinite(step), z - step, z)
    Bv = _polyval(Bz, z[:, None, None, :])                                           # (B, 3, 3, 10)
    Bv = Bv.permute(0, 3, 1, 2)                                                      # (B, 10, 3, 3)
    crosses = torch.stack([torch.linalg.cross(Bv[..., 0, :], Bv[..., 1, :]),
                           torch.linalg.cross(Bv[..., 0, :], Bv[..., 2, :]),
                           torch.linalg.cross(Bv[..., 1, :], Bv[..., 2, :])], -2)    # (B, 10, 3, 3)
    pick = crosses.norm(dim=-1).argmax(-1)
    v = torch.gather(crosses, -2, pick[..., None, None].expand(-1, -1, 1, 3))[..., 0, :]
    v = v / v.norm(dim=-1, keepdim=True)
    ok = real & (v[..., 2].abs() >= 1e-10)
    xs, ys = v[..., 0] / v[..., 2], v[..., 1] / v[..., 2]
    X, Y, Z, W = (basis[:, :, k] for k in range(4))
    E = xs[..., None] * X[:, None] + ys[..., None] * Y[:, None] + z[..., None] * Z[:, None] + W[:, None]
    E = E / E.norm(dim=-1, keepdim=True)
    ok = ok & torch.isfinite(E).all(-1)
    return torch.where(ok[..., None], E, 0.0).reshape(*E.shape[:2], 3, 3), ok


def sampson_errors(E: torch.Tensor, q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distances (M, n) float32 of every model E (M, 3, 3)
    and correspondence (n, 2) (EMEstimatorCallback::computeError)."""
    x1 = torch.cat([q1, torch.ones_like(q1[:, :1])], 1)
    x2 = torch.cat([q2, torch.ones_like(q2[:, :1])], 1)
    Ex1 = E @ x1.T                          # (M, 3, n)
    Etx2 = E.transpose(1, 2) @ x2.T
    num = (x2.T[None] * Ex1).sum(1)
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return (num * num / den).to(torch.float32)


def ransac_update_num_iters(p: float, ep: float, model_points: int, max_iters: int) -> int:
    """OpenCV's RANSACUpdateNumIters."""
    p = min(max(p, 0.0), 1.0)
    ep = min(max(ep, 0.0), 1.0)
    num = max(1.0 - p, np.finfo(np.float64).tiny)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < np.finfo(np.float64).tiny:
        return 0
    num, denom = math.log(num), math.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * (-denom) else int(np.rint(num / denom))


def find_essential_mat(pts1: torch.Tensor, pts2: torch.Tensor, K, prob: float = 0.999, threshold: float = 1.0,
                       generator: torch.Generator | None = None):
    """RANSAC essential matrix of pixel correspondences (n, 2), (n, 2).

    Returns (E, mask): E (3, 3) float64 and the inlier mask (n,) bool, both
    on the points' device; E (3k, 3) with every solution when n == 5; (None,
    None) where OpenCV returns no model. `generator` draws the samples (a
    generator on the points' device; seeded 0 when None)."""
    dev = pts1.device
    n = pts1.shape[0]
    if n < 5:
        return None, None
    K = np.asarray(K, np.float64)
    q1, q2 = normalize_points(pts1, K), normalize_points(pts2, K)
    if n == 5:
        E, ok = five_point(q1[None], q2[None])
        E = E[0][ok[0]]
        if E.shape[0] == 0:
            return None, None
        return E.reshape(-1, 3), torch.ones(n, dtype=torch.bool, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    thr = threshold / ((K[0, 0] + K[1, 1]) / 2)
    t = float(np.float32(thr * thr))
    log1mp = math.log(max(1.0 - min(max(prob, 0.0), 1.0), np.finfo(np.float64).tiny))
    niters, done, best = MAX_ITERS, 0, 0
    best_E = best_mask = None
    while done < niters:
        b = min(ROUND, niters - done)
        with span("ransac.five_point"):
            idx = torch.rand(b, n, generator=generator, device=dev).topk(5, dim=1).indices
            E, ok = five_point(q1[idx], q2[idx])
            E = E.reshape(-1, 3, 3)
        with span("ransac.score"):
            inl = (sampson_errors(E, q1, q2) <= t) & ok.reshape(-1, 1)
            # OpenCV's loop, replayed over the round's models in draw order:
            # the best so far (first of equal counts), the iteration count
            # it leaves (RANSACUpdateNumIters after each improvement), and
            # the sample after which OpenCV would stop.
            cnt = inl.sum(1)
            m = cnt.numel()
            key = torch.cummax(cnt * m + (m - 1 - torch.arange(m, device=dev)), 0).values
            run_cnt, run_idx = key // m, m - 1 - key % m
            after = run_cnt.view(b, -1)[:, -1].double()
            denom = 1 - (after / n) ** 5
            g = torch.where(denom < np.finfo(np.float64).tiny, 0.0, torch.round(log1mp / torch.log(denom)))
            left = torch.where(after > max(best, 4), torch.clamp(g, max=float(niters)), float(niters))
            stop = done + torch.arange(1, b + 1, device=dev) >= left
            used = torch.where(stop.any(), torch.argmax(stop.int()) + 1, b)
            last = (used * (m // b) - 1).view(1)
            # Indices as 1-element tensors: a 0-d CUDA index reads it back.
            count, k, used, left = torch.cat([run_cnt.index_select(0, last), run_idx.index_select(0, last), used.view(1),
                                              left.index_select(0, used.view(1) - 1).long()]).tolist()
        if count > max(best, 4):
            best, best_E, best_mask = count, E[k], inl[k]
            niters = left
        done += used
    if best == 0:
        return None, None
    return best_E, best_mask


def _adjugate(A: torch.Tensor) -> torch.Tensor:
    """Adjugate of (..., m, m) matrices, m = 3 or 4, from cofactors."""
    m = A.shape[-1]
    keep = device_constant(tuple(tuple(j for j in range(m) if j != i) for i in range(m)), torch.long, A.device)
    sub = A[..., keep[:, None, :, None], keep[None, :, None, :]]       # (..., m, m, m-1, m-1)
    if m == 3:
        det = sub[..., 0, 0] * sub[..., 1, 1] - sub[..., 0, 1] * sub[..., 1, 0]
    else:
        det = (sub[..., 0, 0] * (sub[..., 1, 1] * sub[..., 2, 2] - sub[..., 1, 2] * sub[..., 2, 1])
               - sub[..., 0, 1] * (sub[..., 1, 0] * sub[..., 2, 2] - sub[..., 1, 2] * sub[..., 2, 0])
               + sub[..., 0, 2] * (sub[..., 1, 0] * sub[..., 2, 1] - sub[..., 1, 1] * sub[..., 2, 0]))
    sign = 1 - 2 * ((torch.arange(m, device=A.device)[:, None] + torch.arange(m, device=A.device)) % 2)
    return (det * sign).transpose(-1, -2)


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the smallest singular value of each
    (..., m, m) matrix, unit norm, sign arbitrary: the largest column of
    adj(A), then inverse iteration on AᵀA through adj(A)·adj(A)ᵀ."""
    adj = _adjugate(A)
    pick = adj.norm(dim=-2).argmax(-1)
    v = torch.gather(adj, -1, pick[..., None, None].expand(*adj.shape[:-1], 1))[..., 0]
    v = v / v.norm(dim=-1, keepdim=True)
    for _ in range(2):
        v = (adj @ (adj.transpose(-1, -2) @ v[..., None]))[..., 0]
        v = v / v.norm(dim=-1, keepdim=True)
    return v


def decompose_essential_mat(E: torch.Tensor):
    """R1, R2 (3, 3) and t (3,) with OpenCV's decomposeEssentialMat's four
    candidates (R1, t), (R2, t), (R1, -t), (R2, -t): E = U diag(1, 1, 0) Vᵀ
    with det U, det V > 0, R1 = U W Vᵀ, R2 = U Wᵀ Vᵀ, t = U's last column."""
    E = E.to(torch.float64)
    v3 = _null_vector(E)
    # V's first column: the top right singular vector (power iteration on
    # EᵀE in the plane orthogonal to v3, from E's largest row).
    rows = E - (E @ v3)[:, None] * v3
    v1 = rows.index_select(0, rows.norm(dim=1).argmax().view(1))[0]
    EtE = E.T @ E
    for _ in range(16):
        v1 = EtE @ v1
        v1 = v1 - (v1 @ v3) * v3
        v1 = v1 / v1.norm()
    v2 = torch.linalg.cross(v3, v1)
    u1 = E @ v1
    u1 = u1 / u1.norm()
    u2 = E @ v2
    u2 = u2 - (u2 @ u1) * u1
    u2 = u2 / u2.norm()
    u3 = torch.linalg.cross(u1, u2)
    U = torch.stack([u1, u2, u3], 1)
    V = torch.stack([v1, v2, v3], 1)
    W = device_constant(((0.0, 1.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 0.0, 1.0)), E.dtype, E.device)
    return U @ W @ V.T, U @ W.T @ V.T, u3


def recover_pose(E: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor, K, mask: torch.Tensor | None = None):
    """OpenCV's recoverPose: (count, R (3, 3), t (3,), mask (n,) bool) on the
    points' device, count a 0-d tensor (the points in front of both cameras
    and nearer than DISTANCE_THRESH, within `mask`)."""
    with span("recover_pose"):
        return _recover_pose(E, pts1, pts2, K, mask)


def _recover_pose(E, pts1, pts2, K, mask):
    K = np.asarray(K, np.float64)
    q1, q2 = normalize_points(pts1, K), normalize_points(pts2, K)
    R1, R2, t = decompose_essential_mat(E.to(q1.device))
    Rs = torch.stack([R1, R2, R1, R2])
    ts = torch.stack([t, t, -t, -t])
    P = torch.cat([Rs, ts[:, :, None]], 2)                                    # (4, 3, 4)
    P0 = torch.eye(3, 4, dtype=q1.dtype, device=q1.device)
    n = q1.shape[0]
    A = torch.stack([
        (q1[:, 0, None] * P0[2] - P0[0]).expand(4, n, 4),
        (q1[:, 1, None] * P0[2] - P0[1]).expand(4, n, 4),
        q2[None, :, 0, None] * P[:, None, 2] - P[:, None, 0],
        q2[None, :, 1, None] * P[:, None, 2] - P[:, None, 1],
    ], 2)                                                                      # (4, n, 4, 4)
    Q = _null_vector(A)                                                        # (4, n, 4)
    front = Q[..., 2] * Q[..., 3] > 0
    Q = Q / Q[..., 3:4]
    front = front & (Q[..., 2] < DISTANCE_THRESH)
    Q2 = (P[:, None] @ Q[..., None])[..., 0]
    front = front & (Q2[..., 2] > 0) & (Q2[..., 2] < DISTANCE_THRESH)
    if mask is not None:
        front = front & mask.to(front.device).reshape(1, -1).bool()
    good = front.sum(1)
    k = torch.argmax(good).view(1)
    return good.index_select(0, k)[0], Rs.index_select(0, k)[0], ts.index_select(0, k)[0], front.index_select(0, k)[0]
