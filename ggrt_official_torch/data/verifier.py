"""Dataset pose sanity check (the reference's data_verifier.py draws
epipolar lines to inspect; this, as the JAX package's data/verifier.py,
checks them numerically): rays from each context view, projected into the
others, must give finite segments, and the segments must overlap the
image for most rays."""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.epipolar import project_rays
from ..geometry.projection import get_world_rays, sample_image_grid


@torch.no_grad()
def verify_example(example: dict, num_rays: int = 64) -> dict:
    """{mean_overlap, min_overlap, n_view_pairs, ok} of one example's
    context views, on the CPU."""
    ctx = example["context"]
    extr = torch.as_tensor(ctx["extrinsics"], dtype=torch.float32)
    intr = torch.as_tensor(ctx["intrinsics"], dtype=torch.float32)
    near = torch.as_tensor(ctx["near"], dtype=torch.float32)
    far = torch.as_tensor(ctx["far"], dtype=torch.float32)
    v = extr.shape[0]
    h, w = ctx["image"].shape[-2:]

    xy, _ = sample_image_grid((h, w))
    xy = xy.reshape(-1, 2)
    sel = np.linspace(0, xy.shape[0] - 1, num_rays).astype(int)
    xy = xy[torch.as_tensor(sel)]

    overlaps = []
    for i in range(v):
        origins, dirs = get_world_rays(xy, extr[i], intr[i])
        for j in range(v):
            if i == j:
                continue
            seg = project_rays(origins, dirs, extr[j], intr[j],
                               near=torch.full((xy.shape[0],), float(near[i])),
                               far=torch.full((xy.shape[0],), float(far[i])))
            if not bool(torch.isfinite(seg.xy_min).all()):
                raise ValueError("non-finite epipolar segment")
            overlaps.append(float(seg.overlaps_image.float().mean()))

    report = {
        "mean_overlap": float(np.mean(overlaps)),
        "min_overlap": float(np.min(overlaps)),
        "n_view_pairs": len(overlaps),
    }
    report["ok"] = report["mean_overlap"] > 0.2
    return report
