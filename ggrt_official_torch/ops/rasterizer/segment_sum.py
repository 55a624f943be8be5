"""Scatter-add of value rows, the record gather's pullback:

    out = zeros((g, C)); out[ids[i]] += vals[i]     (ids == g dropped)

`scatter_add_rows` launches the CUDA kernel (csrc/segment_sum.cu) for CUDA
tensors and runs `scatter_add_rows_plain` for CPU tensors; on any other
device it raises. The TPU package sorted the rows and summed contiguous
windows with one-hot matmuls because the TPU has no atomics; on the card the
kernel adds the live rows atomically.
"""
from __future__ import annotations

import torch

from ..cuda_kernel import INT, LONG, PTR, CudaKernel, check_tensors


def scatter_add_rows_plain(ids: torch.Tensor, vals: torch.Tensor, g: int) -> torch.Tensor:
    """Plain PyTorch version: ids (N,) in [0, g], vals (N, C) -> (g, C)."""
    out = torch.zeros(g + 1, vals.shape[1], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids.long(), vals)[:g]


class SegmentSum(CudaKernel):
    """Wrapper of the CUDA scatter-add kernel; `launches` counts launches."""

    def __init__(self):
        super().__init__("segment_sum.cu", "segment_sum", [PTR, PTR, PTR, LONG, INT, INT])

    def launch(self, ids: torch.Tensor, vals: torch.Tensor, g: int) -> torch.Tensor:
        """ids (N,) int32, vals (N, C) float32 on one card -> (g, C) float32.
        Ids outside [0, g) are dropped."""
        if ids.dim() != 1 or vals.dim() != 2 or vals.shape[0] != ids.shape[0]:
            raise ValueError(f"ids {tuple(ids.shape)} and vals {tuple(vals.shape)} do not form (N,), (N, C)")
        if not 0 <= g < 2**31:
            raise ValueError(f"g={g} out of the int32 range")
        dev = vals.device
        check_tensors(dev, ids=(ids, torch.int32), vals=(vals, torch.float32))
        out = torch.zeros(g, vals.shape[1], dtype=torch.float32, device=dev)
        self.run(dev, ids.data_ptr(), vals.data_ptr(), out.data_ptr(),
                 ids.shape[0], vals.shape[1], g)
        return out

    def __call__(self, ids: torch.Tensor, vals: torch.Tensor, g: int) -> torch.Tensor:
        if vals.is_cuda:
            return self.launch(ids, vals, g)
        if vals.device.type == "cpu":
            return scatter_add_rows_plain(ids, vals, g)
        raise RuntimeError(f"no scatter-add for device {vals.device}")


scatter_add_rows = SegmentSum()
