"""The encoder's 7x7 stride-1 "same" convolutions with their epilogues:

    GELU      gelu_tanh(conv(x) + bias)
    RESIDUAL  residual + (conv(x) + bias)

`conv7(x, conv, mode, residual)` takes the `nn.Conv2d` whose weight and bias
it applies (7x7, padding 3). For CPU tensors it runs `conv7_plain`, the
composition the modules ran before (F.conv2d, then F.gelu or the add), so the
CPU path gives the same bits as before. For CUDA tensors it launches the
hand-written kernel (csrc/conv7_nhwc.cu) on channels-last float32 or raises:
there is no fallback to a library convolution. The kernel sums in the order
of cuDNN's generic NHWC engine, which ran these convolutions before, and so
gives its bits. With a gradient to compute it goes through `Conv7Function`,
whose backward is ATen's `convolution_backward` (and `gelu_backward`) on the
tensors autograd saved before: the input, the weight and, for GELU, the
pre-activation; the kernel writes the pre-activation only then.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .cuda_kernel import INT, PTR, CudaKernel

GELU, RESIDUAL = 0, 1
EPILOGUES = (GELU, RESIDUAL)
# The kernel's 8 halo rows of 22 pixels x Cin channels and its weight ring
# take 208 KB of the H100's shared memory at 256 input channels.
MAX_CIN = 256


def conv7_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mode: int,
                residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: x (B, Cin, H, W), weight (Cout, Cin, 7, 7)."""
    y = F.conv2d(x, weight, bias, padding=3)
    if mode == GELU:
        return F.gelu(y, approximate="tanh")
    return residual + y


class Conv7(CudaKernel):
    """Wrapper of the 7x7 NHWC convolution kernel; `launches` counts launches."""

    def __init__(self):
        super().__init__("conv7_nhwc.cu", "conv7_nhwc", [PTR] * 6 + [INT] * 6)

    def launch(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mode: int,
               residual: torch.Tensor | None = None, keep_pre: bool = False):
        """x (B, Cin, H, W) channels-last float32 on one card; returns (out,
        pre): out (B, Cout, H, W) channels-last, pre the GELU's input where
        `keep_pre` (GELU only), else None."""
        if mode not in EPILOGUES:
            raise ValueError(f"unknown epilogue {mode}")
        if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[1:]) != (x.shape[1], 7, 7):
            raise ValueError(f"x {tuple(x.shape)} and weight {tuple(weight.shape)} are not "
                             "(B, Cin, H, W) and (Cout, Cin, 7, 7)")
        B, cin, H, W = x.shape
        cout = weight.shape[0]
        if cin % 4 or cin > MAX_CIN or cout % 4:
            raise ValueError(f"{cin} -> {cout} channels: the kernel takes Cin a multiple of 4 up to "
                             f"{MAX_CIN} and Cout a multiple of 4")
        dev = x.device
        cl = torch.channels_last
        for name, t in (("x", x), ("residual", residual)):
            if t is not None and not (t.device == dev and t.dtype == torch.float32
                                      and t.is_contiguous(memory_format=cl) and t.data_ptr() % 16 == 0):
                raise ValueError(f"{name} must be a channels-last float32 tensor on {dev}, 16-byte aligned")
        if weight.device != dev or weight.dtype != torch.float32 or bias is None \
                or bias.device != dev or bias.dtype != torch.float32 or tuple(bias.shape) != (cout,):
            raise ValueError(f"weight and bias must be float32 on {dev}, bias ({cout},)")
        if mode == RESIDUAL and (residual is None or tuple(residual.shape) != (B, cout, H, W)):
            raise ValueError(f"the residual must be ({B}, {cout}, {H}, {W})")
        if not x.is_cuda:
            raise ValueError(f"the kernel runs on a CUDA card, not on {x.device}")
        keep_pre = keep_pre and mode == GELU
        wpk = weight.detach().permute(2, 3, 1, 0).contiguous()   # [ky][kx][cin][cout]
        b = bias.detach().contiguous()
        out = torch.empty((B, cout, H, W), device=dev, memory_format=cl)
        pre = torch.empty_like(out) if keep_pre else None
        self.run(dev, x.data_ptr(), wpk.data_ptr(), b.data_ptr(),
                 residual.data_ptr() if mode == RESIDUAL else None, out.data_ptr(),
                 pre.data_ptr() if keep_pre else None, B, H, W, cin, cout, mode)
        return out, pre


conv7_kernel = Conv7()


class Conv7Function(torch.autograd.Function):
    """The kernel's forward; the backward of the composition autograd took
    before, on the same saved tensors."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, mode):
        out, pre = conv7_kernel.launch(x, weight, bias, mode, residual, keep_pre=True)
        ctx.mode = mode
        ctx.save_for_backward(x, weight, pre)
        return out

    @staticmethod
    def backward(ctx, gout):
        x, weight, pre = ctx.saved_tensors
        mask = list(ctx.needs_input_grad[:3])
        gx = gw = gb = None
        if any(mask):
            g = torch.ops.aten.gelu_backward(gout, pre, approximate="tanh") if ctx.mode == GELU else gout
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, weight, [weight.shape[0]], [1, 1], [3, 3], [1, 1], False, [0, 0], 1, mask)
        gres = gout if ctx.mode == RESIDUAL and ctx.needs_input_grad[3] else None
        return gx, gw, gb, gres, None


def conv7(x: torch.Tensor, conv: nn.Conv2d, mode: int, residual: torch.Tensor | None = None) -> torch.Tensor:
    """`conv`'s 7x7 convolution of x (B, Cin, H, W) with the epilogue `mode`:
    the plain version on the CPU, the kernel on a card."""
    w, b = conv.weight, conv.bias
    if x.device.type == "cpu":
        return conv7_plain(x, w, b, mode, residual)
    if not x.is_cuda:
        raise RuntimeError(f"no 7x7 convolution for device {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b, residual)):
        return Conv7Function.apply(x, w, b, residual, mode)
    return conv7_kernel.launch(x, w, b, mode, residual)[0]
