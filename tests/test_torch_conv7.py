"""The encoder's 7x7 convolutions (ops/conv7.py, csrc/conv7_nhwc.cu).

On the CPU: the wrapper is the plain composition the modules ran before,
bit for bit; EpipolarTransformer keeps its state-dict keys and shapes and
its forward (against the benchmark's frozen copy of the port's plain
modules) and sends the refinement's two and the feed-forward's first
convolution through the wrapper; the weight loader and the converter still
round-trip; the wrapper's refusals, which come before any launch. On the
card (`gpu`, skipped without one; run with
`python -m pytest --noconftest -m gpu tests/test_torch_conv7.py -q`): the
kernel bit for bit against cuDNN's channels-last call, whose generic engine
sums in the kernel's order, and against a float64 composition, at the main
path's shapes, the finetune tile's, a ragged one and batch 1; its
determinism; the autograd function's gradients; no pre-activation without
grad; an EpipolarTransformer forward bit for bit against the frozen plain
modules, with its launches; the wrapper's refusals. The file imports no JAX.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.ggrt import config as ref_config
from benchmark.reference.ggrt.models import epipolar_transformer as ref_et
from ggrt_official_torch import config, weights
from ggrt_official_torch.models import epipolar_transformer as et
from ggrt_official_torch.models.epipolar_sampler import generate_image_rays
from ggrt_official_torch.models.ggrt import GGRtModel
from ggrt_official_torch.ops import conv7 as c7
from ggrt_official_torch.training import convert

U = 2.0 ** -24  # float32's unit roundoff


def look_at(center, target=(0.0, 0.0, 4.0)):
    f = np.asarray(target) - center
    f = f / np.linalg.norm(f)
    r = np.cross([0.0, 1.0, 0.0], f)
    r = r / np.linalg.norm(r)
    m = np.eye(4)
    m[:3, :3] = np.stack([r, np.cross(f, r), f], axis=1)
    m[:3, 3] = center
    return m


def wide_pair(device="cpu"):
    """Two cameras 2 units apart looking at a point 4 units away."""
    E = np.stack([look_at(np.array([-1.0, 0.05, 0.0])), look_at(np.array([1.0, -0.05, 0.1]))])
    I = np.array([[1.2, 0, 0.5], [0, 2.4, 0.5], [0, 0, 1]])
    out = (E[None], np.broadcast_to(I, (1, 2, 3, 3)), np.full((1, 2), 1.0), np.full((1, 2), 10.0))
    return tuple(torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device) for a in out)


def conv_layer(cin, cout, seed, device="cpu"):
    conv = nn.Conv2d(cin, cout, 7, padding=3)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) / math.sqrt(49 * cin))
        conv.bias.copy_(torch.randn(cout, generator=g) * 0.1)
    return conv.to(device)


def nhwc(b, c, h, w, seed, device="cpu"):
    """A (b, c, h, w) channels-last tensor, as the encoder holds them."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, h, w, c, generator=g).to(device).permute(0, 3, 1, 2)


# --- CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("mode", c7.EPILOGUES)
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_cpu_wrapper_is_the_plain_composition(mode, layout):
    """On the CPU the wrapper returns what the modules' nn.Sequential and
    residual add returned, bit for bit, in either layout, with gradients."""
    conv = conv_layer(16, 24, 0)
    x = nhwc(2, 16, 9, 13, 1)
    if layout == "contiguous":
        x = x.contiguous()
    x.requires_grad_(True)
    res = nhwc(2, 24, 9, 13, 2) if mode == c7.RESIDUAL else None
    got = c7.conv7(x, conv, mode, residual=res)
    y = conv(x)
    want = nn.GELU(approximate="tanh")(y) if mode == c7.GELU else res + y
    assert torch.equal(got, want)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    (ga,) = torch.autograd.grad(got, x, g)
    (gb,) = torch.autograd.grad(want, x, g)
    assert torch.equal(ga, gb)


def ref_module(cfg_port, d_in):
    """The benchmark's frozen copy of the port's plain EpipolarTransformer,
    at the same configuration."""
    rcfg = ref_config.pretrain_config()
    fields = {k: getattr(cfg_port, k) for k in cfg_port.__dataclass_fields__ if k != "self_attention"}
    sa = ref_config.ImageSelfAttentionCfg(**vars(cfg_port.self_attention))
    return ref_et.EpipolarTransformer(type(rcfg.encoder.epipolar_transformer)(**fields, self_attention=sa), d_in)


@pytest.mark.parametrize("name", ["pretrain", "tiny"])
def test_state_dict_keys_and_shapes_unchanged(name):
    """The module's keys and shapes are those of the plain modules'; the
    refinement's and the feed-forward's 7x7 rows are among them."""
    cfg = (config.pretrain_config() if name == "pretrain" else config.tiny_config()).encoder
    port = et.EpipolarTransformer(cfg.epipolar_transformer, cfg.d_feature)
    ref = ref_module(cfg.epipolar_transformer, cfg.d_feature)
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    d, m = cfg.d_feature, cfg.epipolar_transformer.d_mlp
    assert shapes["upscale_refinement.0.weight"] == (2 * d, d, 7, 7)
    assert shapes["upscale_refinement.2.weight"] == (d, 2 * d, 7, 7)
    assert shapes["transformer.layers.0.1.fn.layers.0.weight"] == (m, d, 7, 7)
    assert shapes["transformer.layers.0.1.fn.layers.3.bias"] == (d,)


@pytest.mark.parametrize("token_slice", [None, (1, 2, 4, 6)])
def test_cpu_forward_equals_plain_modules(token_slice):
    """EpipolarTransformer's forward at tiny widths, whole and on a crop
    tile, equals the plain modules' bit for bit on the CPU, gradients too."""
    cfg = config.tiny_config().encoder
    torch.manual_seed(0)
    port = et.EpipolarTransformer(cfg.epipolar_transformer, cfg.d_feature)
    ref = ref_module(cfg.epipolar_transformer, cfg.d_feature)
    ref.load_state_dict(port.state_dict())
    feats = torch.randn(1, 2, 32, 64, cfg.d_feature, generator=torch.Generator().manual_seed(1))
    cams = wide_pair()
    kw = {}
    if token_slice is not None:
        # The tile's query rays cut out of the downscaled grid's, as the
        # encoder's crop path does.
        y0, x0, hq, wq = token_slice
        ds = cfg.epipolar_transformer.downscale
        full = generate_image_rays((32 // ds, 64 // ds), cams[0], cams[1])
        rays = tuple(t.reshape(1, 2, 32 // ds, 64 // ds, -1)[:, :, y0:y0 + hq, x0:x0 + wq].reshape(1, 2, hq * wq, -1)
                     for t in full)
        kw = dict(rays=rays, token_slice=token_slice)
    outs = []
    for mod in (port, ref):
        mod.zero_grad()
        out, _ = mod(feats, *cams, **kw)
        out.square().mean().backward()
        outs.append((out, mod.upscale_refinement[0].weight.grad, mod.transformer.layers[0][1].fn.layers[3].weight.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_weights_and_converter_round_trip():
    """A GGRtModel's state_dict through the torch -> flax layout helpers and
    back through weights.ggrt_params_from_jax, and through the reference
    checkpoint converter, bit for bit; the 7x7 rows are converted."""
    cfg = config.tiny_config()
    sd = GGRtModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    rows = weights.encoder_name_map(cfg.encoder)
    names = {k for k, _, _ in rows}
    assert {"epipolar_transformer.upscale_refinement.0.weight", "epipolar_transformer.upscale_refinement.2.bias",
            "epipolar_transformer.transformer.layers.0.1.fn.layers.0.weight",
            "epipolar_transformer.transformer.layers.0.1.fn.layers.3.weight"} <= names

    def tree(rows, part):
        out = {}
        for key, path, kind in rows:
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = convert.convert_tensor(kind, sd[part + key].numpy())
        return out

    flax = {"pose_learner": tree(weights.depth_pose_net_name_map(cfg.iponet.feat_ratio), "pose_learner."),
            "gaussian": {"encoder": tree(rows, "gaussian.encoder.")}}
    back = weights.ggrt_params_from_jax(flax, cfg)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    ckpt = {part: {k.removeprefix(part + "."): v.numpy() for k, v in sd.items() if k.startswith(part + ".")}
            for part in ("pose_learner", "gaussian")}
    model = GGRtModel(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    model.load_state_dict(convert.convert_reference_checkpoint(ckpt, model, encoder_cfg=cfg.encoder))
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("name", ["pretrain", "tiny"])
def test_forward_routes_the_generic_engine_convolutions(name, monkeypatch):
    """A forward sends the refinement's two convolutions (GELU, then the
    residual) and each feed-forward's first (GELU) through conv7, and leaves
    the feed-forward's second, which cuDNN runs as an FFT, to its Conv2d."""
    cfg = (config.pretrain_config() if name == "pretrain" else config.tiny_config()).encoder
    ecfg = cfg.epipolar_transformer
    port = et.EpipolarTransformer(ecfg, cfg.d_feature)
    calls = []

    def spy(x, conv, mode, residual=None):
        calls.append((conv, mode, residual is not None))
        return c7.conv7(x, conv, mode, residual)

    monkeypatch.setattr(et, "conv7", spy)
    second = []
    for layer in port.transformer.layers:
        layer[1].fn.layers[3].register_forward_hook(lambda m, i, o: second.append(m))
    feats = torch.randn(1, 2, 32, 64, cfg.d_feature, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        port(feats, *wide_pair())
    ffs = [layer[1].fn.layers for layer in port.transformer.layers]
    r = port.upscale_refinement
    assert calls == [(ff[0], c7.GELU, False) for ff in ffs] + [(r[0], c7.GELU, False), (r[2], c7.RESIDUAL, True)]
    assert second == [ff[3] for ff in ffs]


def _refusal(case):
    """Arguments of one call the wrapper refuses, on CPU tensors."""
    x, conv, mode, res = nhwc(1, 32, 9, 13, 0), conv_layer(32, 24, 0), c7.GELU, None
    if case == "nchw":
        x = x.contiguous()
    elif case == "float64":
        x = x.double()
    elif case == "cin":
        x, conv = nhwc(1, 18, 9, 13, 0), conv_layer(18, 24, 0)
    elif case == "cin_over":
        x, conv = nhwc(1, c7.MAX_CIN + 32, 9, 13, 0), conv_layer(c7.MAX_CIN + 32, 24, 0)
    elif case == "cout":
        conv = conv_layer(32, 6, 0)
    elif case == "kernel_size":
        conv = nn.Conv2d(32, 24, 5, padding=2)
    elif case == "epilogue":
        mode = 2
    elif case == "no_residual":
        mode = c7.RESIDUAL
    elif case == "residual_shape":
        mode, res = c7.RESIDUAL, nhwc(1, 24, 9, 12, 1)
    return x, conv, mode, res


@pytest.mark.parametrize("case,match", [
    ("nchw", "channels-last"), ("float64", "channels-last"), ("cin", "Cin a multiple of 4"),
    ("cin_over", "up to 256"), ("cout", "multiple of 4"), ("kernel_size", r"\(Cout, Cin, 7, 7\)"),
    ("epilogue", "unknown epilogue"), ("no_residual", "residual"), ("residual_shape", "residual"),
    ("valid_on_cpu", "CUDA card"),
])
def test_launch_refuses_before_any_launch(case, match):
    """The kernel's wrapper checks its arguments before it builds or
    launches anything: a layout, type, channel count, kernel size, epilogue
    or residual the kernel does not take, and any tensor off a CUDA card,
    raise ValueError, and the launch count stays. The device comes last, so
    each case raises on the CPU for its own reason."""
    x, conv, mode, res = _refusal(case)
    n = c7.conv7_kernel.launches
    with pytest.raises(ValueError, match=match):
        c7.conv7_kernel.launch(x, conv.weight, conv.bias, mode, res)
    assert c7.conv7_kernel.launches == n


# --- card --------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def check_against_float64(x, conv, mode, res, got):
    """The kernel against the composition in float64. A sum of K = 49·Cin
    float32 products, each rounded once by an FMA, is off the exact sum by
    at most (K + 1)·u·Σ|x·w| (u = 2^-24), and the bias adds one rounding;
    GELU's slope is at most 1.13 and tanhf is within 2 ulp. As rounding
    errors add like a random walk, the mean error is held to 4·sqrt(K)·u of
    the mean magnitude as well."""
    x64, w64, b64 = x.double(), conv.weight.double(), conv.bias.double()
    y = F.conv2d(x64, w64, b64, padding=3)
    mag = F.conv2d(x64.abs(), w64.abs(), b64.abs(), padding=3)
    K = 49 * x.shape[1]
    tol = (K + 2) * U * mag
    if mode == c7.GELU:
        want = F.gelu(y, approximate="tanh")
        tol = 1.13 * tol + 8 * U * y.abs() + 1e-30
    else:
        want = res.double() + y
        tol = tol + U * want.abs()
    err = (got.double() - want).abs()
    assert bool((err <= tol).all()), f"max err {err.max().item()}, over tol at {(err > tol).sum().item()}"
    assert err.mean().item() <= 4 * math.sqrt(K) * U * mag.mean().item()


SHAPES = [  # (B, Cin, H, W, Cout, mode)
    (8, 128, 320, 448, 256, c7.GELU),      # the refinement's first convolution
    (8, 256, 320, 448, 128, c7.RESIDUAL),  # and its second
    (8, 128, 80, 112, 256, c7.GELU),       # the feed-forward's first
    (2, 128, 160, 224, 256, c7.GELU),      # a finetune crop tile's refinement
    (2, 256, 40, 56, 128, c7.RESIDUAL),    # at the feed-forward's size
    (1, 128, 37, 53, 256, c7.RESIDUAL),    # ragged, batch 1
    (1, 32, 37, 53, 32, c7.GELU),          # tiny_config()'s widths: a part of a channel block
    (2, 16, 16, 32, 32, c7.GELU),          # the parallel dry run's: Cin padded to 32 with zeros
    (2, 36, 19, 21, 20, c7.RESIDUAL),      # Cin past one stage, padded to 64
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,cin,h,w,cout,mode", SHAPES)
def test_kernel_against_float64(cuda, b, cin, h, w, cout, mode):
    conv = conv_layer(cin, cout, 0, cuda)
    x = nhwc(b, cin, h, w, 1, cuda)
    res = nhwc(b, cout, h, w, 2, cuda) if mode == c7.RESIDUAL else None
    n = c7.conv7_kernel.launches
    with torch.no_grad():
        got = c7.conv7(x, conv, mode, residual=res)
    torch.cuda.synchronize()
    assert c7.conv7_kernel.launches == n + 1
    assert got.is_contiguous(memory_format=torch.channels_last) and got.shape == (b, cout, h, w)
    check_against_float64(x, conv, mode, res, got)


@pytest.mark.gpu
@pytest.mark.parametrize("b,cin,h,w,cout,mode", [
    (8, 128, 320, 448, 256, c7.GELU), (8, 256, 320, 448, 128, c7.RESIDUAL), (8, 128, 80, 112, 256, c7.GELU),
    (12, 128, 160, 224, 256, c7.GELU), (12, 128, 40, 56, 256, c7.GELU),
])
def test_kernel_bit_equal_to_cudnn(cuda, b, cin, h, w, cout, mode):
    """At the shapes where cuDNN runs the channels-last call on its generic
    engine (convolve_common_engine_float_NHWC: a request's refinement and
    first feed-forward convolutions, the finetune's 128 -> 256 ones), the
    kernel sums in that engine's order (ky, kx, then Cin ascending, one FMA
    each from 0, the bias added after), so its output, the pre-activation
    too, is the plain composition's bit for bit."""
    conv = conv_layer(cin, cout, 0, cuda)
    x = nhwc(b, cin, h, w, 1, cuda)
    res = nhwc(b, cout, h, w, 2, cuda) if mode == c7.RESIDUAL else None
    with torch.no_grad():
        got, pre = c7.conv7_kernel.launch(x, conv.weight, conv.bias, mode, res, keep_pre=True)
        want = c7.conv7_plain(x, conv.weight, conv.bias, mode, res)
        assert torch.equal(got, want), (got - want).abs().max().item()
        if mode == c7.GELU:
            assert torch.equal(pre, F.conv2d(x, conv.weight, conv.bias, padding=3))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 128, 320, 448, 256), (2, 256, 40, 56, 128)])
def test_kernel_is_deterministic(cuda, shape):
    """No split of K and no atomics: two calls give the same bytes, and the
    pre-activation a grad call writes is the GELU's input."""
    b, cin, h, w, cout = shape
    conv = conv_layer(cin, cout, 0, cuda)
    x = nhwc(b, cin, h, w, 1, cuda)
    k = c7.conv7_kernel
    with torch.no_grad():
        one, _ = k.launch(x, conv.weight, conv.bias, c7.GELU)
        two, pre = k.launch(x, conv.weight, conv.bias, c7.GELU, keep_pre=True)
    assert torch.equal(one, two)
    assert torch.equal(F.gelu(pre, approximate="tanh"), one)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", c7.EPILOGUES)
def test_function_gradients(cuda, mode):
    """Input, weight, bias (and residual) gradients of the autograd function
    against autograd through the plain composition in float64: both
    backwards are float32 sums of at most 49·256 (input) or B·H·W (weight)
    terms, 2e-5 of the largest gradient."""
    conv = conv_layer(128, 256 if mode == c7.GELU else 128, 0, cuda)
    x = nhwc(2, 128, 40, 56, 1, cuda).requires_grad_(True)
    res = nhwc(2, conv.out_channels, 40, 56, 2, cuda).requires_grad_(True) if mode == c7.RESIDUAL else None
    out = c7.conv7(x, conv, mode, residual=res)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)).to(cuda)
    leaves = [x, conv.weight, conv.bias] + ([res] if res is not None else [])
    got = torch.autograd.grad(out, leaves, g)
    leaves64 = [t.detach().double().requires_grad_(True) for t in leaves]
    want_out = c7.conv7_plain(leaves64[0], leaves64[1], leaves64[2], mode,
                              leaves64[3] if res is not None else None)
    want = torch.autograd.grad(want_out, leaves64, g.double())
    for name, a, e in zip(("x", "weight", "bias", "residual"), got, want):
        assert a.dtype == torch.float32 and a.shape == e.shape, name
        assert (a.double() - e).abs().max().item() <= 2e-5 * e.abs().max().item(), name


@pytest.mark.gpu
def test_no_grad_allocates_no_pre_activation(cuda):
    """Without grad a GELU call allocates its output and the packed weight,
    no pre-activation; with grad it keeps the pre-activation for the
    backward, as autograd kept the GELU's input before."""
    conv = conv_layer(128, 256, 0, cuda)
    x = nhwc(8, 128, 80, 112, 1, cuda)
    out_bytes = 8 * 256 * 80 * 112 * 4
    w_bytes = conv.weight.numel() * 4
    for grad in (False, True):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.set_grad_enabled(grad):
            conv.weight.requires_grad_(grad)
            out = c7.conv7(x, conv, c7.GELU)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        held = torch.cuda.memory_allocated() - base
        if grad:
            assert held >= 2 * out_bytes
        else:
            assert peak <= out_bytes + w_bytes + 2**20
            assert held <= out_bytes + 2**20
        del out


@pytest.mark.gpu
def test_epipolar_transformer_launches_kernel(cuda):
    """A forward of the pretrain-width EpipolarTransformer on a request's 8
    views at 320x448 launches the kernel 2 + layers times, and gives the
    benchmark's frozen plain modules' (cuDNN's) output bit for bit: the
    kernel keeps the summation order of the engine it replaces."""
    cfg = config.pretrain_config().encoder
    torch.manual_seed(0)
    port = et.EpipolarTransformer(cfg.epipolar_transformer, cfg.d_feature).to(cuda)
    ref = ref_module(cfg.epipolar_transformer, cfg.d_feature).to(cuda)
    ref.load_state_dict(port.state_dict())
    feats = torch.randn(4, 2, 320, 448, cfg.d_feature, generator=torch.Generator().manual_seed(1)).to(cuda)
    cams = tuple(t.expand(4, *t.shape[1:]).contiguous() for t in wide_pair(cuda))
    n = c7.conv7_kernel.launches
    with torch.no_grad():
        out, _ = port(feats, *cams)
        want, _ = ref(feats, *cams)
    torch.cuda.synchronize()
    assert c7.conv7_kernel.launches == n + 2 + cfg.epipolar_transformer.num_layers
    assert torch.equal(out, want), (out - want).abs().max().item()


@pytest.mark.gpu
def test_wrapper_refuses_without_fallback(cuda):
    """An NCHW-dense input, channel counts the kernel does not take, a
    float64 input: the wrapper raises and launches nothing."""
    conv = conv_layer(128, 256, 0, cuda)
    n = c7.conv7_kernel.launches
    with torch.no_grad():
        with pytest.raises(ValueError, match="channels-last"):
            c7.conv7(torch.randn(1, 128, 16, 16, device=cuda), conv, c7.GELU)
        with pytest.raises(ValueError, match="Cin a multiple of 4"):
            c7.conv7(nhwc(1, 18, 16, 16, 0, cuda), conv_layer(18, 256, 0, cuda), c7.GELU)
        with pytest.raises(ValueError, match="multiple of 4"):
            c7.conv7(nhwc(1, 128, 16, 16, 0, cuda), conv_layer(128, 6, 0, cuda), c7.GELU)
        with pytest.raises(ValueError, match="up to 256"):
            c7.conv7(nhwc(1, 288, 16, 16, 0, cuda), conv_layer(288, 128, 0, cuda), c7.GELU)
        with pytest.raises(ValueError, match="channels-last"):
            c7.conv7(nhwc(1, 128, 16, 16, 0, cuda).double(), conv, c7.GELU)
    assert c7.conv7_kernel.launches == n
