"""Perceptual losses: VGG19 feature MSE and LPIPS (AlexNet).

Counterpart of `medical_image_editing_tpu/ops/perceptual.py` (reference
`src/functions/perceptual_loss.py`, `VGGLoss`, and
`src/functions/lpips_loss.py`, `lpips.LPIPS(net='alex')`). Images are NCHW
in [-1, 1] with 1 or 3 channels; a single channel is repeated to three.
The networks run in f32 whatever the caller's dtype, on plain `F.conv2d`
and `F.max_pool2d` (never the packed conv route: the JAX functions are
outside its Pallas kernel too), and their frozen weights are buffers, not
parameters: no optimizer, train state or checkpoint holds them. The target
branch is detached. The convolutions and their input gradients take
cuDNN's deterministic algorithms (`_frozen_conv`): with PyTorch's default
heuristics the input gradient's sums change from run to run on an H100,
and a resumed training run would no longer equal a straight one.

Weights come from `MEDIMG_VGG19_NPZ` / `MEDIMG_LPIPS_NPZ` when set: the
torchvision VGG19 `features` state dict (`features.{i}.weight` OIHW,
`features.{i}.bias`) and the lpips package's own state dict
(`net.slice{s}.{i}.weight/bias` convs, `lin{i}.model.1.weight` heads),
saved with np.savez; OIHW is this package's layout, so nothing is
transposed. Without them, the JAX package's fallback: seeded random
features (he-normal, truncated at ±2σ, fan-in scaled; seed 1234 for VGG,
4321 for AlexNet, whose LPIPS heads are uniform 1/C) with a warning. The
stream is torch's, not JAX's, so the fallback's weights are the same
distribution, not the same numbers. The returned module's `.pretrained`
says which.
"""

import contextlib
import math
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torchvision VGG19 `features` as (index, kind): 'C' a 3×3 conv (its ReLU at
# index + 1), 'M' a 2×2 max-pool; conv_index '22' slices [:8], '54' [:35]
_VGG19_LAYOUT = [
    (0, "C"), (2, "C"), (4, "M"), (5, "C"), (7, "C"), (9, "M"),
    (10, "C"), (12, "C"), (14, "C"), (16, "C"), (18, "M"),
    (19, "C"), (21, "C"), (23, "C"), (25, "C"), (27, "M"),
    (28, "C"), (30, "C"), (32, "C"), (34, "C"),
]
_VGG19_CHANNELS = {
    0: 64, 2: 64, 5: 128, 7: 128, 10: 256, 12: 256, 14: 256, 16: 256,
    19: 512, 21: 512, 23: 512, 25: 512, 28: 512, 30: 512, 32: 512, 34: 512,
}
_VGG_STOP = {"22": 8, "54": 35}

# torchvision `alexnet().features` convs: (out_ch, kernel, stride, pad,
# 3×3/2 max-pool before); the relu after each is an LPIPS tap
_ALEX_CONVS = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]
# LPIPS v0.1 ScalingLayer, for [-1, 1] inputs
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def he_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """JAX's `he_normal` on an OIHW kernel: a normal truncated at ±2σ,
    σ = √(2 / fan_in) / 0.8796… so that the truncated draw's std is
    √(2 / fan_in)."""
    std = math.sqrt(2.0 / w[0].numel()) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@contextlib.contextmanager
def _deterministic_cudnn():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


class _FrozenConv(torch.autograd.Function):
    """`F.conv2d` with frozen weights: the gradient goes to the input only,
    and both directions run with cuDNN's deterministic algorithms."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.save_for_backward(weight)
        ctx.shape, ctx.stride, ctx.padding = x.shape, stride, padding
        with _deterministic_cudnn():
            return F.conv2d(x, weight, bias, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, grad):
        (weight,) = ctx.saved_tensors
        with _deterministic_cudnn():
            gx = torch.nn.grad.conv2d_input(ctx.shape, weight, grad, stride=ctx.stride,
                                            padding=ctx.padding)
        return gx, None, None, None, None


def _frozen_conv(x, conv, stride=1, padding=1):
    return _FrozenConv.apply(x, conv.weight, conv.bias, stride, padding)


class _Conv(nn.Module):
    """A frozen convolution's weight (OIHW) and bias, as buffers."""

    def __init__(self, weight, bias):
        super().__init__()
        self.register_buffer("weight", torch.as_tensor(weight, dtype=torch.float32))
        self.register_buffer("bias", torch.as_tensor(bias, dtype=torch.float32))


def _prep(x):
    x = x.float()
    return x.repeat(1, 3, 1, 1) if x.shape[1] == 1 else x


class VGGLoss(nn.Module):
    """(pred, target) NCHW → the MSE of their VGG19 features through
    torchvision index `stop_index` (exclusive). The raw [-1, 1] input goes
    in without ImageNet normalization, as the reference feeds it
    (`perceptual_loss.py:44-53`); a ReLU applies only inside the slice, so
    the slice ends at a conv (index 7 for '22')."""

    def __init__(self, convs: dict, stop_index: int, pretrained: bool):
        super().__init__()
        self.stop_index = stop_index
        self.pretrained = pretrained
        self.features = nn.Module()
        for i, (w, b) in convs.items():
            self.features.add_module(str(i), _Conv(w, b))

    def feature_stack(self, x):
        for idx, kind in _VGG19_LAYOUT:
            if idx >= self.stop_index:
                break
            if kind == "M":
                x = F.max_pool2d(x, 2)
            else:
                x = _frozen_conv(x, getattr(self.features, str(idx)))
                if idx + 1 < self.stop_index:
                    x = F.relu(x)
        return x

    def forward(self, pred, target):
        fp = self.feature_stack(_prep(pred))
        ft = self.feature_stack(_prep(target.detach()))
        return torch.mean((fp - ft) ** 2)


def _load_vgg_convs(stop_index: int):
    """{index: (weight OIHW, bias)} for the convs below `stop_index`, and
    whether they are pretrained."""
    path = os.environ.get("MEDIMG_VGG19_NPZ", "")
    indices = [i for i in _VGG19_CHANNELS if i < stop_index]
    if path and os.path.exists(path):
        raw = np.load(path)
        return {i: (raw[f"features.{i}.weight"], raw[f"features.{i}.bias"])
                for i in indices}, True
    warnings.warn(
        "No pretrained VGG19 weights (set MEDIMG_VGG19_NPZ); using seeded "
        "random-feature VGG for the perceptual loss.",
        stacklevel=3,
    )
    gen = torch.Generator().manual_seed(1234)
    convs, cin = {}, 3
    for i in indices:
        cout = _VGG19_CHANNELS[i]
        convs[i] = (he_normal_(torch.empty(cout, cin, 3, 3), gen), torch.zeros(cout))
        cin = cout
    return convs, False


def make_vgg_loss(conv_index: str = "22", device="cuda") -> VGGLoss:
    """The reference's `VGGLoss` at `conv_index` '22' (relu2_2's slice,
    `modules[:8]`) or '54' (`[:35]`), on `device`."""
    from ..utils.device import resolve_device

    stop_index = _VGG_STOP[conv_index]
    dev = resolve_device(device)
    convs, pretrained = _load_vgg_convs(stop_index)
    return VGGLoss(convs, stop_index, pretrained).to(dev).eval()


class LPIPSLoss(nn.Module):
    """`lpips.LPIPS(net='alex')`: the ScalingLayer on [-1, 1] inputs,
    AlexNet's relu1-relu5 taps, each unit-normalized over channels (eps
    1e-10), the squared difference through the non-negative 1×1 heads,
    the spatial and batch mean, summed over the taps."""

    def __init__(self, convs, lins, pretrained: bool):
        super().__init__()
        self.pretrained = pretrained
        self.convs = nn.ModuleList(_Conv(w, b) for w, b in convs)
        for k, lin in enumerate(lins):
            self.register_buffer(f"lin{k}", torch.as_tensor(lin, dtype=torch.float32))
        # constants, not weights: outside the state dict
        self.register_buffer("shift", torch.tensor(_LPIPS_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_LPIPS_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def taps(self, x):
        out = []
        for conv, (_, _, stride, pad, pool_before) in zip(self.convs, _ALEX_CONVS):
            if pool_before:
                x = F.max_pool2d(x, 3, stride=2)
            x = F.relu(_frozen_conv(x, conv, stride, pad))
            out.append(x)
        return out

    def forward(self, pred, target):
        fp = self.taps((_prep(pred) - self.shift) / self.scale)
        ft = self.taps((_prep(target.detach()) - self.shift) / self.scale)
        total = torch.zeros((), device=fp[0].device)
        for k, (a, b) in enumerate(zip(fp, ft)):
            a = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)) + 1e-10)
            b = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True)) + 1e-10)
            lin = getattr(self, f"lin{k}")
            total = total + torch.mean(torch.sum((a - b) ** 2 * lin[None, :, None, None], dim=1))
        return total


def _load_lpips_alex():
    """(convs [(weight OIHW, bias)], heads [(C,)], pretrained)."""
    path = os.environ.get("MEDIMG_LPIPS_NPZ", "")
    if path and os.path.exists(path):
        raw = np.load(path)
        conv_keys = sorted(
            (k for k in raw.files if k.startswith("net.slice") and k.endswith(".weight")),
            key=lambda k: (int(k.split(".")[1][5:]), int(k.split(".")[2])),
        )
        if not conv_keys or "lin0.model.1.weight" not in raw.files:
            raise ValueError(
                f"MEDIMG_LPIPS_NPZ={path} is not an lpips state_dict npz "
                "(expected 'net.slice*.weight' convs and 'lin{i}.model.1."
                "weight' heads; found keys like "
                f"{sorted(raw.files)[:4]}...). Re-create it with "
                "tools/convert_perceptual_weights.py."
            )
        convs = [(raw[k], raw[k[:-len("weight")] + "bias"]) for k in conv_keys]
        lins = [raw[f"lin{i}.model.1.weight"].reshape(-1) for i in range(5)]
        return convs, lins, True
    warnings.warn(
        "No pretrained LPIPS(alex) weights (set MEDIMG_LPIPS_NPZ); using a "
        "seeded random AlexNet with uniform linear heads.",
        stacklevel=3,
    )
    gen = torch.Generator().manual_seed(4321)
    convs, lins, cin = [], [], 3
    for cout, k, _, _, _ in _ALEX_CONVS:
        convs.append((he_normal_(torch.empty(cout, cin, k, k), gen), torch.zeros(cout)))
        lins.append(torch.full((cout,), 1.0 / cout))
        cin = cout
    return convs, lins, False


def make_lpips_loss(device="cuda") -> LPIPSLoss:
    """LPIPS with the AlexNet backbone (reference `lpips_loss.py`), on
    `device`."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    convs, lins, pretrained = _load_lpips_alex()
    return LPIPSLoss(convs, lins, pretrained).to(dev).eval()


def make_perceptual_loss(kind: str = "vgg", device="cuda") -> nn.Module:
    """`loss.perceptual_loss_type` "vgg" (VGG19 at '22') or "lpips"
    (reference `base.py:269-275`)."""
    if kind == "vgg":
        return make_vgg_loss("22", device=device)
    if kind == "lpips":
        return make_lpips_loss(device=device)
    raise ValueError(f"unknown perceptual_loss_type {kind!r}")
