"""Reconstruction metrics (MSE/"NMSE", PSNR, SSIM) and label-map entropy.

Counterpart of `medical_image_editing_tpu/ops/metrics.py` (reference:
torchmetrics 0.6.2 `MeanSquaredError` aliased NMSE, `PeakSignalNoiseRatio`,
`StructuralSimilarityIndexMeasure` with default arguments — the data range
inferred from the batch — and `scipy.stats.entropy(bincounts, base=2)` over
codebook ids). Inputs are NHWC tensors; results are 0-d f32 tensors on the
inputs' device.
"""

import torch
import torch.nn.functional as F


def nmse(pred, target):
    """Plain MSE — the reference's "NMSE" is `torchmetrics.MeanSquaredError`."""
    return torch.mean((pred.float() - target.float()) ** 2)


def psnr(pred, target, data_range=None):
    """10·log10(range²/MSE); default range = max − min of the target."""
    pred, target = pred.float(), target.float()
    if data_range is None:
        data_range = target.max() - target.min()
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range**2 / mse)


def _gaussian_kernel(size: int, sigma: float, device):
    coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred, target, data_range=None, kernel_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03):
    """Gaussian-window SSIM (11 taps, σ 1.5, no padding: only windows inside
    the image), torchmetrics 0.6.2 defaults. pred/target (B,H,W,C); the
    default data range is the larger of the two inputs' max − min."""
    pred, target = pred.float(), target.float()
    if data_range is None:
        data_range = torch.maximum(pred.max() - pred.min(), target.max() - target.min())
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    ch = pred.shape[-1]
    kern = _gaussian_kernel(kernel_size, sigma, pred.device)
    kern = kern[None, None].expand(ch, 1, kernel_size, kernel_size)

    def filt(x):  # depthwise, NHWC in, NCHW out
        return F.conv2d(x.permute(0, 3, 1, 2), kern, groups=ch)

    mu_p, mu_t = filt(pred), filt(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_pp = filt(pred * pred) - mu_pp
    sigma_tt = filt(target * target) - mu_tt
    sigma_pt = filt(pred * target) - mu_pt
    num = (2.0 * mu_pt + c1) * (2.0 * sigma_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sigma_pp + sigma_tt + c2)
    return torch.mean(num / den)


def label_entropy(ids, dict_size: int):
    """Base-2 entropy of codebook usage: counts of ids 1..dict_size (the ids
    carry the +1 background offset; the background bin 0 is dropped),
    normalised to a distribution; empty bins contribute 0."""
    ids = ids.reshape(-1).long()
    counts = torch.bincount(ids.clamp(0, dict_size + 1), minlength=dict_size + 2)
    counts = counts[1:dict_size + 1].float()
    p = counts / counts.sum().clamp_min(1.0)
    return -torch.sum(torch.where(p > 0, p * torch.log2(p.clamp_min(1e-30)), 0.0))
