"""Losses of the first-stage step.

Counterpart of `medical_image_editing_tpu/ops/losses.py`:
  embedding_loss       — reference `src/functions/embed_loss.py` (cross,
                         distance and regularisation terms);
  focal_frequency_loss — `focal-frequency-loss==0.3.0` as the reference
                         uses it, `FFL(loss_weight=1, alpha=1)`;
  hinge_d_loss, vanilla_d_loss, hinge_g_loss
                       — the second stage's GAN losses (reference
                         `src/functions/gan_loss.py`), layout-free means.
Layouts are NHWC like the JAX functions. The segmentation losses belong to
the multi-window trainer and are not ported yet (ROADMAP item 17).
"""

from typing import Tuple

import torch
import torch.nn.functional as F

_EPS = 1e-6  # EmbeddingLoss.epsilon, `embed_loss.py:8`


def embedding_cross_loss(embed, r_ids, codebook):
    """One direction of the augmentation-equivariance cross loss.

    embed (B,H,W,C) features of view A, r_ids (B,H,W,K) one-hot warped ids
    of the other view (background dropped), codebook (K,C) without gradient.
    Per (b,k): mean over the assigned locations of ‖e − c_k‖², expanded as
    ‖e‖² − 2·e·c_k + ‖c_k‖²; then the mean over the (b,k) pairs present."""
    b, c, k = embed.shape[0], embed.shape[-1], r_ids.shape[-1]
    e = embed.reshape(b, -1, c).float()
    r = r_ids.reshape(b, -1, k).float()
    cb = codebook.detach().float()
    counts = r.sum(1)                                     # (B,K)
    term_e = torch.einsum("bl,blk->bk", (e * e).sum(-1), r)
    term_x = torch.einsum("blk,blk->bk", torch.einsum("blc,kc->blk", e, cb), r)
    term_c = counts * (cb * cb).sum(-1)[None, :]
    cross = (term_e - 2.0 * term_x + term_c) / (counts + _EPS)
    present = counts > 0
    total = torch.where(present, cross, torch.zeros((), device=cross.device)).sum()
    return total / present.sum().clamp_min(1)


def embedding_distance_loss(codebook, margin):
    """Hinge pushing all centroid pairs ≥ 2·margin apart; the pair sum keeps
    the diagonal and divides by 2K(K−1), as the reference does."""
    cb = codebook.float()
    k = cb.shape[0]
    sq = (cb * cb).sum(1)
    d = (sq[:, None] + sq[None, :] - 2.0 * (cb @ cb.t())).clamp_min(0.0).sqrt()
    return ((2.0 * margin - d).clamp_min(0.0) ** 2).sum() / (2.0 * k * (k - 1))


def embedding_regularization_loss(codebook):
    """Mean L2 norm of the codebook vectors."""
    return torch.linalg.vector_norm(codebook.float(), dim=-1).mean()


def embedding_loss(embed_1, r_ids_1, embed_2, r_ids_2, codebook, *,
                   margin: float = 1.0, use_distance_loss: bool = True,
                   use_regularization_loss: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symmetric cross + distance + regularisation → (cross, dist, reg)."""
    l_cross = (embedding_cross_loss(embed_1, r_ids_2, codebook)
               + embedding_cross_loss(embed_2, r_ids_1, codebook))
    zero = torch.zeros((), device=codebook.device)
    l_dist = embedding_distance_loss(codebook, margin) if use_distance_loss else zero
    l_reg = embedding_regularization_loss(codebook) if use_regularization_loss else zero
    return l_cross, l_dist, l_reg


def focal_frequency_loss(pred, target, alpha: float = 1.0, log_matrix: bool = False):
    """Focal Frequency Loss (Jiang et al., ICCV'21), patch_factor 1, on
    (B,H,W,C): per sample and channel F = fft2(x, ortho), d = |F_p − F_t|²,
    weight (√d)^alpha over its maximum, clipped to [0,1], without gradient;
    loss = mean(w·d). Computed on the half spectrum (rfft2), with the
    interior columns counted twice, as the JAX function's default."""
    p = pred.permute(0, 3, 1, 2).float()
    t = target.permute(0, 3, 1, 2).float()
    h, w_full = p.shape[-2:]
    diff = torch.fft.rfft2(p, norm="ortho") - torch.fft.rfft2(t, norm="ortho")
    dist = diff.real**2 + diff.imag**2
    w = torch.sqrt(dist) ** alpha
    if log_matrix:
        w = torch.log(w + 1.0)
    wmax = w.amax((-2, -1), keepdim=True)
    w = torch.where(wmax > 0, w / wmax, torch.zeros((), device=w.device))
    w = torch.nan_to_num(w).clamp(0.0, 1.0).detach()
    ncols = dist.shape[-1]
    col = torch.arange(ncols, device=dist.device)
    mult = torch.where((col == 0) | ((w_full % 2 == 0) & (col == ncols - 1)), 1.0, 2.0)
    b, c = dist.shape[:2]
    return (w * dist * mult).sum() / (b * c * h * w_full)


def hinge_d_loss(logits_real, logits_fake):
    """Discriminator hinge: ½(mean relu(1 − D(real)) + mean relu(1 + D(fake)))."""
    return 0.5 * (torch.relu(1.0 - logits_real).mean() + torch.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    """Non-saturating discriminator loss: ½(mean softplus(−D(real)) +
    mean softplus(D(fake)))."""
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def hinge_g_loss(logits_fake):
    """Generator hinge: −mean D(fake)."""
    return -logits_fake.mean()
