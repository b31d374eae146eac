"""Glow-style ActNorm: a per-channel affine with data-dependent
initialization, NCHW.

Counterpart of `medical_image_editing_tpu/models/actnorm.py` (reference
`src/networks/actnorm.py`, from taming-transformers). The parameters `loc`
and `scale` ((1,C,1,1), the reference's shapes) start at 0 and 1. The
first train-mode forward captures −mean and 1/(std + 1e-6) over (N, H, W)
into the buffers `data_loc` and `data_scale` and sets `initialized`, as the
JAX module keeps them in its 'actnorm' collection: the effective affine is
(loc + data_loc, scale · data_scale), the captured statistics outside the
gradient. The capture is a `torch.where` on `initialized`, so it never
syncs the host, and it binds new tensors to the buffers rather than
writing in place, so forwards that share one backward keep theirs. A
reference checkpoint stores the folded values under `loc`, `scale` and
`initialized` only: loading one fills `data_loc` with 0 and `data_scale`
with 1. `reverse` inverts the transform; `logdet` returns H·W·Σ log|scale|
per sample beside the output. A 2-D input (N, C) is taken as (N, C, 1, 1).

With `axis_name` (`parallel.DATA_AXIS`, as the JAX module's) the captured
statistics are this rank's mean and this rank's std each averaged over the
ranks (one all-reduce a train-mode forward, as JAX computes them on every
one): not the std of the whole batch, as in JAX.
"""

import torch
from torch import nn

from ..parallel.mesh import pmean


class ActNorm(nn.Module):
    def __init__(self, num_features: int, logdet: bool = False, axis_name=None):
        super().__init__()
        self.logdet = logdet
        self.axis_name = axis_name
        shape = (1, num_features, 1, 1)
        self.loc = nn.Parameter(torch.zeros(shape))
        self.scale = nn.Parameter(torch.ones(shape))
        self.register_buffer("initialized", torch.tensor(0, dtype=torch.uint8))
        self.register_buffer("data_loc", torch.zeros(shape))
        self.register_buffer("data_scale", torch.ones(shape))

    @torch.no_grad()
    def reset_parameters(self):
        self.loc.zero_()
        self.scale.fill_(1.0)
        self.initialized.zero_()
        self.data_loc.zero_()
        self.data_scale.fill_(1.0)

    @torch.no_grad()
    def _capture(self, x):
        mean = x.mean((0, 2, 3), keepdim=True)
        std = x.std((0, 2, 3), correction=0, keepdim=True)
        if self.axis_name is not None:
            mean, std = pmean([mean, std])
        first = self.initialized == 0
        # new tensors, not in-place writes: an earlier forward's graph may
        # hold the old ones (several forwards share one backward)
        self.data_loc = torch.where(first, -mean, self.data_loc)
        self.data_scale = torch.where(first, 1.0 / (std + 1e-6), self.data_scale)
        self.initialized.fill_(1)

    def forward(self, x, reverse: bool = False):
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, :, None, None]
        if self.training:
            self._capture(x.detach())
        loc = self.loc + self.data_loc
        scale = self.scale * self.data_scale
        h = x / scale - loc if reverse else scale * (x + loc)
        if squeeze:
            h = h[:, :, 0, 0]
        if self.logdet and not reverse:
            ld = x.shape[2] * x.shape[3] * torch.log(scale.abs()).sum()
            return h, ld * torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
        return h

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name, fill in (("data_loc", 0.0), ("data_scale", 1.0)):
            if prefix + "loc" in state_dict and prefix + name not in state_dict:
                state_dict[prefix + name] = torch.full_like(getattr(self, name), fill)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
