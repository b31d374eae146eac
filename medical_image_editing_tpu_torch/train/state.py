"""Train state and optimizers.

Counterpart of `medical_image_editing_tpu/train/state.py` (reference: the
Lightning module's state and its Adam optimizers, `src/trainers/base.py:
164-183`). The JAX package's optax chain (`add_decayed_weights` before
`scale_by_adam(eps=1e-8)`, then `scale(-lr)`) is `torch.optim.Adam`: weight
decay added to the gradient before the moments, the same bias-corrected
update. The JAX `TrainState` pytree becomes `TrainState` holding the
modules (their parameters, the decoder's BatchNorm running stats and the
encoder's codebook buffers), the two optimizers, the generator the step
draws from, and the step and epoch counts; the second stage and the
multi-window joint step add the discriminator (its parameters,
spectral-norm vectors and BatchNorm or ActNorm stats) and its Adam: a
joint state holds all three modules and three Adams. A VQGAN state holds
the whole autoencoder with its codebook in the decoder slot, as the JAX
package keeps it in `dec_vars`, its Adam in `dec_opt`, the discriminator
and its Adam, and no encoder (`encoder` and `enc_opt` are None; the JAX
state's `enc_vars` are empty). `state_dict`/`load_state_dict` cover all
of it, for `utils/checkpoint.py`; a first-stage state and its checkpoints
carry no discriminator.

Under a process group the state is replicated: every rank holds the same
modules, optimizers and generator (`replicate_state`), and
`per_rank_generator` gives each rank its own draws for a step from that
shared generator, as JAX's `per_device_keys` folds the device index into
the replicated key.
"""

import hashlib
from dataclasses import dataclass
from typing import Iterable, Optional

import torch
from torch import nn

from ..ops.vq import VQState
from ..parallel.mesh import digest, replicate
from ..utils.config import getattr_else_none as g


def make_optimizer(params: Iterable[torch.Tensor], lr: float, b1: float = 0.9,
                   b2: float = 0.999, weight_decay: float = 0.0) -> torch.optim.Adam:
    """Adam with eps 1e-8 and L2 weight decay added to the gradient."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8,
                            weight_decay=weight_decay)


def make_optimizer_from_config(params, optim_cfg) -> torch.optim.Adam:
    """`make_optimizer` from a config section (`lr`, optional `b1`, `b2`,
    `weight_decay`)."""
    return make_optimizer(
        params,
        lr=float(optim_cfg.lr),
        b1=float(g(optim_cfg, "b1", 0.9)),
        b2=float(g(optim_cfg, "b2", 0.999)),
        weight_decay=float(g(optim_cfg, "weight_decay", 0.0) or 0.0),
    )


@dataclass
class TrainState:
    encoder: Optional[nn.Module]  # EncoderWithVQ: parameters + codebook buffers
    decoder: nn.Module          # UNetDecoder (parameters + BatchNorm stats) or VQGAN
    enc_opt: Optional[torch.optim.Optimizer]
    dec_opt: torch.optim.Optimizer
    generator: torch.Generator  # augmentation and CutMix draws, k-means seeding
    step: int = 0
    epoch: int = 0
    discriminator: Optional[nn.Module] = None   # the second stage's and joint step's
    dis_opt: Optional[torch.optim.Optimizer] = None

    @property
    def codebook_owner(self) -> nn.Module:
        """The module holding the codebook: the encoder, or the VQGAN."""
        return self.decoder if self.encoder is None else self.encoder

    @property
    def vq(self) -> VQState:
        return self.codebook_owner.vq.state()

    @property
    def device(self) -> torch.device:
        return self.codebook_owner.vq.embed.device

    def state_dict(self) -> dict:
        """The modules (parameters, BatchNorm stats, the codebook buffers,
        spectral-norm vectors), their Adam states, the generator's state,
        step and epoch."""
        modules = {"encoder": self.encoder, "decoder": self.decoder}
        opts = {"enc_opt": self.enc_opt, "dec_opt": self.dec_opt}
        sd = {k: m.state_dict() for k, m in {**modules, **opts}.items() if m is not None}
        sd.update(generator=self.generator.get_state(), step=int(self.step),
                  epoch=int(self.epoch))
        if self.discriminator is not None:
            sd["discriminator"] = self.discriminator.state_dict()
            sd["dis_opt"] = self.dis_opt.state_dict()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Load a `state_dict()` (tensors on any device) in place. The
        generator's state and Adam's step counters stay on the host, where
        `torch.Generator.set_state` and the non-capturable Adam keep them.
        A state with a discriminator needs one in `sd`; a state without
        one takes the rest of a second-stage `sd` (its models, e.g. to
        test or export them)."""
        self.decoder.load_state_dict(sd["decoder"], strict=True)
        opts = [(self.dec_opt, sd["dec_opt"])]
        if self.encoder is not None:
            self.encoder.load_state_dict(sd["encoder"], strict=True)
            opts.append((self.enc_opt, sd["enc_opt"]))
        if self.discriminator is not None:
            if "discriminator" not in sd:
                raise KeyError("this state has a discriminator and the state dict has "
                               "none (a first-stage checkpoint cannot resume a second stage)")
            self.discriminator.load_state_dict(sd["discriminator"], strict=True)
            opts.append((self.dis_opt, sd["dis_opt"]))
        for opt, osd in opts:
            opt.load_state_dict(osd)
            for s in opt.state.values():
                if isinstance(s.get("step"), torch.Tensor):
                    s["step"] = s["step"].cpu()
        self.generator.set_state(sd["generator"].cpu())
        self.step = int(sd["step"])
        self.epoch = int(sd["epoch"])


def create_train_state(encoder: Optional[nn.Module], decoder: nn.Module, enc_opt, dec_opt, *,
                       seed: int = 0, device="cuda", discriminator: Optional[nn.Module] = None,
                       dis_opt=None) -> TrainState:
    """Modules already on `device`; the generator is seeded with `seed` on it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return TrainState(encoder, decoder, enc_opt, dec_opt, gen,
                      discriminator=discriminator, dis_opt=dis_opt)


def per_rank_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """A generator for one rank's draws of one step, on `generator`'s
    device: seeded from `generator`'s state (the ranks' replicated stream)
    and `rank`, as JAX's `per_device_keys` folds the device index into the
    replicated key. `generator` then moves on by one draw, alike on every
    rank, so that it stays replicated, and a checkpoint of rank 0's state
    resumes every rank. Reads the state on the host: no device sync."""
    key = generator.get_state().cpu().numpy().tobytes()
    torch.rand((), generator=generator, device=generator.device)
    seed = hashlib.blake2b(key + int(rank).to_bytes(4, "little"), digest_size=8).digest()
    return torch.Generator(device=generator.device).manual_seed(
        int.from_bytes(seed, "little") >> 1)


def replicate_state(state: TrainState) -> TrainState:
    """Make every rank hold rank 0's state (JAX `replicate`): the modules'
    parameters and buffers and the optimizers' moments broadcast from rank
    0; step, epoch, the Adam step counts and the generator's state checked
    equal on every rank (they are: the same seeds, or one checkpoint).
    Nothing without a process group."""
    modules = [m for m in (state.encoder, state.decoder, state.discriminator) if m is not None]
    opts = [o for o in (state.enc_opt, state.dec_opt, state.dis_opt) if o is not None]
    tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
    steps = []
    for opt in opts:
        for group in opt.param_groups:
            for p in group["params"]:
                for k, v in opt.state.get(p, {}).items():
                    if k == "step":
                        steps.append(int(v))
                    elif isinstance(v, torch.Tensor):
                        tensors.append(v)
    replicate(tensors, [state.step, state.epoch, len(steps), sum(steps),
                        digest(state.generator.get_state())], device=state.device)
    return state
