"""Autoregressive prior over VQ code sequences (minGPT second stage).

Counterpart of `medical_image_editing_tpu/train/prior.py`: a causal
transformer trained on the first stage's id grids, then sampled to new id
grids that the decoder turns into images (`get_embed_from_ids`).

  * The step is teacher-forced next-token cross-entropy over the flattened
    (row-major) id grid: the input is `[sos, ids[:-1]]`, the target `ids`;
    the loss is the f32 log-softmax NLL mean, the accuracy the argmax hit
    rate. With `axis_name` the gradients and the metrics are averaged over
    the ranks (`parallel/mesh.py::pmean`) and each rank draws its dropout
    from its own generator (`train/state.py::per_rank_generator`, JAX's
    `per_device_keys`).
  * The optimizer is the JAX CLI's `optax.adamw(lr, weight_decay=0.01)`:
    `torch.optim.AdamW` with b1 0.9, b2 0.999, eps 1e-8 and every
    parameter decayed (biases, LayerNorms, embeddings and `pos_embed`
    included), not minGPT's parameter groups.
  * The sampler loops over the single-token KV-cache decode
    (`sample_token_step`) where JAX scans it; on the card the token step is
    one CUDA graph, replayed for each token. Each token is
    argmax(logits / temperature + gumbel), top-k keeping every logit ≥ the
    k-th largest; that is `jax.random.categorical`. The Gumbel noise comes
    from the caller's generator, or as an explicit (n_tokens, B, V) tensor.
"""

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..models.mingpt import GPT, GPTConfig, forward_with_past
from ..utils.device import resolve_device
from .first_stage import pmean_gradients, pmean_metrics, step_generator


@dataclass
class PriorTrainState:
    gpt: GPT
    opt: torch.optim.Optimizer
    generator: torch.Generator  # the dropout draws
    step: int = 0


def make_prior_optimizer(params, lr: float, weight_decay: float = 0.01) -> torch.optim.AdamW:
    """`optax.adamw(lr, weight_decay)` over every parameter."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def create_prior_state(seed: int, config: GPTConfig, *, lr: float = 3e-4,
                       weight_decay: float = 0.01, device="cuda") -> PriorTrainState:
    """A `GPT` with flax's initial values drawn from a generator seeded
    with `seed`, on `device`, its AdamW, and a dropout generator on the
    device seeded with `seed`."""
    dev = resolve_device(device)
    gpt = GPT(config).init_weights(torch.Generator().manual_seed(seed)).to(dev)
    return PriorTrainState(gpt, make_prior_optimizer(gpt.parameters(), lr, weight_decay),
                           torch.Generator(device=dev).manual_seed(seed))


def ids_to_sequence(ids: torch.Tensor, sos_token: int) -> torch.Tensor:
    """(B,H,W) id grid → (B, 1+H*W) int64 sequence with a start token.

    Row-major raster order, matching taming's `indices.view(B, -1)`."""
    b = ids.shape[0]
    flat = ids.reshape(b, -1).long()
    sos = torch.full((b, 1), sos_token, dtype=torch.long, device=ids.device)
    return torch.cat([sos, flat], dim=1)


def prior_loss(gpt: GPT, ids: torch.Tensor, sos_token: int,
               generator: Optional[torch.Generator] = None):
    """(loss, acc) of the teacher-forced forward on the id grids `ids`."""
    seq = ids_to_sequence(ids, sos_token)
    inp, tgt = seq[:, :-1], seq[:, 1:]
    logits = gpt(inp, generator)
    logp = F.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, tgt[..., None])[..., 0].mean()
    acc = (logits.argmax(-1) == tgt).float().mean()
    return loss, acc


def make_prior_train_step(*, sos_token: int, axis_name: Optional[str] = None):
    """Teacher-forced LM step over id grids: step(state, ids (B,H,W)) →
    (state, {"loss", "acc"}), the state's model and optimizer updated in
    place. `sos_token` should be `dict_size` (one past the last code id)
    with `vocab_size = dict_size + 1`."""

    def step_fn(state: PriorTrainState, ids: torch.Tensor):
        gpt, opt = state.gpt, state.opt
        gpt.train()
        opt.zero_grad(set_to_none=True)
        loss, acc = prior_loss(gpt, ids, sos_token, step_generator(state.generator, axis_name))
        loss.backward()
        if axis_name is not None:
            pmean_gradients(opt)
        opt.step()
        metrics = pmean_metrics({"loss": loss.detach(), "acc": acc}, axis_name)
        state.step += 1
        return state, metrics

    return step_fn


@torch.no_grad()
def sample_token_step(gpt: GPT, tok: torch.Tensor, caches: torch.Tensor, pos: torch.Tensor,
                      toks: torch.Tensor, gumbel: torch.Tensor, *, sos_token: int,
                      temperature: float = 1.0, top_k: Optional[int] = None) -> None:
    """One token of the sampler, in place: the cached decode of `tok`
    (B,1) at position `pos` ((1,) int64 on the device), the draw
    argmax(logits / temperature + gumbel[pos]) over the logits top-k keeps
    (every one ≥ the k-th largest), clipped into [0, sos_token), written to
    toks[pos] ((n_tokens, B)) and to `tok`; then pos + 1. Its shapes are
    static, so `make_prior_sampler` captures it in a CUDA graph."""
    logits, _ = forward_with_past(gpt, tok, caches, pos)
    logits = logits[:, 0, :].float() / temperature
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    g = gumbel.index_select(0, pos)[0]
    nxt = (logits + g).argmax(-1).clamp_(0, sos_token - 1)
    toks.index_copy_(0, pos, nxt[None])
    tok.copy_(nxt[:, None])
    pos.add_(1)


def make_prior_sampler(gpt: GPT, *, sos_token: int, grid_hw, temperature: float = 1.0,
                       top_k: Optional[int] = None, cache_dtype=None):
    """sample(batch, generator=None, gumbel=None) → (B,H,W) int32 ids.

    Runs the model in eval mode under `torch.no_grad()`. `gumbel` is the
    (H*W, B, V) noise of every token, else drawn at once from `generator`
    as JAX's `gumbel` draws it (−log(−log(u)), u uniform in [tiny, 1)).
    Sampled ids are clipped into [0, sos_token) so the decoder never sees
    the start token. `cache_dtype=torch.bfloat16` halves the KV cache.

    Each token is one `sample_token_step`. On a CUDA device that step is
    captured once in a CUDA graph and replayed for each token: run eagerly,
    as the CPU runs it, the loop waits on ~150 launches a token."""
    h, w = grid_hw
    n_tokens = h * w
    vocab = gpt.config.vocab_size
    if n_tokens > gpt.config.block_size:
        raise ValueError(f"grid {h}x{w} needs block_size >= {n_tokens}, "
                         f"got {gpt.config.block_size}")

    @torch.no_grad()
    def sample(batch: int, generator: Optional[torch.Generator] = None,
               gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        device = gpt.head.weight.device
        if gumbel is None:
            if generator is None:
                raise ValueError("the sampler needs a torch.Generator or explicit gumbel noise")
            tiny = torch.finfo(torch.float32).tiny
            u = torch.rand((n_tokens, batch, vocab), generator=generator, device=device)
            gumbel = -torch.log(-torch.log(u.clamp_min_(tiny)))
        gumbel = gumbel.to(device=device, dtype=torch.float32)
        gpt.eval()
        caches = gpt.init_cache(batch, dtype=cache_dtype or torch.float32)
        tok = torch.full((batch, 1), sos_token, dtype=torch.long, device=device)
        pos = torch.zeros(1, dtype=torch.long, device=device)
        toks = torch.empty((n_tokens, batch), dtype=torch.long, device=device)

        def step():
            sample_token_step(gpt, tok, caches, pos, toks, gumbel, sos_token=sos_token,
                              temperature=temperature, top_k=top_k)

        if device.type == "cuda":
            graph = _captured(step, (caches, tok, pos, toks), sos_token)
            for _ in range(n_tokens):
                graph.replay()
        else:
            for _ in range(n_tokens):
                step()
        return toks.t().reshape(batch, h, w).to(torch.int32)

    return sample


def _captured(step, state, sos_token: int) -> "torch.cuda.CUDAGraph":
    """`step` captured in a CUDA graph, after one eager warm-up call on a
    side stream (which captures require); `state` = (caches, tok, pos,
    toks), the buffers the step writes, put back to their start after the
    warm-up."""
    caches, tok, pos, toks = state
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    caches.zero_()
    tok.fill_(sos_token)
    pos.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph
