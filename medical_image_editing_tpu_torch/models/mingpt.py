"""minGPT: a causal transformer over VQ code sequences, with KV-cache decoding.

Counterpart of `medical_image_editing_tpu/models/mingpt.py` (reference
`src/networks/mingpt.py`, taming's minGPT): `GPTConfig`, pre-LN `Block`s of
`CausalSelfAttention` and a 4× exact-erf GELU MLP, token and learned
positional embeddings (`pos_embed` starts at zeros), a final LayerNorm and an
untied, bias-free head. LayerNorm eps is 1e-5 throughout. Parameters are
named with the reference's torch keys (`tok_embed`, `pos_embed`,
`blocks.{i}.ln1`, `.ln2`, `.att.{q,k,v,proj}`, `.mlp.0`, `.mlp.2`, `ln_f`,
`head`); `utils/weights.py::from_jax_gpt` maps the JAX package's flax tree
onto them.

The full forward masks attention causally (and opens the first
`n_unmasked` positions to each other, as the reference's mask does). In
training mode the embedding, attention and residual dropouts act, each
drawing its keep mask from the caller's `torch.Generator` (`dropout`); eval
mode drops nothing. Attention is plain `torch.matmul`, mask and `softmax`,
as the JAX package's is plain XLA einsums.

`forward_with_past` is the single-token decode: the KV cache is one
preallocated (n_layer, 2, B, n_head, block_size, head_dim) tensor
(`GPT.init_cache`), written in place at `pos`, and the query attends over
the whole block with the columns past `pos` at −inf, as JAX's does. Its
shapes are static and `pos` may be a device tensor, so that one step can be
captured in a CUDA graph and replayed (`train/prior.py`'s sampler). A
bfloat16 cache halves the decode's memory: k and v are stored in the
cache's dtype and read back cast up to the query's f32, as JAX's einsum
promotes them. The decode never drops.
"""

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

LN_EPS = 1e-5  # torch nn.LayerNorm's default; the JAX package sets it explicitly


class GPTConfig(NamedTuple):
    """Spec: `mingpt.py:15-31` (GPT1Config defaults)."""

    vocab_size: int
    block_size: int
    n_layer: int = 12
    n_head: int = 12
    n_embed: int = 768
    emb_pdrop: float = 0.1
    res_pdrop: float = 0.1
    att_pdrop: float = 0.1
    n_unmasked: int = 0


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator] = None,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flax `nn.Dropout(p)` in training: each element kept with probability
    1 − p and scaled by 1/(1 − p), the rest 0. The keep mask is `keep` when
    given, else drawn as uniform(`generator`) < 1 − p on x's device; p = 0
    returns x, p = 1 zeros."""
    if p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    if keep is None:
        if generator is None:
            raise ValueError("dropout in training needs a torch.Generator for its draws")
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def causal_mask(t: int, n_unmasked: int, device) -> torch.Tensor:
    """(t, t) bool: row attends to column where col ≤ row, and among the
    first `n_unmasked` positions everywhere (spec `:54-56`)."""
    mask = torch.ones(t, t, dtype=torch.bool, device=device).tril_()
    if n_unmasked > 0:
        mask[:n_unmasked, :n_unmasked] = True
    return mask


class CausalSelfAttention(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        c = config.n_embed
        self.config = config
        self.q = nn.Linear(c, c)
        self.k = nn.Linear(c, c)
        self.v = nn.Linear(c, c)
        self.proj = nn.Linear(c, c)

    def _heads(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        nh = self.config.n_head
        return lin(x).reshape(b, t, nh, c // nh).transpose(1, 2)  # (B,nh,T,hd)

    def forward(self, x, mask=None, generator=None, cache=None, pos=None):
        """x (B,T,C). With `cache` (2,B,nh,block,hd), `pos` (a (1,) int64
        tensor) and `mask` (block,) bool, the columns at or before `pos`:
        the single-token step (T = 1), k and v written into `cache` at `pos`.
        Otherwise `mask` (T,T) is the attention mask, and in training mode
        the attention and residual dropouts draw from `generator`."""
        b, t, c = x.shape
        hd = c // self.config.n_head
        q, k, v = self._heads(self.q, x), self._heads(self.k, x), self._heads(self.v, x)
        drop = self.training and cache is None
        if cache is not None:
            cache[0].index_copy_(2, pos, k.to(cache.dtype))
            cache[1].index_copy_(2, pos, v.to(cache.dtype))
            att = torch.matmul(q, cache[0].to(q.dtype).transpose(-2, -1)) / math.sqrt(hd)
            att = torch.softmax(att.masked_fill(~mask, float("-inf")), dim=-1)
            y = torch.matmul(att, cache[1].to(q.dtype))
        else:
            att = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(hd)
            att = att.masked_fill(~mask, float("-inf"))
            att = torch.softmax(att, dim=-1)
            if drop:
                att = dropout(att, self.config.att_pdrop, generator)
            y = torch.matmul(att, v)
        y = self.proj(y.transpose(1, 2).reshape(b, t, c))
        if drop:
            y = dropout(y, self.config.res_pdrop, generator)
        return y


class Block(nn.Module):
    """Pre-LN transformer block with a 4× GELU MLP. Spec: taming minGPT Block."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        c = config.n_embed
        self.config = config
        self.ln1 = nn.LayerNorm(c, eps=LN_EPS)
        self.ln2 = nn.LayerNorm(c, eps=LN_EPS)
        self.att = CausalSelfAttention(config)
        # exact erf GELU: torch nn.GELU() default (`mingpt.py:102`)
        self.mlp = nn.Sequential(nn.Linear(c, 4 * c), nn.GELU(), nn.Linear(4 * c, c))

    def forward(self, x, mask=None, generator=None, cache=None, pos=None):
        x = x + self.att(self.ln1(x), mask, generator, cache, pos)
        h = self.mlp(self.ln2(x))
        if self.training and cache is None:
            h = dropout(h, self.config.res_pdrop, generator)
        return x + h


class GPT(nn.Module):
    """Spec: `mingpt.py` GPT — token + learned positional embeddings, blocks,
    final LN, untied linear head. Built with flax's initial values drawn
    from a generator by `init_weights`."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        c = config.n_embed
        self.config = config
        self.tok_embed = nn.Embedding(config.vocab_size, c)
        self.pos_embed = nn.Parameter(torch.zeros(1, config.block_size, c))
        self.blocks = nn.ModuleList(Block(config) for _ in range(config.n_layer))
        self.ln_f = nn.LayerNorm(c, eps=LN_EPS)
        self.head = nn.Linear(c, config.vocab_size, bias=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "GPT":
        """flax's initial values, drawn from `generator` in module order:
        Dense kernels lecun-normal (truncated at ±2σ, σ = 1/√fan_in/0.8796),
        biases 0; the token embedding normal(0, 1/√n_embed); LayerNorms 1
        and 0; `pos_embed` 0."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                std = 1.0 / math.sqrt(m.in_features) / 0.87962566103423978
                w = torch.empty(m.weight.shape, device="cpu")
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                w = torch.randn(m.weight.shape, generator=generator, device="cpu")
                m.weight.copy_(w / math.sqrt(m.embedding_dim))
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.pos_embed.zero_()
        return self

    def forward(self, idx: torch.Tensor, generator: Optional[torch.Generator] = None,
                caches: Optional[torch.Tensor] = None, pos=None):
        """idx (B,T) → logits (B,T,V). With `caches` (from `init_cache`) and
        `pos` (an int, or a (1,) int64 tensor on the model's device): the
        single-token decode step (T = 1), which writes the caches in place
        and drops nothing."""
        cfg = self.config
        b, t = idx.shape
        tok = self.tok_embed(idx)
        if caches is not None:
            if not torch.is_tensor(pos):
                pos = torch.tensor([pos], device=idx.device)
            x = tok + self.pos_embed.index_select(1, pos)
            mask = torch.arange(cfg.block_size, device=idx.device) <= pos
            for i, block in enumerate(self.blocks):
                x = block(x, mask, cache=caches[i], pos=pos)
        else:
            x = tok + self.pos_embed[:, :t]
            if self.training:
                x = dropout(x, cfg.emb_pdrop, generator)
            mask = causal_mask(t, cfg.n_unmasked, idx.device)
            for block in self.blocks:
                x = block(x, mask, generator)
        return self.head(self.ln_f(x))

    def init_cache(self, batch: int, dtype=torch.float32) -> torch.Tensor:
        """The zeroed KV cache (n_layer, 2, B, n_head, block_size, head_dim)
        on the model's device."""
        cfg = self.config
        return torch.zeros(cfg.n_layer, 2, batch, cfg.n_head, cfg.block_size,
                           cfg.n_embed // cfg.n_head, dtype=dtype,
                           device=self.head.weight.device)


def forward_with_past(gpt: GPT, idx_t: torch.Tensor, caches: torch.Tensor, pos):
    """One decode step with the KV cache. Spec: `mingpt.py:195-224`
    (`forward_with_past`), on a static-shape cache.

    idx_t: (B,1) current token; caches: from `GPT.init_cache` or a previous
    step, written in place at `pos`; pos: current position, an int or a (1,)
    int64 tensor on the model's device. Returns (logits (B,1,V), caches)."""
    return gpt(idx_t, caches=caches, pos=pos), caches
