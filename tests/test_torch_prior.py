"""The autoregressive prior, port vs JAX package, on the CPU at the JAX
package's own test sizes (`tests/test_prior.py`): minGPT with 2 layers, 2
heads, `n_embed` 32 over a 4×4 id grid (block 16), `dict_size` 6 (vocab 7,
sos 6), batch 2.

Both sides start from the same flax-initialised parameters, carried by
`utils/weights.py::from_jax_gpt`, with `pos_emb` drawn non-zero from a
numpy seed (flax starts it at zeros, which would hide a position fault).
JAX runs under `default_matmul_precision("highest")`; its steps and
samplers are compiled once per file (module fixtures).

Tolerances (float32; readings on this suite's CPU host in brackets):
* the full forward, with `n_unmasked` 0 and 3, and the cached decode at
  every position against JAX's and against the port's own full forward:
  atol 1e-5 (forward ≤ 1.5e-6, decode ≤ 1.4e-6 from JAX's and 1.1e-6 from
  the full forward); the caches themselves atol 1e-5 (≤ 1.6e-6);
* a bfloat16 cache: within JAX's own 2e-2 of the f32 logits and of JAX's
  bf16 decode (`tests/test_prior.py:189-214`);
* three train steps at dropout 0 with `optax.adamw(1e-3,
  weight_decay=0.01)` against `torch.optim.AdamW`: losses rtol 1e-5
  (≤ 2.4e-7), accuracies exactly, every parameter after every step atol
  1e-5 = 1% of lr (≤ 1.5e-7) but the key biases. A key bias adds q·b to
  every score of a query row, which the softmax cancels: its gradient is 0
  in exact arithmetic, and each side's is rounding noise (held < 1e-6;
  read ≤ 7.9e-9), which Adam scales to about ±lr a step; those are held
  within 2·lr a step (read 8.1e-4, 1.2e-3, 1.6e-3 after steps 1-3);
* the sampler, given JAX's own Gumbel draws (the `split` chain of
  `make_prior_sampler` replayed, `jax.random.gumbel(k, (B, V))` a step,
  the replay first held bit for bit to JAX's compiled sampler): the
  port's tokens equal JAX's at every step up to the first whose top-two
  margin of `logits + g` in JAX is within MARGIN_TOL = 1e-4 (10× the
  logit tolerance) of a tie; every case here clears it (smallest margins
  printed; read ≥ 1.3e-2);
* two gloo ranks with one row of each batch against JAX's one-process
  steps on the whole batches: the same tolerances as the steps, the ranks' states
  bit for bit equal.
"""

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_prior_worker as worker
from medical_image_editing_tpu.models.mingpt import GPT as JGPT
from medical_image_editing_tpu.models.mingpt import GPTConfig as JGPTConfig
from medical_image_editing_tpu.models.mingpt import forward_with_past as j_forward_with_past
from medical_image_editing_tpu.train.prior import PriorTrainState as JPriorTrainState
from medical_image_editing_tpu.train.prior import make_prior_sampler as j_make_prior_sampler
from medical_image_editing_tpu.train.prior import make_prior_train_step as j_make_step
from medical_image_editing_tpu_torch.models.mingpt import (
    GPT,
    GPTConfig,
    dropout,
    forward_with_past,
)
from medical_image_editing_tpu_torch.train.prior import (
    PriorTrainState,
    ids_to_sequence,
    make_prior_optimizer,
    make_prior_sampler,
    make_prior_train_step,
)
from medical_image_editing_tpu_torch.utils.weights import from_jax_gpt

DICT = 6  # code ids 0..5, sos token 6
SOS = DICT
GRID = (4, 4)
B = 2
KW = dict(vocab_size=DICT + 1, block_size=GRID[0] * GRID[1], n_layer=2, n_head=2, n_embed=32,
          emb_pdrop=0.0, res_pdrop=0.0, att_pdrop=0.0)
ATOL = 1e-5
LR = 1e-3
STEPS = 3
MARGIN_TOL = 1e-4
WORLD = 2
TIMEOUT = 120  # seconds from the spawn to the ranks' exit


def _tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_params(seed=0):
    """flax's initial parameters, `pos_emb` drawn N(0, 0.3) from numpy."""
    gpt = JGPT(JGPTConfig(**KW))
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(lambda k: gpt.init({"params": k},
                                                jnp.zeros((1, KW["block_size"]), jnp.int32),
                                                False))(jax.random.key(seed))
    params = _tree(variables["params"])
    rng = np.random.default_rng(seed + 100)
    params["pos_emb"] = rng.normal(0, 0.3, params["pos_emb"].shape).astype(np.float32)
    return gpt, params


def port_gpt(params, n_unmasked=0, **kw):
    gpt = GPT(GPTConfig(**{**KW, **kw}, n_unmasked=n_unmasked))
    gpt.load_state_dict(from_jax_gpt(params), strict=True)
    return gpt.eval()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return jax_params()


def _batches(seed, n, rows):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, DICT, (rows,) + GRID).astype(np.int64) for _ in range(n)]


def jax_steps(params, batches):
    """JAX's jitted `make_prior_train_step` with `optax.adamw(LR, 0.01)`
    from `params`: [(loss, acc, params)] after each batch."""
    gpt = JGPT(JGPTConfig(**KW))
    tx = optax.adamw(LR, weight_decay=0.01)
    with jax.default_matmul_precision("highest"):
        state = JPriorTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.key(0),
                                 variables={"params": jax.tree.map(jnp.asarray, params)},
                                 opt_state=tx.init(params))
        step = jax.jit(j_make_step(gpt, tx, sos_token=SOS))
        out = []
        for ids in batches:
            state, m = step(state, jnp.asarray(ids, jnp.int32))
            out.append((float(m["loss"]), float(m["acc"]), _tree(state.variables["params"])))
    return out


BATCHES = _batches(5, STEPS, B)


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, model):
    """The port's step on WORLD gloo ranks, one row of each of BATCHES
    each, started with the file's first test so that it runs beside the
    others."""
    _, params = model
    work = tmp_path_factory.mktemp("prior_ranks")
    batches = BATCHES
    torch.save({"config": KW, "state_dict": from_jax_gpt(params), "lr": LR, "sos": SOS,
                "ids": [torch.from_numpy(b) for b in batches]}, work / "setup.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, WORLD, str(work / "init"), str(work)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT
    yield procs, work, batches, deadline
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()


def test_ids_to_sequence_layout():
    ids = torch.arange(16).reshape(1, 4, 4) % DICT
    seq = ids_to_sequence(ids, sos_token=SOS)
    assert seq.shape == (1, 17) and seq.dtype == torch.int64
    assert int(seq[0, 0]) == SOS
    np.testing.assert_array_equal(seq[0, 1:].numpy(), np.arange(16) % DICT)


@pytest.mark.parametrize("n_unmasked", [0, 3])
def test_gpt_forward_matches_jax(n_unmasked, model):
    _, params = model
    jgpt = JGPT(JGPTConfig(**KW, n_unmasked=n_unmasked))
    idx = np.random.default_rng(2).integers(0, DICT + 1, (B, KW["block_size"]))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jgpt.apply({"params": params}, jnp.asarray(idx, jnp.int32), False))
    with torch.no_grad():
        got = port_gpt(params, n_unmasked)(torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if n_unmasked:  # the prefix is open: position 0 sees token 2
        idx2 = idx.copy()
        idx2[:, 2] = (idx2[:, 2] + 1) % (DICT + 1)
        with torch.no_grad():
            moved = port_gpt(params, n_unmasked)(torch.from_numpy(idx2)).numpy()
        assert not np.allclose(moved[:, 0], got[:, 0])


def test_cached_decode_matches_jax_and_full_forward(model):
    jgpt, params = model
    idx = np.random.default_rng(3).integers(0, DICT + 1, (B, KW["block_size"]))
    gpt = port_gpt(params)
    with jax.default_matmul_precision("highest"):
        jstep = jax.jit(lambda c, t, i: j_forward_with_past(jgpt, {"params": params}, t, c, i))
        jcaches, want = jgpt.init_cache(B), []
        for t in range(idx.shape[1]):
            logits, jcaches = jstep(jcaches, jnp.asarray(idx[:, t:t + 1], jnp.int32), t)
            want.append(np.asarray(logits)[:, 0])
    with torch.no_grad():
        full = gpt(torch.from_numpy(idx)).numpy()
        caches, got = gpt.init_cache(B), []
        for t in range(idx.shape[1]):
            logits, caches = forward_with_past(gpt, torch.from_numpy(idx[:, t:t + 1]), caches, t)
            got.append(logits.numpy()[:, 0])
    want, got = np.stack(want, 1), np.stack(got, 1)
    assert caches.shape == (2, 2, B, 2, KW["block_size"], 16)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, full, atol=ATOL, rtol=0)
    np.testing.assert_allclose(caches.numpy(), np.asarray(jcaches), atol=ATOL, rtol=0)


def test_cached_decode_bf16_cache(model):
    jgpt, params = model
    gpt = port_gpt(params)
    tok = np.full((1, 1), SOS)
    with jax.default_matmul_precision("highest"):
        j16, jc16 = jax.jit(lambda c: j_forward_with_past(
            jgpt, {"params": params}, jnp.asarray(tok, jnp.int32), c, 0))(
                jgpt.init_cache(1, dtype=jnp.bfloat16))
    with torch.no_grad():
        l32, _ = forward_with_past(gpt, torch.from_numpy(tok), gpt.init_cache(1), 0)
        l16, c16 = forward_with_past(gpt, torch.from_numpy(tok),
                                     gpt.init_cache(1, dtype=torch.bfloat16), 0)
    assert c16.dtype == torch.bfloat16 and jc16.dtype == jnp.bfloat16
    np.testing.assert_allclose(l16.numpy(), l32.numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(l16.numpy(), np.asarray(j16), rtol=2e-2, atol=2e-2)
    ids = make_prior_sampler(gpt, sos_token=SOS, grid_hw=GRID, cache_dtype=torch.bfloat16)(
        B, generator=torch.Generator().manual_seed(1))
    assert ids.shape == (B, *GRID) and 0 <= int(ids.min()) and int(ids.max()) < DICT


@pytest.fixture(scope="module")
def jax_reference(model):
    """JAX's three steps on BATCHES: [(loss, acc, params)]."""
    return jax_steps(model[1], BATCHES)


@pytest.fixture(scope="module")
def steps(model, jax_reference):
    """Three steps on each side from the same parameters and batches:
    (JAX's [(loss, acc, params)], the port's [(loss, acc, state dict,
    key-bias gradients)])."""
    _, params = model
    batches = BATCHES
    want = jax_reference
    gpt = port_gpt(params)
    state = PriorTrainState(gpt, make_prior_optimizer(gpt.parameters(), LR),
                            torch.Generator().manual_seed(0))
    step = make_prior_train_step(sos_token=SOS)
    got = []
    for ids in batches:
        state, m = step(state, torch.from_numpy(ids))
        grads = [float(b.att.k.bias.grad.abs().max()) for b in gpt.blocks]
        got.append((float(m["loss"]), float(m["acc"]),
                    {k: v.clone() for k, v in gpt.state_dict().items()}, grads))
    assert state.step == STEPS
    return want, got


def test_train_step_loss_and_accuracy_match_jax(steps):
    want, got = steps
    for (wl, wa, _), (gl, ga, _, _) in zip(want, got):
        np.testing.assert_allclose(gl, wl, rtol=1e-5)
        assert ga == wa


def _key_bias(name):
    return name.endswith("att.k.bias")


def _hold_params(got_sd, want_params, steps_taken):
    want_sd = from_jax_gpt(want_params)
    assert sorted(got_sd) == sorted(want_sd)
    for name, want in want_sd.items():
        atol = 2 * LR * steps_taken if _key_bias(name) else ATOL
        np.testing.assert_allclose(got_sd[name].numpy(), want.numpy(), atol=atol, rtol=0,
                                   err_msg=name)


def test_train_step_parameters_match_jax(steps):
    want, got = steps
    for i, ((_, _, wp), (_, _, sd, grads)) in enumerate(zip(want, got)):
        _hold_params(sd, wp, i + 1)
        assert max(grads) < 1e-6, grads  # the key biases' gradients: rounding noise


def test_dropout_contract():
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    keep = torch.rand(4, 8, generator=torch.Generator().manual_seed(1)) < 0.7
    np.testing.assert_array_equal(dropout(x, 0.3, keep=keep).numpy(),
                                  torch.where(keep, x / 0.7, torch.zeros(())).numpy())
    assert dropout(x, 0.0) is x
    assert not dropout(x, 1.0).any()
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.3)
    drawn = dropout(torch.ones(1000, 100), 0.3, torch.Generator().manual_seed(2))
    assert abs(float((drawn == 0).float().mean()) - 0.3) < 0.01
    assert torch.allclose(drawn[drawn != 0], torch.tensor(1 / 0.7))


def test_gpt_dropout_acts_in_training_only(model):
    _, params = model
    idx = torch.from_numpy(np.random.default_rng(4).integers(0, DICT + 1, (B, 16)))
    plain = port_gpt(params)
    dropped = port_gpt(params, emb_pdrop=0.5, res_pdrop=0.5, att_pdrop=0.5)
    with torch.no_grad():
        ref = plain(idx)
        assert torch.equal(dropped.eval()(idx), ref)  # eval mode drops nothing
        dropped.train()
        a = dropped(idx, torch.Generator().manual_seed(3))
        b = dropped(idx, torch.Generator().manual_seed(3))
        c = dropped(idx, torch.Generator().manual_seed(4))
        with pytest.raises(ValueError, match="Generator"):
            dropped(idx)
        # the decode never drops, in either mode
        step, _ = forward_with_past(dropped, idx[:, :1], dropped.init_cache(B), 0)
    assert torch.equal(a, b) and not torch.allclose(a, ref) and not torch.allclose(a, c)
    np.testing.assert_allclose(step.numpy()[:, 0], ref.numpy()[:, 0], atol=ATOL, rtol=0)


SAMPLER_CASES = {
    "plain": dict(temperature=1.0, top_k=None),
    "temperature": dict(temperature=0.5, top_k=None),
    "top_k": dict(temperature=1.0, top_k=2),
    "top_k_ties": dict(temperature=1.0, top_k=2),
    "clip_at_sos": dict(temperature=1.0, top_k=None),
}


def _sampler_params(case, params):
    """The head scaled ×3 (logits of a few units: the logits steer the
    draws, not the noise alone), and for two cases some logits lifted by
    30: with the final LayerNorm's bias at 1/C its output sums to 1 over the
    C features (its normalised part sums to 0), so adding 8 to every entry
    of a head column adds 30 to that logit. "top_k_ties": columns 0-2 equal
    and lifted, three logits tied at the top, all of which top-2 keeps;
    "clip_at_sos": the sos column lifted, so the draw is sos, clipped to
    sos − 1."""
    params = jax.tree.map(np.copy, params)
    head = params["head"]["kernel"]  # (C, V)
    head *= 3.0
    lift = {"top_k_ties": [0, 1, 2], "clip_at_sos": [SOS]}.get(case)
    if lift:
        params["ln_f"]["bias"][:] = 1.0 / head.shape[0]
        if case == "top_k_ties":
            head[:, 0:3] = head[:, :1]
        head[:, lift] += 30.0
    return params


@functools.cache
def _jax_sampling(config, grid, temperature, top_k):
    """JAX's compiled sampler and decode step for a `GPTConfig` (sos is
    the last token of the vocabulary)."""
    jgpt = JGPT(config)
    sampler = jax.jit(j_make_prior_sampler(jgpt, sos_token=config.vocab_size - 1, grid_hw=grid,
                                           temperature=temperature, top_k=top_k),
                      static_argnums=2)
    step = jax.jit(lambda p, c, t, i: j_forward_with_past(jgpt, {"params": p}, t, c, i))
    return jgpt, sampler, step


def jax_sample_replay(config, params, key, *, grid, batch, temperature=1.0, top_k=None):
    """JAX's compiled sampler's tokens, and its body replayed step by step:
    the same `split` chain and Gumbel draws, the tokens (held equal to the
    compiled sampler's by the callers) and the top-two margins of
    logits + g. Returns (compiled, replay, gumbel (H*W, B, V), margins
    (B, H*W))."""
    jgpt, sampler, step = _jax_sampling(config, grid, temperature, top_k)
    sos = config.vocab_size - 1
    compiled = np.asarray(sampler({"params": params}, key, batch))
    caches = jgpt.init_cache(batch)
    tok = jnp.full((batch, 1), sos, jnp.int32)
    gumbel, margins, toks = [], [], []
    for i in range(grid[0] * grid[1]):
        logits, caches = step(params, caches, tok, i)
        logits = logits[:, 0].astype(jnp.float32) / temperature
        if top_k is not None:
            kth = jnp.sort(logits, axis=-1)[:, -top_k][:, None]
            logits = jnp.where(logits < kth, -jnp.inf, logits)
        key, k = jax.random.split(key)
        g = jax.random.gumbel(k, (batch, config.vocab_size), jnp.float32)
        z = np.sort(np.asarray(logits + g), axis=-1)
        margins.append(z[:, -1] - z[:, -2])
        nxt = jnp.clip(jnp.argmax(logits + g, axis=-1), 0, sos - 1).astype(jnp.int32)
        toks.append(np.asarray(nxt))
        gumbel.append(np.asarray(g))
        tok = nxt[:, None]
    replay = np.stack(toks, 1).reshape(batch, *grid)
    return compiled, replay, np.stack(gumbel), np.stack(margins, 1)


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sampler_matches_jax_given_its_gumbel_draws(case, model):
    params = _sampler_params(case, model[1])
    kw = SAMPLER_CASES[case]
    with jax.default_matmul_precision("highest"):
        compiled, replay, gumbel, margins = jax_sample_replay(
            JGPTConfig(**KW), params, jax.random.key(5), grid=GRID, batch=B, **kw)
    np.testing.assert_array_equal(replay, compiled)
    got = make_prior_sampler(port_gpt(params), sos_token=SOS, grid_hw=GRID, **kw)(
        B, gumbel=torch.from_numpy(gumbel)).numpy()
    assert got.dtype == np.int32 and got.shape == (B, *GRID)
    # compare up to the first step at a near-tie (none at these seeds)
    clear = np.cumprod(margins.min(0) > MARGIN_TOL).astype(bool)
    print(f"{case}: smallest margin {margins.min():.3e}, steps clear {int(clear.sum())}")
    assert clear.all()
    np.testing.assert_array_equal(got.reshape(B, -1)[:, clear], compiled.reshape(B, -1)[:, clear])
    if case == "top_k_ties":  # top-2 keeps the three tied logits, and nothing else
        assert set(np.unique(got)) == {0, 1, 2}
    if case == "clip_at_sos":  # the drawn sos comes out as sos − 1
        assert (got == SOS - 1).mean() > 0.5
    if case == "top_k":  # the restriction changed some draw against the plain sampler
        plain = make_prior_sampler(port_gpt(params), sos_token=SOS, grid_hw=GRID)(
            B, gumbel=torch.from_numpy(gumbel)).numpy()
        assert not np.array_equal(plain, got)


def test_sampler_draws_from_its_generator(model):
    _, params = model
    sample = make_prior_sampler(port_gpt(params), sos_token=SOS, grid_hw=GRID, top_k=3)
    a = sample(3, generator=torch.Generator().manual_seed(7))
    b = sample(3, generator=torch.Generator().manual_seed(7))
    c = sample(3, generator=torch.Generator().manual_seed(8))
    assert a.shape == (3, *GRID) and a.dtype == torch.int32
    assert 0 <= int(a.min()) and int(a.max()) < DICT
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        sample(3)
    with pytest.raises(ValueError, match="block_size"):
        make_prior_sampler(port_gpt(params), sos_token=SOS, grid_hw=(5, 4))


def test_data_parallel_step_matches_jax(ranks, jax_reference):
    procs, work, batches, deadline = ranks
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    assert not any(p.is_alive() for p in procs), f"ranks still running after {TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    outs = [torch.load(os.path.join(work, f"rank-{r}.pt"), weights_only=True)
            for r in range(WORLD)]
    want = jax_reference
    # one all-reduce of the gradients and one of the metrics a step
    assert all(o["all_reduces"] == 2 * len(batches) for o in outs)
    for i, (wl, wa, wp) in enumerate(want):
        for o in outs:
            np.testing.assert_allclose(o["metrics"][i]["loss"], wl, rtol=1e-5)
            np.testing.assert_allclose(o["metrics"][i]["acc"], wa, rtol=1e-6)
            _hold_params(o["params"][i], wp, i + 1)
        for k, v in outs[0]["params"][i].items():
            assert torch.equal(v, outs[1]["params"][i][k]), k
