"""Port losses, k-means, Adam, train-mode BatchNorm and configs vs the JAX
package, on the CPU.

Inputs are drawn with numpy and handed to both sides. Tolerances (f32):
losses rtol 1e-5 and their gradients atol 1e-6 (the same arithmetic, summed
in other orders; the cross loss divides by per-code counts); k-means
centres atol 1e-5 after 20 Lloyd iterations from the same start rows
(JAX's `jax.random.choice` replayed); one Adam step atol 1e-7 (elementwise
arithmetic, one rounding apart); train-mode StyledDenorm outputs atol 1e-4
and running stats atol 1e-6 (flax's fast variance in both).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medical_image_editing_tpu.models import blocks as jb
from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ as JEncoder
from medical_image_editing_tpu.models.unet_encoder import (
    init_codebook_from_batch as j_init_codebook,
)
from medical_image_editing_tpu.ops.kmeans import kmeans as j_kmeans
from medical_image_editing_tpu.ops import losses as jl
from medical_image_editing_tpu.ops import vq as jvq
from medical_image_editing_tpu.train import first_stage as jfs
from medical_image_editing_tpu.train import state as jstate
from medical_image_editing_tpu.utils import config as jconfig
from medical_image_editing_tpu_torch.models import blocks as tb
from medical_image_editing_tpu_torch.models.unet_encoder import (
    EncoderWithVQ,
    encode_quantize,
    init_codebook_from_batch,
)
from medical_image_editing_tpu_torch.ops import kmeans as tkm
from medical_image_editing_tpu_torch.ops import losses as tl
from medical_image_editing_tpu_torch.ops import vq as tvq
from medical_image_editing_tpu_torch.train import first_stage as tfs
from medical_image_editing_tpu_torch.train import state as tstate
from medical_image_editing_tpu_torch.utils import config as tconfig
from medical_image_editing_tpu_torch.utils import weights as bridge
from test_torch_port_models import ENC, DICT, jax_encoder

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def _embedding_inputs(seed=0, b=2, h=6, w=5, c=4, k=5):
    rng = np.random.default_rng(seed)
    e1, e2 = (rng.normal(size=(b, h, w, c)).astype(np.float32) for _ in range(2))
    ids = rng.integers(0, k + 1, size=(2, b, h, w))
    ids[0, 1] = np.where(ids[0, 1] == 3, 0, ids[0, 1])  # a code absent from one sample
    oh = np.eye(k + 1, dtype=np.float32)[ids][..., 1:]
    cb = rng.normal(size=(k, c)).astype(np.float32) * 0.5
    return e1, oh[0], e2, oh[1], cb


@pytest.mark.parametrize("dist,reg", [(True, True), (False, False)])
def test_embedding_loss_and_grads_match_jax(dist, reg):
    e1, r1, e2, r2, cb = _embedding_inputs()
    kw = dict(margin=1.0, use_distance_loss=dist, use_regularization_loss=reg)

    def jtotal(a, b):
        return sum(jl.embedding_loss(a, r1, b, r2, cb, **kw))

    # the step differentiates the embeddings only: the codebook is EMA state
    want = jl.embedding_loss(*map(jnp.asarray, (e1, r1, e2, r2, cb)), **kw)
    gj = jax.grad(jtotal, argnums=(0, 1))(jnp.asarray(e1), jnp.asarray(e2))
    t1, t2 = (torch.from_numpy(a).requires_grad_() for a in (e1, e2))
    got = tl.embedding_loss(t1, torch.from_numpy(r1), t2, torch.from_numpy(r2),
                            torch.from_numpy(cb), **kw)
    sum(got).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5, atol=1e-7)
    for t, g in zip((t1, t2), gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-6, rtol=0)


@pytest.mark.parametrize("width", [16, 15])
def test_focal_frequency_loss_and_grad_match_jax(width):
    rng = np.random.default_rng(1)
    p = rng.uniform(-1, 1, size=(2, 12, width, 1)).astype(np.float32)
    t = rng.uniform(-1, 1, size=(2, 12, width, 1)).astype(np.float32)
    want, gj = jax.value_and_grad(jl.focal_frequency_loss)(jnp.asarray(p), jnp.asarray(t))
    full = jl.focal_frequency_loss(jnp.asarray(p), jnp.asarray(t), use_rfft=False)
    pt = torch.from_numpy(p).requires_grad_()
    got = tl.focal_frequency_loss(pt, torch.from_numpy(t))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got.detach()), float(full), rtol=1e-5)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gj), atol=1e-6, rtol=0)


def test_kmeans_matches_jax_with_replayed_start():
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(6, 4)) * 3
    x = (centers[rng.integers(0, 6, 600)] + rng.normal(size=(600, 4))).astype(np.float32)
    key = jax.random.key(3)
    jids, jc = j_kmeans(key, jnp.asarray(x), 6, num_iters=20)
    idx = np.array(jax.random.choice(key, 600, (6,), replace=False))
    ids, c = tkm.kmeans(torch.from_numpy(x), 6, num_iters=20, init_idx=torch.from_numpy(idx))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    # drawn from a generator instead: K distinct rows, reproducibly
    a = tkm.kmeans(torch.from_numpy(x), 6, 3, generator=torch.Generator().manual_seed(0))
    b = tkm.kmeans(torch.from_numpy(x), 6, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a[1], b[1])


def test_init_codebook_from_batch_matches_jax():
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    vq = jvq.vq_init(jax.random.key(0), 5, 4)
    key = jax.random.key(5)
    want = j_init_codebook(key, jnp.asarray(feats), vq, num_iters=10)
    idx = np.array(jax.random.choice(key, 128, (5,), replace=False))
    got = init_codebook_from_batch(torch.from_numpy(feats),
                                   tvq.VQState(*(torch.from_numpy(np.array(a)) for a in vq)),
                                   num_iters=10, init_idx=torch.from_numpy(idx))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_step_matches_optax(weight_decay):
    rng = np.random.default_rng(6)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = jstate.make_optimizer(1e-2, b1=0.8, b2=0.99, weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = tstate.make_optimizer(tp.values(), 1e-2, b1=0.8, b2=0.99, weight_decay=weight_decay)
    for g in grads:
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-7,
                                   rtol=1e-6)


def test_optimizer_and_loss_config_from_json_match_jax():
    path = os.path.join(CONFIGS, "lung_first_stage.json")
    jcfg, tcfg = jconfig.load_json(path), tconfig.load_json(path)
    assert tfs.loss_config_from_json(tcfg.loss)._asdict() == \
        jfs.loss_config_from_json(jcfg.loss)._asdict()
    opt = tstate.make_optimizer_from_config([torch.zeros(1, requires_grad=True)],
                                            tcfg.dis_optim)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == \
        (0.0004, (0.5, 0.999), 1e-8, 0.0)
    # the False→None quirk
    assert tcfg.model.vqmodel.use_dropblock is None
    assert tconfig.getattr_else_none(tcfg.model.vqmodel, "missing", 3) == 3


def _styled_denorm(seed, dtype=None):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(3, 8, 8, 6)) * 1.5 + 0.7).astype(np.float32)
    style = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    jm = jb.StyledDenorm(6, dtype=dtype)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(seed), x, style, train=False))
    v["batch_stats"] = {"BatchNorm_0": {"mean": rng.normal(size=6).astype(np.float32),
                                        "var": rng.uniform(0.5, 2, 6).astype(np.float32)}}
    sd = {}
    bridge._styled_denorm(sd, "m", v["params"], v["batch_stats"])
    tm = tb.StyledDenorm(6, 4)
    tm.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    return jm, v, tm, x, style


def test_styled_denorm_train_mode_matches_flax():
    """Batch statistics and flax's biased, momentum-0.9 running stats, over
    two calls (the running stats chain, as across the step's two views)."""
    jm, v, tm, x, style = _styled_denorm(7)
    tm.train()
    xs = torch.from_numpy(x).permute(0, 3, 1, 2)
    ss = torch.from_numpy(style).permute(0, 3, 1, 2)
    for i in range(2):
        out, upd = jm.apply(v, x + i, style, True, mutable=["batch_stats"])
        v = {**v, **jax.tree.map(np.asarray, upd)}
        got = tm(xs + i, ss).permute(0, 2, 3, 1).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(out), atol=1e-4, rtol=0)
    bn = v["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(tm.param_free_norm.running_mean.numpy(), bn["mean"], atol=1e-6)
    np.testing.assert_allclose(tm.param_free_norm.running_var.numpy(), bn["var"], atol=1e-6)
    # torch's BatchNorm2d would store the unbiased variance: not this one
    n = x.shape[0] * x.shape[1] * x.shape[2]
    assert not np.allclose(bn["var"] * n / (n - 1), bn["var"], atol=1e-6)
    assert int(tm.param_free_norm.num_batches_tracked) == 2


def test_styled_denorm_bf16_matches_flax():
    jm, v, tm, x, style = _styled_denorm(8, jnp.bfloat16)
    tb.set_compute_dtype(tm, torch.bfloat16)
    out, _ = jm.apply(v, jnp.asarray(x).astype(jnp.bfloat16), style, True,
                      mutable=["batch_stats"])
    got = tm.train()(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16(),
                     torch.from_numpy(style).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).detach().numpy()
    # bf16 activations (8 significant bits), rounded at other places
    np.testing.assert_allclose(got, np.asarray(out, np.float32), atol=6e-2, rtol=0)


def test_styled_encoder_trains_its_batch_norm():
    """`encode_quantize(train=True)` on the styled encoder (which raised in
    the serving slice): batch statistics, running stats moved as flax's."""
    enc, enc_vars, vq = jax_encoder(styled=True)
    x = np.random.default_rng(9).normal(size=(2, 32, 32, 1)).astype(np.float32)
    jenc = JEncoder(filters=ENC, dict_size=DICT, use_styled_up_block=True)
    with jax.default_matmul_precision("highest"):
        _, jcommit, _, jvq_new, upd = jenc(enc_vars, jvq.VQState(*map(jnp.asarray, vq)),
                                           jnp.asarray(x), train=True)
    port = EncoderWithVQ(1, ENC, DICT, use_styled_up_block=True)
    port.load_state_dict(bridge.from_jax_encoder(enc_vars, vq), strict=True)
    port.train()
    _, commit, _, _ = encode_quantize(port, port.vq.state(), torch.from_numpy(x), train=True)
    np.testing.assert_allclose(float(commit.detach()), float(jcommit), rtol=1e-3)
    want = bridge.from_jax_encoder({**enc_vars, "batch_stats": jax.tree.map(
        np.asarray, upd["batch_stats"])})
    got = port.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 16
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=k)
