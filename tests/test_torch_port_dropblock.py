"""DropBlock, and the training steps with DropBlock and the VGG perceptual
loss on, port vs JAX package, on the CPU.

`dropblock_2d` and `dropblock_schedule` are held bit for bit: the same
uniform draw (JAX's `jax.random.uniform(key, (B,H,W,1))`, transposed for
the port), in f32 and in bf16, where the keep mask's sum and the scale
round to bf16 on both sides.

JAX draws DropBlock's Bernoulli inside flax from the 'dropblock' RNG
stream. To hand the port the same draws, the test wraps the JAX decoder
module's `dropblock_2d` so that its n-th call at trace time takes the n-th
of a list of keys picked beforehand, and gives the port
`jax.random.uniform` of those keys: the decoder's skips, deepest first,
view 1's decode then view 2's. The decoders drop skip level 1
(`dropped_skip_layers`), so DropBlock acts on levels 0, 2 and 3;
`block_size` 7 (30, the configs', would cover these 32² and 64² skips
whole), `drop_prob` 0.5. The perceptual loss is the VGG at '22' on the
JAX fallback's weights, carried across (`from_jax_perceptual`), weight 1.

The steps start from the same flax-initialised variables and draws (the
view draws and CutMix draws replayed as in tests/test_torch_port_train.py
and tests/test_torch_port_second_stage.py); each JAX step is compiled once
(module fixture), on its `xla` conv route and VQ backend. Tolerances,
float32: every loss, and the gradients read from Adam's first moment
(relative Frobenius norm over each module's parameters), within
max(5 × floor, 1e-4) relative, the floor measured in the same run as the
port's own step perturbed at the rounding level (PyTorch's native CPU
convolutions instead of oneDNN's, and the decoder's input moved by one
ulp up or down at random, the gradient still flowing straight through);
the distance loss also atol 1e-3 (a rounding residue under a square root,
as in tests/test_torch_port_train.py). The multi-window reconstruction
loss with `percep_weights` (2, 1, 0.5) is held as the perceptual losses
are (tests/test_torch_port_perceptual.py): rtol 1e-5, its gradient atol
1e-4 × the largest.
"""

import contextlib
import copy
import json
import os
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medical_image_editing_tpu.models.unet_decoder as j_unet_decoder
from medical_image_editing_tpu.models import UNetDecoder as JDecoder
from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ as JEncoder
from medical_image_editing_tpu.ops import dropblock as jd
from medical_image_editing_tpu.ops import perceptual as jp
from medical_image_editing_tpu.train import first_stage as jfs
from medical_image_editing_tpu.train import multi_window as jmw
from medical_image_editing_tpu.train import second_stage as jss
from medical_image_editing_tpu.train import state as jstate
from medical_image_editing_tpu.utils.config import to_config as j_to_config
from medical_image_editing_tpu_torch.models import UNetDecoder
from medical_image_editing_tpu_torch.models.unet_decoder import sample_dropblock_draws
from medical_image_editing_tpu_torch.models.unet_encoder import EncoderWithVQ
from medical_image_editing_tpu_torch.ops import dropblock as td
from medical_image_editing_tpu_torch.ops import perceptual as tp
from medical_image_editing_tpu_torch.train import first_stage as tfs
from medical_image_editing_tpu_torch.train import multi_window as tmw
from medical_image_editing_tpu_torch.train import second_stage as tss
from medical_image_editing_tpu_torch.train import state as tstate
from medical_image_editing_tpu_torch.utils import weights as bridge
from medical_image_editing_tpu_torch.utils.config import to_config
from test_torch_port_augment import jax_view_draws, to_torch_draws
from test_torch_port_second_stage import _images as second_images
from test_torch_port_second_stage import _jax_dis, _port_dis
from test_torch_port_train import _images as first_images
from test_torch_port_train import _jax_grads, _port_grads

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
BLOCK, DROP, DROPPED = 7, 0.5, (1,)
BASE_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors (several test workers
    share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# dropblock_2d, the schedule, the decoder
# ---------------------------------------------------------------------------
def _uniform_nchw(key, shape):
    """`jax.random.uniform(key, (B,H,W,1))` as the port's (B,1,H,W) draw."""
    b, h, w = shape[:3]
    u = np.asarray(jax.random.uniform(key, (b, h, w, 1)))
    return torch.from_numpy(np.ascontiguousarray(u.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("drop_prob", [0.0, 0.5])
@pytest.mark.parametrize("block_size", [30, 7])
def test_dropblock_2d_matches_jax(block_size, drop_prob, dtype, train):
    key = jax.random.key(3)
    x = jax.random.normal(jax.random.key(1), (2, 64, 48, 5)).astype(dtype)
    want = np.asarray(jd.dropblock_2d(key, x, jnp.float32(drop_prob), block_size,
                                      train=train).astype(jnp.float32))
    tx = torch.tensor(np.asarray(x.astype(jnp.float32))).permute(0, 3, 1, 2)
    got = td.dropblock_2d(tx.to(getattr(torch, dtype)), drop_prob, block_size,
                          _uniform_nchw(key, x.shape), train=train)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), want)
    dropped = float((want == 0).mean())
    assert dropped > 0.3 if (train and drop_prob) else dropped == 0.0


@pytest.mark.parametrize("epoch", [0, 19, 25])
def test_dropblock_schedule_matches_jax(epoch):
    got = td.dropblock_schedule(epoch, 0.1, 0.5, 20)
    assert isinstance(got, float)
    assert got == float(jd.dropblock_schedule(epoch, 0.1, 0.5, 20))
    assert td.dropblock_schedule(epoch, 0.3, 0.5, 1) == float(jd.dropblock_schedule(
        epoch, 0.3, 0.5, 1))


@contextlib.contextmanager
def captured_dropblock(seed=99, n=16):
    """Inside the block the JAX decoder's n-th DropBlock call takes the
    n-th of `keys`; `calls` records each call's key and skip shape."""
    keys = [jax.random.fold_in(jax.random.key(seed), i) for i in range(n)]
    calls = []
    real = j_unet_decoder.dropblock_2d

    def chosen(key, x, drop_prob, block_size, train=True):
        k = keys[len(calls)]
        calls.append((k, x.shape))
        return real(k, x, drop_prob, block_size, train)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_unet_decoder, "dropblock_2d", chosen)
        yield calls


def port_draws(calls, n_decodes):
    """The recorded calls' draws for the port, one list per decode."""
    draws = [_uniform_nchw(k, shape) for k, shape in calls]
    per = len(draws) // n_decodes
    assert per * n_decodes == len(draws)
    return tuple(draws[i * per:(i + 1) * per] for i in range(n_decodes))


def test_decoder_dropblock_matches_jax():
    """One train-mode decode: the port's draws are JAX's, level by level;
    in eval mode DropBlock is the identity and takes no draws."""
    filters = (8, 8, 16, 16, 32)
    jdec = JDecoder(out_channels=1, filters=filters, use_dropblock=True, block_size=BLOCK,
                    dropped_skip_layers=DROPPED, use_pixel_shuffle=False)
    x = jax.random.normal(jax.random.key(7), (2, 32, 32, 4))
    variables = jdec.init({"params": jax.random.key(2), "dropblock": jax.random.key(3)}, x,
                          train=False)
    with captured_dropblock() as calls:
        want, _ = jdec.apply(variables, x, True, jnp.float32(DROP), mutable=["batch_stats"],
                             rngs={"dropblock": jax.random.key(0)})
    assert [s[1:3] for _, s in calls] == [(4, 4), (16, 16), (32, 32)]
    dec = UNetDecoder(4, 1, filters, use_dropblock=True, block_size=BLOCK,
                      dropped_skip_layers=DROPPED, use_pixel_shuffle=False)
    dec.load_state_dict(bridge.from_jax_decoder(jax.tree.map(np.asarray, dict(variables))),
                        strict=True)
    assert dec.dropblock_levels() == [0, 2, 3]
    gen = torch.Generator().manual_seed(0)
    assert [tuple(d.shape) for d in sample_dropblock_draws(gen, dec, 2, 32, 32)] == [
        (2, 1, 4, 4), (2, 1, 16, 16), (2, 1, 32, 32)]
    tx = torch.tensor(np.asarray(x)).permute(0, 3, 1, 2)
    draws = port_draws(calls, 1)[0]
    got = dec.train()(tx, DROP, draws)
    # train-mode BatchNorm outputs: tests/test_torch_port_losses.py's atol 1e-4
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    kept = dec(tx, DROP, [torch.ones_like(d) for d in draws])  # no seed: nothing dropped
    assert float((kept.detach().permute(0, 2, 3, 1) - torch.from_numpy(np.asarray(want))).abs()
                 .max()) > 1e-2
    with pytest.raises(ValueError, match="dropblock_draws"):
        dec(tx, DROP)
    dec.eval()
    plain = UNetDecoder(4, 1, filters, dropped_skip_layers=DROPPED, use_pixel_shuffle=False)
    plain.load_state_dict(dec.state_dict(), strict=True)
    with torch.no_grad():
        assert torch.equal(dec(tx, DROP), plain.eval()(tx))


def test_draws_do_not_depend_on_drop_prob():
    """The step draws DropBlock's uniforms whatever drop_prob is, so the
    generator's stream is the schedule's no matter its value."""
    dec = UNetDecoder(4, 1, (8, 8, 16, 16, 32), use_dropblock=True, block_size=BLOCK,
                      dropped_skip_layers=DROPPED, use_pixel_shuffle=False)
    streams = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        tfs.view_dropblock_draws(gen, dec, 2, 32, 32)
        streams.append(torch.rand(4, generator=gen))
    assert torch.equal(*streams)
    off = UNetDecoder(4, 1, (8, 8, 16, 16, 32), use_pixel_shuffle=False)
    gen = torch.Generator().manual_seed(5)
    assert tfs.view_dropblock_draws(gen, off, 2, 32, 32) == (None, None)
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=torch.Generator().manual_seed(5)))


# ---------------------------------------------------------------------------
# the VGG: the JAX fallback's weights on both sides
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def vgg():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jfn = jp.make_vgg_loss("22")
        params = jp._load_vgg_params(8)
        port = tp.make_vgg_loss("22", device="cpu")
    port.load_state_dict(bridge.from_jax_perceptual(params), strict=True)
    return SimpleNamespace(jax=jfn, port=port)


def _config(name, **loss):
    cfg = json.load(open(os.path.join(CONFIGS, name)))
    cfg["loss"].update(use_perceptual_loss=True, perceptual_loss_type="vgg", **loss)
    cfg["loss"]["loss_weight"]["perceptual"] = 1.0
    return cfg


@contextlib.contextmanager
def rounding_floor(module, seed=0):
    """Inside the block the port runs perturbed at the rounding level:
    PyTorch's native CPU convolutions instead of oneDNN's, and the
    quantized features (`module.encode_quantize`'s q) moved by one ulp up
    or down at random."""
    gen = torch.Generator().manual_seed(seed)
    real = module.encode_quantize

    def nudged(*args, **kw):
        q, *rest = real(*args, **kw)
        up = torch.randint(0, 2, q.shape, generator=gen).bool()
        moved = torch.where(up, torch.nextafter(q, q + 1), torch.nextafter(q, q - 1))
        return (q + (moved - q).detach(), *rest)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "encode_quantize", nudged)
        with torch.backends.mkldnn.flags(enabled=False):
            yield


def limit(floor):
    return max(5 * floor, BASE_RTOL)


def _rel(a, b):
    return float(np.sqrt(sum(np.sum((np.asarray(a[k]) - np.asarray(b[k])) ** 2) for k in b)
                         / sum(np.sum(np.asarray(b[k]) ** 2) for k in b)))


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def _assert_metric(name, got, want, floor):
    tol = limit(abs(floor - got) / max(abs(got), 1e-12))
    atol = 1e-3 if name == "dist" else 1e-7
    assert abs(got - want) <= atol + tol * abs(want), (name, got, want, floor)


# ---------------------------------------------------------------------------
# the first-stage step
# ---------------------------------------------------------------------------
ENC, DEC, DICT, B1, S1 = (4, 8, 16, 32, 64), (32, 8, 8, 16, 16), 10, 2, 32


def _first_port(s0, cfg, vgg, image, draws, db_draws, floor=False):
    enc = EncoderWithVQ(1, ENC, DICT, momentum=float(cfg.model.vqmodel.momentum),
                        knn_backend="xla")
    dec = UNetDecoder(ENC[0], 1, DEC, use_dropblock=True, block_size=BLOCK,
                      dropped_skip_layers=DROPPED, use_pixel_shuffle=False)
    sds = bridge.from_jax_train_state(s0)
    enc.load_state_dict(sds["encoder"], strict=True)
    dec.load_state_dict(sds["decoder"], strict=True)
    state = tstate.create_train_state(
        enc, dec, tstate.make_optimizer_from_config(enc.parameters(), cfg.enc_optim),
        tstate.make_optimizer_from_config(dec.parameters(), cfg.dec_optim), device="cpu")
    step = tfs.make_first_stage_step(enc, dec, loss_cfg=tfs.loss_config_from_json(cfg.loss),
                                     aug_cfg=cfg.augmentation, dict_size=DICT,
                                     perceptual_fn=vgg.port, device="cpu")
    with rounding_floor(tfs) if floor else contextlib.nullcontext():
        state, metrics = step(state, image, draws=draws, drop_prob=DROP,
                              dropblock_draws=db_draws)
    return SimpleNamespace(metrics=_metrics(metrics),
                           grads={"enc": _port_grads(state.enc_opt, enc),
                                  "dec": _port_grads(state.dec_opt, dec)})


@pytest.fixture(scope="module")
def first(vgg):
    raw = _config("lung_first_stage.json")
    jcfg, cfg = j_to_config(copy.deepcopy(raw)), to_config(raw)
    image = first_images()
    jenc = JEncoder(filters=ENC, dict_size=DICT, momentum=float(jcfg.model.vqmodel.momentum),
                    knn_backend="xla")
    jdec = JDecoder(out_channels=1, filters=DEC, use_dropblock=True, block_size=BLOCK,
                    dropped_skip_layers=DROPPED, use_pixel_shuffle=False)
    enc_vars, vq = jax.jit(jenc.init)(jax.random.key(1), jnp.zeros((1, S1, S1, 1)))
    dec_vars = dict(jax.jit(lambda k1, k2, q: jdec.init({"params": k1, "dropblock": k2}, q,
                                                        train=False))(
        jax.random.key(2), jax.random.key(3), jnp.zeros((1, S1, S1, ENC[0]))))
    enc_tx = jstate.make_optimizer_from_config(jcfg.enc_optim)
    dec_tx = jstate.make_optimizer_from_config(jcfg.dec_optim)
    s0 = jstate.create_train_state(jax.random.key(4), enc_vars, dec_vars, vq, enc_tx, dec_tx)
    with captured_dropblock() as calls, jax.default_matmul_precision("highest"):
        # the codebook k-means first, as training starts (a random codebook's
        # distance loss sits on rounding residues of large norms)
        s0 = jax.jit(jfs.init_codebook_step(jenc))(s0, jnp.asarray(image))
        step = jax.jit(jfs.make_first_stage_step(
            jenc, jdec, enc_tx, dec_tx, loss_cfg=jfs.loss_config_from_json(jcfg.loss),
            aug_cfg=jcfg.augmentation, dict_size=DICT, perceptual_fn=vgg.jax))
        s1, jm = step(s0, jnp.asarray(image), jnp.float32(DROP))
    fields = ("enc_vars", "dec_vars", "vq", "enc_opt", "dec_opt")
    s0n, s1n = (SimpleNamespace(**{f: jax.tree.map(np.asarray, getattr(s, f)) for f in fields})
                for s in (s0, s1))
    _, k1, k2, _, _ = jax.random.split(s0.rng, 5)
    draws = tuple(to_torch_draws(jax_view_draws(k, jcfg.augmentation, B1, S1, S1))
                  for k in (k1, k2))
    db = port_draws(calls, 2)
    port = _first_port(s0n, cfg, vgg, image, draws, db)
    floor = _first_port(s0n, cfg, vgg, image, draws, db, floor=True)
    return SimpleNamespace(jm=_metrics(jm), s1=s1n, port=port, floor=floor, calls=calls)


@pytest.mark.parametrize("name", ["total", "commit", "cross", "dist", "reg", "recon", "freq",
                                  "perceptual"])
def test_first_stage_losses_match_jax(first, name):
    assert len(first.calls) == 6  # 3 skips a decode, 2 decodes
    if name == "perceptual":
        assert first.jm[name] > 0
    _assert_metric(name, first.port.metrics[name], first.jm[name], first.floor.metrics[name])


@pytest.mark.parametrize("side", ["enc", "dec"])
def test_first_stage_gradients_match_jax(first, side):
    want = _jax_grads(first.s1, side)
    got = {k: v.numpy() for k, v in first.port.grads[side].items()}
    floor = {k: v.numpy() for k, v in first.floor.grads[side].items()}
    assert sorted(got) == sorted(want)
    assert _rel(got, want) <= limit(_rel(floor, got)), (_rel(got, want), _rel(floor, got))


# ---------------------------------------------------------------------------
# the second-stage step (the PatchGAN, one inner loop)
# ---------------------------------------------------------------------------
FILTERS2, S2, DIS = (4, 8, 16, 32, 64), 64, "NLayerDiscriminator"


def _second_port(s0, cfg, vgg, image, db_draws, floor=False):
    enc = EncoderWithVQ(1, FILTERS2, DICT, momentum=float(cfg.model.vqmodel.momentum),
                        knn_backend="xla")
    dec = UNetDecoder(FILTERS2[0], 1, FILTERS2, use_dropblock=True, block_size=BLOCK,
                      dropped_skip_layers=DROPPED, use_pixel_shuffle=False)
    dis = _port_dis(DIS)
    sds = bridge.from_jax_train_state(s0)
    for m, part in ((enc, "encoder"), (dec, "decoder"), (dis, "discriminator")):
        m.load_state_dict(sds[part], strict=True)
    state = tstate.create_train_state(
        enc, dec, tstate.make_optimizer_from_config(enc.parameters(), cfg.enc_optim),
        tstate.make_optimizer_from_config(dec.parameters(), cfg.dec_optim), device="cpu",
        discriminator=dis,
        dis_opt=tstate.make_optimizer_from_config(dis.parameters(), cfg.dis_optim))
    step = tss.make_second_stage_step(enc, dec, dis,
                                      loss_cfg=tss.second_stage_config_from_json(cfg.loss),
                                      dis_type=DIS, perceptual_fn=vgg.port, device="cpu")
    with rounding_floor(tss) if floor else contextlib.nullcontext():
        state, metrics = step(state, image, drop_prob=DROP, dropblock_draws=db_draws)
    return SimpleNamespace(metrics=_metrics(metrics),
                           grads={"dec": _port_moments(state.dec_opt, dec),
                                  "dis": _port_moments(state.dis_opt, dis)})


def _port_moments(opt, module):
    """Adam's first moment ((1 − β1)·g after one step) under the module's
    parameter names."""
    return {k: opt.state[p]["exp_avg"] for k, p in module.named_parameters()}


@pytest.fixture(scope="module")
def second(vgg):
    raw = _config("lung_second_stage.json")
    jcfg, cfg = j_to_config(copy.deepcopy(raw)), to_config(raw)
    image = second_images()
    x0 = jnp.zeros((1, S2, S2, 1))
    jenc = JEncoder(filters=FILTERS2, dict_size=DICT,
                    momentum=float(jcfg.model.vqmodel.momentum), knn_backend="xla")
    jdec = JDecoder(out_channels=1, filters=FILTERS2, use_dropblock=True, block_size=BLOCK,
                    dropped_skip_layers=DROPPED, use_pixel_shuffle=False)
    jdis = _jax_dis(DIS)
    enc_vars, vq = jax.jit(jenc.init)(jax.random.key(1), x0)
    # the codebook a second stage starts from: k-means on the batch's features
    from medical_image_editing_tpu.models.unet_encoder import init_codebook_from_batch

    feats = jenc.module.apply(enc_vars, jnp.asarray(image), train=False)
    vq = init_codebook_from_batch(jax.random.key(6), feats, vq)
    dec_vars = dict(jax.jit(lambda k1, k2, q: jdec.init({"params": k1, "dropblock": k2}, q,
                                                        train=False))(
        jax.random.key(2), jax.random.key(3), jnp.zeros((1, S2, S2, FILTERS2[0]))))
    dis_vars = jax.jit(lambda k: jdis.init(k, x0, train=False))(jax.random.key(5))
    dec_tx = jstate.make_optimizer_from_config(jcfg.dec_optim)
    dis_tx = jstate.make_optimizer_from_config(jcfg.dis_optim)
    s0 = jstate.create_train_state(jax.random.key(4), enc_vars, dec_vars, vq,
                                   jstate.make_optimizer_from_config(jcfg.enc_optim), dec_tx,
                                   dis_vars=dis_vars, dis_tx=dis_tx)
    with captured_dropblock() as calls, jax.default_matmul_precision("highest"):
        step = jax.jit(jss.make_second_stage_step(
            jenc, jdec, jdis, dec_tx, dis_tx, loss_cfg=jss.second_stage_config_from_json(
                jcfg.loss), dis_type=DIS, perceptual_fn=vgg.jax))
        s1, jm = step(s0, jnp.asarray(image), jnp.float32(DROP))
    fields = ("enc_vars", "dec_vars", "vq", "dis_vars", "dec_opt", "dis_opt")
    s0n, s1n = (SimpleNamespace(**{f: jax.tree.map(np.asarray, getattr(s, f)) for f in fields})
                for s in (s0, s1))
    db = port_draws(calls, 1)[0]
    port = _second_port(s0n, cfg, vgg, image, db)
    floor = _second_port(s0n, cfg, vgg, image, db, floor=True)
    return SimpleNamespace(jm=_metrics(jm), s1=s1n, port=port, floor=floor, calls=calls)


@pytest.mark.parametrize("name", ["gen_total", "recon", "freq", "perceptual", "gen",
                                  "dis_total", "dis", "total"])
def test_second_stage_losses_match_jax(second, name):
    assert len(second.calls) == 3
    if name == "perceptual":
        assert second.jm[name] > 0
    _assert_metric(name, second.port.metrics[name], second.jm[name], second.floor.metrics[name])


def _jax_moments(s, part):
    """Adam's first moment of a JAX state's decoder or discriminator, under
    the port's keys."""
    opt = s.dec_opt if part == "dec" else s.dis_opt
    g = next(x for x in opt if hasattr(x, "mu")).mu
    if part == "dis":
        return {k: v for k, v in bridge.from_jax_discriminator({**s.dis_vars, "params": g}).items()
                if k in dict(_port_dis(DIS).named_parameters())}
    sd = bridge.from_jax_decoder({"params": g, "batch_stats": s.dec_vars["batch_stats"]})
    return {k: v for k, v in sd.items() if "param_free_norm" not in k}


@pytest.mark.parametrize("part", ["dec", "dis"])
def test_second_stage_gradients_match_jax(second, part):
    want = _jax_moments(second.s1, part)
    got = {k: v.numpy() for k, v in second.port.grads[part].items()}
    floor = {k: v.numpy() for k, v in second.floor.grads[part].items()}
    assert sorted(got) == sorted(want)
    assert _rel(got, want) <= limit(_rel(floor, got)), (_rel(got, want), _rel(floor, got))


# ---------------------------------------------------------------------------
# the multi-window reconstruction loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weights", [(2.0, 1.0, 0.5)])
def test_multiwindow_recon_loss_with_percep_weights_matches_jax(vgg, weights):
    """Each window's perceptual term weighted by its own weight: the
    weights swapped end for end give another loss."""
    raw = _config("lung_multiwindow_joint.json")
    jcfg, cfg = j_to_config(copy.deepcopy(raw)), to_config(raw)
    ds = cfg.dataset
    window = (float(ds.window_width), float(ds.window_center), float(ds.window_scale))
    rng = np.random.default_rng(3)
    recon = np.tanh(rng.normal(size=(2, 32, 32, 1))).astype(np.float32)
    target = np.tanh(rng.normal(size=(2, 32, 32, 1))).astype(np.float32)
    unit = (1.0, 1.0, 1.0)

    def jax_loss(r):
        f = jmw.make_multiwindow_recon_loss(jfs.loss_config_from_json(jcfg.loss), window, unit,
                                            unit, weights, perceptual_fn=vgg.jax)
        return sum(f(r, jnp.asarray(target)))

    jv, jg = jax.value_and_grad(jax_loss)(jnp.asarray(recon))
    f = tmw.make_multiwindow_recon_loss(tfs.loss_config_from_json(cfg.loss), window, unit, unit,
                                        weights, perceptual_fn=vgg.port)
    r = torch.tensor(recon, requires_grad=True)
    terms = f(r, torch.tensor(target))
    (g,) = torch.autograd.grad(sum(terms), r)
    np.testing.assert_allclose(float(sum(terms)), float(jv), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-4 * float(np.abs(jg).max()))
    _, _, jp_only = jmw.make_multiwindow_recon_loss(
        jfs.loss_config_from_json(jcfg.loss), window, unit, unit, weights,
        perceptual_fn=vgg.jax)(jnp.asarray(recon), jnp.asarray(target))
    np.testing.assert_allclose(float(terms[2]), float(jp_only), rtol=1e-5)
    swapped = tmw.make_multiwindow_recon_loss(tfs.loss_config_from_json(cfg.loss), window, unit,
                                              unit, weights[::-1], perceptual_fn=vgg.port)
    with torch.no_grad():
        other = float(swapped(torch.tensor(recon), torch.tensor(target))[2])
    assert abs(other - float(jp_only)) > 1e-3 * abs(float(jp_only))
