"""The second stage's modules and its trainer, port vs JAX package, on the
CPU at small size: spectral norm (`SNConv`, `SNDense`), the BigGAN blocks
(`DBlock`, `GBlock2`, `Attention`), the U-Net discriminator at 128 and 256
(`D_attn` "0" and "64", all three outputs), the PatchGAN with instance
norm, batch norm and spectral norm, the GAN losses, CutMix, the
discriminators' key space against the JAX package's reference-format
export; then `training_mode: "second_step"` through the trainer and
`run_vqwnet` over a fabricated lung tree (the JAX trainer fitted once, in
a module fixture): the losses of 2 steps and the k-means gate against
JAX's, a resume bit for bit, the staged first stage and discriminator,
the validation maps, the PatchGAN through the CLI.

Both sides get the same flax-initialised variables (through the port's
`utils/weights.py`) and the same numpy inputs, NHWC for JAX and NCHW for
the port. Tolerances, float32: outputs atol 2e-5 + rtol 1e-4 (the
frameworks sum convolutions and matmuls in other orders); spectral-norm
u and σ rtol 1e-5, atol 1e-6 (one power step of normalised vectors);
the losses rtol 1e-6; CutMix boxes and masks exactly equal; the weight
bridge's keys and values exactly equal to the export's.
"""

import importlib
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.models import biggan_layers as jbl
from medical_image_editing_tpu.models.discriminator import NLayerDiscriminator as JNLayer
from medical_image_editing_tpu.models.unet_discriminator import UNetDiscriminator as JUNetD
from medical_image_editing_tpu.ops import losses as jlosses
from medical_image_editing_tpu.utils.torch_export import (
    export_nlayer_discriminator,
    export_unet_discriminator,
)
from medical_image_editing_tpu_torch.models import biggan_layers as tbl
from medical_image_editing_tpu_torch.models.discriminator import NLayerDiscriminator
from medical_image_editing_tpu_torch.models.unet_discriminator import (
    UNetDiscriminator,
    reference_state_dict,
)
from medical_image_editing_tpu_torch.ops import cutmix as tcut
from medical_image_editing_tpu_torch.ops import losses as tlosses
from medical_image_editing_tpu_torch.utils import weights as bridge
from test_torch_port_second_stage import jax_draws
from test_torch_port_trainer import _csv, _lung_tree

# the JAX package's `ops` re-exports its function `cutmix` under the module's name
jcut = importlib.import_module("medical_image_editing_tpu.ops.cutmix")

ATOL, RTOL = 2e-5, 1e-4
SN_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors (several test workers
    share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _train(jm, variables, x):
    """One flax train-mode forward: (output, variables with the updated
    batch_stats)."""
    y, upd = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    return y, {**variables, **upd}


def _sn_dense_sd(params, stats, prefix=""):
    dense, sn = params["Dense_0"], stats["SpectralNorm_0"]
    return {f"{prefix}weight": torch.from_numpy(np.asarray(dense["kernel"]).T.copy()),
            f"{prefix}bias": torch.from_numpy(np.array(dense["bias"])),
            f"{prefix}u0": torch.from_numpy(np.array(sn["Dense_0/kernel/u"])),
            f"{prefix}sv0": torch.from_numpy(np.array(sn["Dense_0/kernel/sigma"]).reshape(1))}


def _sn_conv_sd(params, stats, prefix=""):
    out = {}
    bridge._sn_conv(out, prefix.rstrip("."), params, stats)
    return {k.lstrip("."): v for k, v in out.items()}


def _block_sd(variables, parts):
    """A block's flax variables → the port's keys: SNConv_t → parts[t]."""
    params, stats = _np(variables["params"]), _np(variables["batch_stats"])
    out = {}
    for t, part in enumerate(parts):
        if f"SNConv_{t}" in params:
            out.update(_sn_conv_sd(params[f"SNConv_{t}"], stats[f"SNConv_{t}"], f"{part}."))
    if "gamma" in params:
        out["gamma"] = torch.from_numpy(np.array(params["gamma"]).reshape(()))
    return out


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# spectral norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["conv3x3", "conv1x1_nobias", "dense"])
def test_spectral_norm_follows_flax(kind):
    """σ, u and the output over three train forwards (each storing u and
    σ), then an eval forward, which stores nothing and still runs flax's
    power step from the stored u."""
    if kind == "dense":
        jm, port = jbl.SNDense(3), tbl.SNDense(7, 3)
        xs = [_x((4, 7), s) for s in range(4)]
        to_port, from_port = torch.from_numpy, lambda t: t.detach().numpy()
        sd = lambda v: _sn_dense_sd(_np(v["params"]), _np(v["batch_stats"]))
    else:
        k, bias = (3, True) if kind == "conv3x3" else (1, False)
        jm, port = jbl.SNConv(6, k, use_bias=bias), tbl.SNConv(5, 6, k, bias=bias)
        xs = [_x((2, 8, 8, 5), s) for s in range(4)]
        to_port, from_port = _nchw, _nhwc
        sd = lambda v: _sn_conv_sd(_np(v["params"]), _np(v["batch_stats"]))
    variables = jm.init(jax.random.key(3), jnp.asarray(xs[0]), False)
    port.load_state_dict(sd(variables), strict=True)
    assert float(port.sv0) == 1.0  # flax's initial σ
    port.train()
    for x in xs[:3]:
        jy, variables = _train(jm, variables, x)
        py = port(to_port(x))
        _close(from_port(py), jy)
        want = sd(variables)
        np.testing.assert_allclose(port.u0.numpy(), want["u0"].numpy(), **SN_TOL)
        np.testing.assert_allclose(port.sv0.numpy(), want["sv0"].numpy(), **SN_TOL)
    u_before, sv_before = port.u0.clone(), port.sv0.clone()
    port.eval()
    jy = jm.apply(variables, jnp.asarray(xs[3]), False)
    py = port(to_port(xs[3]))
    _close(from_port(py), jy)
    assert torch.equal(port.u0, u_before) and torch.equal(port.sv0, sv_before)


def test_spectral_norm_gradient_flows_through_the_weight_only():
    """σ = v·W·uᵀ with u, v detached: the gradient of the normalised weight
    against JAX's, and none reaches the buffers."""
    jm = jbl.SNConv(4, 3)
    x = _x((2, 6, 6, 3), 5)
    variables = jm.init(jax.random.key(4), jnp.asarray(x), False)
    port = tbl.SNConv(3, 4, 3)
    port.load_state_dict(_sn_conv_sd(_np(variables["params"]), _np(variables["batch_stats"])))

    def loss(params):
        y, _ = jm.apply({**variables, "params": params}, jnp.asarray(x), True,
                        mutable=["batch_stats"])
        return jnp.sum(y ** 2)

    jg = jax.grad(loss)(variables["params"])["Conv_0"]["kernel"]
    (port(_nchw(x)) ** 2).sum().backward()
    _close(port.weight.grad.numpy().transpose(2, 3, 1, 0), jg, atol=1e-4)
    assert not port.u0.requires_grad and port.u0.grad is None


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

BLOCKS = {
    "dblock_first": (lambda: jbl.DBlock(8, wide=True, preactivation=False, downsample=True),
                     lambda: tbl.DBlock(3, 8, wide=True, preactivation=False, downsample=True), 3),
    "dblock_preact": (lambda: jbl.DBlock(8, wide=True, preactivation=True, downsample=True),
                      lambda: tbl.DBlock(4, 8, wide=True, preactivation=True, downsample=True), 4),
    "dblock_narrow_same": (lambda: jbl.DBlock(6, wide=False, preactivation=True),
                           lambda: tbl.DBlock(6, 6, wide=False, preactivation=True), 6),
    "gblock2_up": (lambda: jbl.GBlock2(4, upsample=True),
                   lambda: tbl.GBlock2(8, 4, upsample=True), 8),
    "gblock2_same": (lambda: jbl.GBlock2(5, upsample=False),
                     lambda: tbl.GBlock2(5, 5, upsample=False), 5),
    "attention": (lambda: jbl.Attention(), lambda: tbl.Attention(16), 16),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_blocks_match_jax(name):
    make_j, make_t, cin = BLOCKS[name]
    jm, port = make_j(), make_t()
    parts = ("theta", "phi", "g", "o") if name == "attention" else ("conv1", "conv2", "conv_sc")
    x = _x((2, 8, 8, cin), 7)
    variables = jm.init(jax.random.key(5), jnp.asarray(x), False)
    if name == "attention":  # γ = 0 at init would hide the attention path
        variables = {**variables, "params": {**variables["params"], "gamma": jnp.float32(0.7)}}
    port.load_state_dict(_block_sd(variables, parts), strict=True)
    port.train()
    jy, variables = _train(jm, variables, x)
    _close(_nhwc(port(_nchw(x))), jy)
    want = _block_sd(variables, parts)
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), **SN_TOL, err_msg=k)
    port.eval()
    x2 = _x((2, 8, 8, cin), 8)
    _close(_nhwc(port(_nchw(x2))), jm.apply(variables, jnp.asarray(x2), False))


# ---------------------------------------------------------------------------
# the discriminators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("resolution,d_attn", [(128, "0"), (256, "64")])
def test_unet_discriminator_matches_jax(resolution, d_attn):
    """All three outputs in train mode (then every u and σ), and in eval
    mode; attention on the 64-resolution block at 256."""
    jm = JUNetD(D_ch=4, D_attn=d_attn, resolution=resolution)
    x = _x((2, 128, 128, 1), 11)
    variables = _np(jax.jit(lambda k, x: jm.init(k, x, False))(jax.random.key(6), x))
    if d_attn != "0":  # γ = 0 at init would hide the attention path
        variables["params"]["Attention_0"]["gamma"] = np.float32(0.5)
    port = UNetDiscriminator(D_ch=4, D_attn=d_attn, resolution=resolution)
    assert any(port.has_attention) == (d_attn != "0")
    port.load_state_dict(bridge.from_jax_unet_discriminator(variables, D_attn=d_attn),
                         strict=True)
    train = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))
    (jmap, jbottle, jfeats), upd = train(variables, x)
    port.train()
    pmap, pbottle, pfeats = port(_nchw(x))
    _close(_nhwc(pmap), jmap)
    _close(pbottle.detach().numpy(), jbottle)
    assert len(pfeats) == len(jfeats) == resolution.bit_length() - 3
    for p, j in zip(pfeats, jfeats):
        _close(_nhwc(p), j)
    after = bridge.from_jax_unet_discriminator({**variables, **_np(upd)}, D_attn=d_attn)
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), after[k].numpy(), **SN_TOL, err_msg=k)
    port.eval()
    x2 = _x((2, 128, 128, 1), 12)
    jmap, jbottle, _ = jax.jit(lambda v, x: jm.apply(v, x, False))({**variables, **upd}, x2)
    pmap, pbottle, _ = port(_nchw(x2))
    _close(_nhwc(pmap), jmap)
    _close(pbottle.detach().numpy(), jbottle)


NLAYER = [("instancenorm", False), ("batchnorm", False), ("batchnorm", True),
          ("instancenorm", True)]


@pytest.mark.parametrize("normalization,sn", NLAYER)
def test_nlayer_discriminator_matches_jax(normalization, sn):
    """Train-mode logits, then BatchNorm running stats and spectral-norm u,
    then eval logits."""
    jm = JNLayer(n_filters=4, n_layers=3, normalization=normalization,
                 apply_spectral_norm=sn)
    x = _x((2, 64, 64, 1), 13)
    variables = _np(jm.init(jax.random.key(7), jnp.asarray(x), train=False))
    port = NLayerDiscriminator(n_filters=4, n_layers=3, normalization=normalization,
                               apply_spectral_norm=sn)
    port.load_state_dict(bridge.from_jax_nlayer_discriminator(variables), strict=True)
    if "batch_stats" in variables:
        jy, upd = jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    else:  # instance norm without spectral norm: nothing to update
        jy, upd = jm.apply(variables, jnp.asarray(x), True), {}
    port.train()
    _close(_nhwc(port(_nchw(x))), jy)
    after = bridge.from_jax_nlayer_discriminator({**variables, **_np(upd)})
    for k, v in port.state_dict().items():
        # flax keeps no batch counter; `weight_v` is the port's own record
        if not k.endswith(("weight_v", "num_batches_tracked")):
            np.testing.assert_allclose(v.numpy(), after[k].numpy(), **SN_TOL, err_msg=k)
    port.eval()
    x2 = _x((2, 64, 64, 1), 14)
    _close(_nhwc(port(_nchw(x2))), jm.apply({**variables, **upd}, jnp.asarray(x2), False))


def test_refusals():
    with pytest.raises(NotImplementedError, match="ROADMAP item 21"):
        UNetDiscriminator(D_ch=4, resolution=128, n_classes=3)
    # the actnorm is ported (tests/test_torch_port_vqgan.py); an unknown
    # normalization is refused
    assert any(type(m).__name__ == "ActNorm"
               for m in NLayerDiscriminator(normalization="actnorm").modules())
    with pytest.raises(ValueError, match="normalization"):
        NLayerDiscriminator(normalization="groupnorm")
    with pytest.raises(ValueError, match="resolution"):
        UNetDiscriminator(D_ch=4, resolution=64)


# ---------------------------------------------------------------------------
# key space
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("resolution,d_attn", [(128, "0"), (256, "64"), (512, "32_64")])
def test_unet_discriminator_keys_equal_the_reference_export(resolution, d_attn):
    """`from_jax_unet_discriminator` gives the export's keys and values
    (the export also writes the reference's unused `linear.*`); both the
    port's dict and the reference-keyed export minus `linear.*` load into
    the port's module with strict=True."""
    jm = JUNetD(D_ch=8, D_attn=d_attn, resolution=resolution)
    x = jnp.zeros((1, 128, 128, 1))  # 512's seven downsamples need 128
    variables = _np(jax.jit(lambda k, x: jm.init(k, x, False))(jax.random.key(8), x))
    got = bridge.from_jax_unet_discriminator(variables, D_attn=d_attn)
    ref = export_unet_discriminator(variables, jm)
    assert {k for k in ref if k.startswith("linear.")} == {
        "linear.weight", "linear.bias", "linear.u0", "linear.sv0"}
    want = reference_state_dict(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == tuple(np.shape(want[k])), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    port = UNetDiscriminator(D_ch=8, D_attn=d_attn, resolution=resolution)
    assert sorted(port.state_dict()) == sorted(want)
    port.load_state_dict(got, strict=True)
    port.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in want.items()},
                         strict=True)


@pytest.mark.parametrize("normalization,sn", NLAYER)
def test_nlayer_keys_equal_the_reference_export(normalization, sn):
    jm = JNLayer(n_filters=4, n_layers=3, normalization=normalization,
                 apply_spectral_norm=sn)
    variables = _np(jm.init(jax.random.key(9), jnp.zeros((1, 64, 64, 1)), train=False))
    got = bridge.from_jax_nlayer_discriminator(variables)
    want = export_nlayer_discriminator(variables)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    port = NLayerDiscriminator(n_filters=4, n_layers=3, normalization=normalization,
                               apply_spectral_norm=sn)
    assert sorted(port.state_dict()) == sorted(want)
    port.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in want.items()},
                         strict=True)


def test_train_state_bridge_carries_the_discriminator():
    jm = JUNetD(D_ch=4, D_attn="0", resolution=128)
    dis_vars = _np(jax.jit(lambda k, x: jm.init(k, x, False))(
        jax.random.key(10), jnp.zeros((1, 64, 64, 1))))
    from medical_image_editing_tpu.models import UNetDecoder as JDecoder
    from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ as JEncoder

    enc, dec = JEncoder(filters=(4, 8, 8, 16, 16), dict_size=5), JDecoder(
        out_channels=1, filters=(8, 8, 16, 16, 32), dropped_skip_layers=(),
        use_pixel_shuffle=False)
    enc_vars, vq = enc.init(jax.random.key(1), jnp.zeros((1, 16, 16, 1)))
    dec_vars = dec.init({"params": jax.random.key(2), "dropblock": jax.random.key(3)},
                        jnp.zeros((1, 16, 16, 4)), train=False)
    state = SimpleNamespace(enc_vars=_np(enc_vars), dec_vars=_np(dec_vars), vq=_np(vq),
                            dis_vars=dis_vars)
    sds = bridge.from_jax_train_state(state)
    assert set(sds) == {"encoder", "decoder", "discriminator"}
    UNetDiscriminator(D_ch=4, resolution=128, D_attn="0").load_state_dict(
        sds["discriminator"], strict=True)
    assert "discriminator" not in bridge.from_jax_train_state(
        SimpleNamespace(**{**vars(state), "dis_vars": {}}))


# ---------------------------------------------------------------------------
# losses and CutMix
# ---------------------------------------------------------------------------


def test_gan_losses_match_jax():
    real, fake = _x((2, 16, 16, 1), 15) * 2, _x((2, 16, 16, 1), 16) * 2
    for name, args in (("hinge_d_loss", (real, fake)), ("vanilla_d_loss", (real, fake)),
                       ("hinge_g_loss", (fake,))):
        want = getattr(jlosses, name)(*map(jnp.asarray, args))
        got = getattr(tlosses, name)(*map(torch.from_numpy, args))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("seed", range(6))
def test_cutmix_box_and_mask_match_jax(seed):
    """The box from JAX's own draws (lam, the centre's uniforms) and its
    mask, exactly; pasting and the lerp on the same mask."""
    h, w = 48, 40
    key = jax.random.key(seed)
    (jy, jx), jlam = jcut.cutmix_coordinates(key, h, w)
    k1, k2, k3 = jax.random.split(key, 3)
    ux = jax.random.uniform(k2, (), minval=0.0, maxval=w) / w
    uy = jax.random.uniform(k3, (), minval=0.0, maxval=h) / h
    box = tcut.cutmix_box(torch.tensor(float(jlam)), torch.tensor(float(ux)),
                          torch.tensor(float(uy)), h, w)
    assert [int(v) for pair in box for v in pair] == [int(v) for v in (*jy, *jx)]
    jmask = np.asarray(jcut.cutmix_mask(((jy, jx)), h, w))
    mask = tcut.cutmix_mask(box, h, w)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    src, tgt = _x((2, h, w, 3), 17), _x((2, h, w, 3), 18)
    for fn in ("cutmix", "mask_src_tgt"):
        want = getattr(jcut, fn)(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(jmask))
        got = getattr(tcut, fn)(_nchw(src), _nchw(tgt), mask)
        np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-7, err_msg=fn)


def test_cutmix_coordinates_draw_from_the_generator():
    a = tcut.cutmix_coordinates(torch.Generator().manual_seed(3), 32, 24)
    b = tcut.cutmix_coordinates(torch.Generator().manual_seed(3), 32, 24)
    assert [int(v) for p in a[0] for v in p] == [int(v) for p in b[0] for v in p]
    gen = torch.Generator().manual_seed(4)
    for _ in range(50):
        ((y0, y1), (x0, x1)), lam = tcut.cutmix_coordinates(gen, 32, 24)
        assert 0 <= int(y0) <= int(y1) <= 32 and 0 <= int(x0) <= int(x1) <= 24
        assert 0.0 <= float(lam) < 1.0
    with pytest.raises(ValueError, match="alpha 1"):
        tcut.cutmix_coordinates(gen, 32, 24, alpha=0.5)


# ---------------------------------------------------------------------------
# the trainer's second stage
# ---------------------------------------------------------------------------

SECOND = os.path.join(os.path.dirname(__file__), "..", "configs", "lung_second_stage.json")
STEP_METRICS = ["gen_total", "recon", "freq", "perceptual", "gen", "unet_perceptual",
                "dis_total", "dis", "cutmix", "consistency", "total"]
TREE_SIZE = 64


def _second_config(root, *, dis="unet", **run):
    """The lung second-stage config at test size: filters (4, 8, 16, 32,
    64), batch 2, 64² slices (2 patients × 4: 4 steps an epoch), f32, the
    U-Net discriminator at D_ch 4 and resolution 128 (or a PatchGAN)."""
    cfg = json.load(open(SECOND))
    cfg["dataset"].update(root_dir_path=str(root / "data"), batch_size=2, num_workers=0,
                          image_size=[TREE_SIZE, TREE_SIZE])
    cfg["model"]["vqmodel"].update(enc_filters=[4, 8, 16, 32, 64],
                                   dec_filters=[4, 8, 16, 32, 64], knn_backend="xla",
                                   compute_dtype="float32")
    if dis == "unet":
        cfg["model"]["dis"].update(D_ch=4, D_attn="0", resolution=128)
    else:
        cfg["model"]["dis"] = {"model_name": "NLayerDiscriminator", "n_filters": 4,
                               "n_layers": 2, "normalization": "batchnorm",
                               "apply_spectral_norm": True}
    cfg["save"].update(save_dir=str(root / "results"), n_save_images=2)
    cfg["run"].update({"n_epochs": 1, "first_stage_ckpt_path": None,
                       "monitoring_metrics": ["epoch", "iteration", *STEP_METRICS], **run})
    return cfg


def _jnp_state(state):
    return SimpleNamespace(**{f: jax.tree.map(np.asarray, getattr(state, f))
                              for f in ("enc_vars", "dec_vars", "vq", "dis_vars")})


def _port_state(trainer, s0):
    state = trainer.init_state()
    sds = bridge.from_jax_train_state(s0)
    for part in ("encoder", "decoder", "discriminator"):
        getattr(state, part).load_state_dict(sds[part], strict=True)
    return state


@pytest.fixture(scope="module")
def gan_env(tmp_path_factory):
    """The JAX trainer's second stage: its initial state (numpy), a 2-step
    fit with the codebook k-means on the first batch (`use_init_embed`)."""
    from medical_image_editing_tpu.train.trainer import Trainer as JTrainer
    from medical_image_editing_tpu.utils.config import to_config as j_to_config
    from medical_image_editing_tpu.utils.logging import Logger as JLogger

    root = tmp_path_factory.mktemp("second_stage_trainer")
    _lung_tree(root / "data", size=TREE_SIZE)
    cfg = _second_config(root)
    jcfg = j_to_config(cfg)
    jt = JTrainer(jcfg, logger=JLogger(str(root / "jax"), config=jcfg,
                                       monitoring_metrics=cfg["run"]["monitoring_metrics"]),
                  rng_key=jax.random.key(0), devices=jax.devices()[:1])
    first = jt.init_state(TREE_SIZE, 2)
    s0, rng0 = _jnp_state(first), first.rng
    final = jt.fit(state=jt.init_state(TREE_SIZE, 2), max_steps=2)
    # the JAX run's random numbers: k-means start rows, then each step's CutMix
    rng1, k_init = jax.random.split(rng0)
    init_idx = np.asarray(jax.random.choice(k_init, 2 * TREE_SIZE * TREE_SIZE, (10,),
                                            replace=False))
    draws, rng = [], rng1
    for _ in range(2):
        draws.append(jax_draws(rng, 1, TREE_SIZE, TREE_SIZE))
        rng = jax.random.split(rng, 3)[0]
    return SimpleNamespace(root=root, cfg=cfg, s0=s0, jlog=jt.logger.log_dir,
                           codebook=np.asarray(final.vq.embed), init_idx=init_idx, draws=draws)


@pytest.fixture(scope="module")
def gan_fit(gan_env):
    """The port's trainer on the same tree, weights and draws: 2 steps."""
    from medical_image_editing_tpu_torch.train import trainer as ttrainer
    from medical_image_editing_tpu_torch.utils.config import to_config
    from medical_image_editing_tpu_torch.utils.logging import Logger

    cfg = to_config(gan_env.cfg)
    logger = Logger(str(gan_env.root / "port"), config=cfg,
                    monitoring_metrics=gan_env.cfg["run"]["monitoring_metrics"])
    trainer = ttrainer.Trainer(cfg, logger=logger, device="cpu")
    state = _port_state(trainer, gan_env.s0)
    staged = state.encoder.vq.embed.clone()
    step, calls = trainer.train_step, []

    def replayed(state, image, draws=None):
        calls.append(image.clone())
        return step(state, image, gan_env.draws[len(calls) - 1])

    trainer.train_step = replayed
    real_init = ttrainer.init_codebook_step
    idx = torch.from_numpy(gan_env.init_idx.copy())
    ttrainer.init_codebook_step = lambda enc: (
        lambda st, image: real_init(enc)(st, image, init_idx=idx))
    try:
        state = trainer.fit(state=state, max_steps=2)
    finally:
        ttrainer.init_codebook_step = real_init
    return SimpleNamespace(state=state, log=logger.log_dir, staged=staged, calls=calls)


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("name", STEP_METRICS)
def test_second_stage_fit_losses_match_jax(gan_env, gan_fit, step, name):
    """rtol 1e-4 (atol 1e-6) at both steps, as the step test. Step 2 runs
    after one Adam step of decoder and discriminator, where a gradient at
    its rounding level flips an update (tests/test_torch_port_second_stage.py);
    measured relative differences: step 1 ≤ 1.5e-6, step 2 ≤ 6.0e-6."""
    got = _csv(os.path.join(gan_fit.log, "log.csv"))
    want = _csv(os.path.join(gan_env.jlog, "log.csv"))
    assert len(got) == len(want) == 2 and len(gan_fit.calls) == 2
    g, w = got[step - 1], want[step - 1]
    assert (g["epoch"], g["iteration"]) == (w["epoch"], w["iteration"]) == (0, step)
    np.testing.assert_allclose(g[name], w[name], rtol=1e-4, atol=1e-6, err_msg=name)


def test_second_stage_runs_the_kmeans_gate_as_jax(gan_env, gan_fit):
    """At step 0 with `use_init_embed` the JAX trainer re-clusters the
    codebook before the frozen encoder is used, in the second stage too:
    the port's codebook after the fit equals JAX's (rtol 1e-4, as the
    first-stage k-means test) and left the one it started from."""
    got = gan_fit.state.encoder.vq.embed.numpy()
    np.testing.assert_allclose(got, gan_env.codebook, rtol=1e-4, atol=1e-6)
    assert not np.allclose(got, gan_fit.staged.numpy())


def _cli(root, name, argv, dis="unet", **run):
    from medical_image_editing_tpu_torch.cli import run_vqwnet

    cfg = _second_config(root, dis=dis, n_epochs=2, **run)
    cfg["save"].update(study_name=name, save_every_n_steps=2)
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    assert run_vqwnet.main(["-c", str(path), "--device", "cpu", *argv]) == 0
    return root / "results" / name


def _first_stage_ckpt(root):
    """A first-stage checkpoint of the port (its trainer's state, saved)."""
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils.checkpoint import CheckpointManager
    from medical_image_editing_tpu_torch.utils.config import to_config

    cfg = _second_config(root)
    cfg["run"]["training_mode"] = "first_step"
    state = Trainer(to_config(cfg), device="cpu", seed=7).init_state()
    assert state.discriminator is None
    path = root / "first_stage" / "ckpt"
    CheckpointManager(str(path)).save(state, 0)
    return path, state


def test_second_stage_cli_resume_is_bit_identical(gan_env):
    """Staged from a port first-stage checkpoint: 5 steps straight vs 3,
    resume, 2 more (across the epoch end): the same losses and the same
    final state bit for bit (discriminator, its Adam and spectral-norm
    vectors, generator included)."""
    from medical_image_editing_tpu_torch.utils.checkpoint import load_state_file

    ckpt, first = _first_stage_ckpt(gan_env.root)
    straight = _cli(gan_env.root, "gan_straight", ["-m", "train", "--max-steps", "5"],
                    first_stage_ckpt_path=str(ckpt)) / "version_0"
    part = _cli(gan_env.root, "gan_split", ["-m", "train", "--max-steps", "3"],
                first_stage_ckpt_path=str(ckpt)) / "version_0"
    resumed = _cli(gan_env.root, "gan_split", ["-m", "train", "--max-steps", "5"],
                   first_stage_ckpt_path=str(ckpt),
                   resume_checkpoint=str(part / "ckpt")) / "version_1"
    a, b = _csv(straight / "log.csv"), _csv(part / "log.csv") + _csv(resumed / "log.csv")
    assert [r["iteration"] for r in b] == [1, 2, 3, 4, 5] and a == b
    name = "ckpt-epoch=0001-step=00000005"
    sa, sb = (load_state_file(str(p / "ckpt" / name)) for p in (straight, resumed))
    assert (sa["step"], sa["epoch"]) == (sb["step"], sb["epoch"]) == (5, 1)
    assert torch.equal(sa["generator"], sb["generator"])
    for part_name in ("encoder", "decoder", "discriminator"):
        for k in sa[part_name]:
            assert torch.equal(sa[part_name][k], sb[part_name][k]), (part_name, k)
    for opt in ("dec_opt", "dis_opt"):
        for i, s in sa[opt]["state"].items():
            for k, v in s.items():
                assert torch.equal(v, sb[opt]["state"][i][k]), (opt, i, k)
    # staged: the encoder's weights are the first stage's, frozen; the
    # codebook was re-clustered at step 0
    enc = sa["encoder"]
    for k, v in first.encoder.state_dict().items():
        if not k.startswith("vq."):
            assert torch.equal(enc[k], v), k
    assert not torch.equal(enc["vq.embed"], first.encoder.vq.embed)
    assert not sa["enc_opt"]["state"]
    # the epoch-end validation grid, with the discriminator's maps
    assert (straight / "val_0000_0.png").exists()


def test_second_stage_validation_draws_the_discriminator_maps(gan_env, gan_fit, tmp_path):
    from medical_image_editing_tpu_torch.train import evaluate
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils.config import to_config

    state = gan_fit.state
    trainer = Trainer(to_config(gan_env.cfg), device="cpu")
    forward = evaluate.make_eval_forward(state.encoder, state.decoder, device="cpu")
    image = torch.from_numpy(_x((2, TREE_SIZE, TREE_SIZE, 1), 19).clip(-1, 1))
    recon, ids = forward(image)
    u_before = state.discriminator.linear_middle.u0.clone()
    r_map, f_map = trainer._dis_maps(state.discriminator, image, recon)
    assert r_map.shape == f_map.shape == (2, TREE_SIZE, TREE_SIZE, 1)
    assert float(r_map.abs().max()) > 0 and float(f_map.abs().max()) > 0
    assert state.discriminator.training  # back in train mode
    assert torch.equal(state.discriminator.linear_middle.u0, u_before)  # eval: u not stored
    kw = dict(dataset_name="NCCLungDataset", dict_size=10, n_save_images=2)
    with_maps = evaluate.validation_snapshot(forward, {"image": image}, dis_maps=(r_map, f_map),
                                             forward_outputs=(recon, ids),
                                             save_path=str(tmp_path / "maps.png"), **kw)
    zeros = evaluate.validation_snapshot(forward, {"image": image},
                                         save_path=str(tmp_path / "zeros.png"), **kw)
    assert open(with_maps, "rb").read() != open(zeros, "rb").read()


def test_second_stage_nlayer_cli_trains_and_tests(gan_env):
    run = _cli(gan_env.root, "gan_nlayer", ["-m", "train", "--max-steps", "2"], dis="nlayer")
    rows = _csv(run / "version_0" / "log.csv")
    assert [r["iteration"] for r in rows] == [1, 2]
    assert all(r["cutmix"] == r["consistency"] == 0.0 and np.isfinite(r["total"])
               for r in rows)
    tested = _cli(gan_env.root, "gan_nlayer_test", ["-m", "test"], dis="nlayer",
                  resume_checkpoint=str(run / "version_0" / "ckpt"))
    assert (tested / "version_0" / "result.csv").exists()


def test_discriminator_ckpt_path_from_directory_and_reference_ckpt(gan_env, gan_fit):
    """`run.discriminator_ckpt_path`: a port checkpoint directory (its
    `discriminator` field), and a Lightning `.ckpt` in the reference's keys
    (the JAX package's export, unused `linear.*` included)."""
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils.checkpoint import CheckpointManager
    from medical_image_editing_tpu_torch.utils.config import to_config

    want = gan_fit.state.discriminator.state_dict()
    directory = gan_env.root / "dis_dir" / "ckpt"
    CheckpointManager(str(directory)).save(gan_fit.state, 0)
    jm = JUNetD(D_ch=4, D_attn="0", resolution=128)
    jvars = _np(jax.jit(lambda k, x: jm.init(k, x, False))(
        jax.random.key(11), jnp.zeros((1, 64, 64, 1))))
    ref = export_unet_discriminator(jvars, jm)
    lightning = gan_env.root / "dis.ckpt"
    torch.save({"state_dict": {f"discriminator.{k}": torch.from_numpy(np.array(v))
                               for k, v in ref.items()}}, lightning)
    for path, expected in ((directory, want),
                           (lightning, bridge.from_jax_unet_discriminator(jvars))):
        cfg = _second_config(gan_env.root, discriminator_ckpt_path=str(path))
        state = Trainer(to_config(cfg), device="cpu").init_state()
        got = state.discriminator.state_dict()
        assert sorted(got) == sorted(expected)
        assert all(torch.equal(got[k], expected[k]) for k in got), path
        assert not state.dis_opt.state
