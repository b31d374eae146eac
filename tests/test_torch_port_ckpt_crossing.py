"""Checkpoint crossings between the JAX package, the reference format and
the PyTorch port, on the CPU at toy widths:

  * JAX models written by the JAX package's `utils/torch_export.py` (what
    its `export-ckpt` writes) and imported by the port's `import_ckpt`: the
    port then encodes the ids JAX encodes and decodes within the slice
    tests' tolerance, for the first stage, the U-Net discriminator, the
    PatchGAN (spectral norm and ActNorm) and the VQGAN (`-v`);
  * the port's `export_ckpt`, read back by the JAX package's
    `utils/torch_import.py` with its strict import: the same agreement, and
    the file's keys are the JAX export's;
  * port → `export_ckpt` → `import_ckpt` leaves every model tensor bit
    identical (ActNorm: its affine, which the reference format folds) and
    keeps epoch and step;
  * fault C.4: a checkpoint of the port's `run_vqwnet` serves through
    `run_recon.load_model` (`LUNG_CKPT`), decoding bit for bit what the
    trained state's own modules decode; an Orbax directory is refused.

Tolerances: atol 1e-4 on f32 images and discriminator outputs (×4096/1500
after the lung re-window; discriminator maps relative to their largest
magnitude), as `tests/test_torch_port_slice.py`; ids equal wherever the
encoders are not at a near tie (≥ 99% agree, as there).
"""

import json
import os
from types import SimpleNamespace
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.cli import edit_batch as jeb
from medical_image_editing_tpu.models import vqgan as jvqgan
from medical_image_editing_tpu.models.discriminator import NLayerDiscriminator as JNLayer
from medical_image_editing_tpu.models.unet_discriminator import UNetDiscriminator as JUNetD
from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ as JEncoder
from medical_image_editing_tpu.ops import vq as jvq
from medical_image_editing_tpu.train.evaluate import make_eval_forward as j_eval_forward
from medical_image_editing_tpu.utils import torch_export as jte
from medical_image_editing_tpu.utils import torch_import as jti
from medical_image_editing_tpu_torch.cli import edit_batch as teb
from medical_image_editing_tpu_torch.cli import export_ckpt, import_ckpt, run_recon, run_vqwnet
from medical_image_editing_tpu_torch.models.actnorm import ActNorm
from medical_image_editing_tpu_torch.train.evaluate import make_eval_forward
from medical_image_editing_tpu_torch.train.trainer import Trainer
from medical_image_editing_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    load_state_file,
    resolve,
    restore_state,
)
from medical_image_editing_tpu_torch.utils.config import to_config
from medical_image_editing_tpu_torch.utils.torch_import import read_ckpt_meta
from test_torch_port_models import DEC, DICT, ENC, jax_decoder, jax_encoder
from test_torch_port_trainer import _lung_tree

ROOT = os.path.join(os.path.dirname(__file__), "..", "configs")
ATOL = 1e-4
LUNG_ATOL = ATOL * 4096 / 1500
SIZE = 32
KINDS = ["first_stage", "unet", "patchgan", "vqgan"]
VQGAN_CFG = dict(mid_channels=4, emb_dim=8, dict_size=6, enc_ch_multiplier=[1, 2, 4],
                 dec_ch_multiplier=[1, 2, 4], num_res_blocks=1, enc_attn_resolutions=[],
                 dec_attn_resolutions=[8], resolution=SIZE, knn_backend="xla")
UNET_DIS = dict(model_name="UNetDiscriminator", D_ch=4, D_attn="0", resolution=128)
PATCH_DIS = dict(model_name="NLayerDiscriminator", n_filters=4, n_layers=2,
                 normalization="actnorm", apply_spectral_norm=True)


class State(NamedTuple):
    enc_vars: dict
    vq: jvq.VQState
    dec_vars: dict


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _images(n=2, seed=11):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    imgs = []
    for _ in range(n):
        img = 0.4 * (yy - 0.5) + 0.1 * rng.normal()
        for _ in range(3):
            cy, cx = rng.uniform(0.2, 0.8, 2)
            s, a = rng.uniform(0.05, 0.1), rng.uniform(0.5, 0.9)
            img = img + a * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s**2)))
        imgs.append(np.clip(img + 0.1 * rng.normal(size=img.shape), -1, 1))
    return np.stack(imgs)[..., None].astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL * max(float(np.abs(want).max()),
                                                                     1.0))


def _config(kind):
    """The config JSON the port's CLIs build the models from, at the JAX
    models' widths."""
    if kind == "vqgan":
        cfg = json.load(open(os.path.join(ROOT, "crc_vqgan.json")))
        cfg["model"]["vqgan"].update(VQGAN_CFG)
        cfg["model"]["dis"].update(UNET_DIS)
    else:
        cfg = json.load(open(os.path.join(ROOT, "lung_first_stage.json")))
        cfg["model"]["vqmodel"].update(enc_filters=list(ENC), dec_filters=list(DEC),
                                       dict_size=DICT, knn_backend="xla",
                                       compute_dtype="float32", dropped_skip_layers=[],
                                       use_pixel_shuffle=False)
        cfg["model"]["dis"] = dict(PATCH_DIS if kind == "patchgan" else UNET_DIS)
        cfg["run"]["training_mode"] = "first_step" if kind == "first_stage" else "second_step"
    cfg["dataset"].update(image_size=[SIZE, SIZE], batch_size=2, num_workers=0)
    return cfg


def _write_config(tmp, kind):
    path = tmp / f"{kind}.json"
    path.write_text(json.dumps(_config(kind)))
    return str(path)


def _vqgan_kw():
    return {k: tuple(v) if isinstance(v, list) else v for k, v in VQGAN_CFG.items()
            if k != "knn_backend"} | dict(in_channels=1, out_channels=1)


@pytest.fixture(scope="module")
def jax_models():
    """The JAX package's models at the test widths, their variables
    perturbed (encoder, decoder) or run once in train mode (the
    discriminators' spectral-norm vectors and ActNorm statistics), and a
    VQGAN with its codebook."""
    jenc = JEncoder(filters=ENC, dict_size=DICT)
    _, enc_vars, vq = jax_encoder(seed=3)
    jdec, dec_vars = jax_decoder(seed=4)
    x = jnp.asarray(_images(2, seed=5))
    big = jnp.asarray(np.random.default_rng(6).normal(size=(2, 128, 128, 1)).astype(np.float32))

    unet = JUNetD(**{k: v for k, v in UNET_DIS.items() if k != "model_name"})
    unet_vars = jax.jit(lambda k: unet.init(k, big[:1], False))(jax.random.key(7))
    _, upd = jax.jit(lambda v: unet.apply(v, big, True, mutable=["batch_stats"]))(unet_vars)
    unet_vars = _np({**unet_vars, **upd})

    patch = JNLayer(**{k: v for k, v in PATCH_DIS.items() if k != "model_name"})
    patch_vars = jax.jit(lambda k: patch.init(k, x, train=False))(jax.random.key(8))
    extra = {k: v for k, v in patch_vars.items() if k != "params"}
    _, extra = patch.apply({"params": patch_vars["params"], **extra}, x, True,
                           mutable=list(extra))
    patch_vars = _np({"params": patch_vars["params"], **extra})

    vqgan = jvqgan.VQGAN(**_vqgan_kw(), knn_backend="xla")
    gvq = jvq.vq_init(jax.random.key(9), VQGAN_CFG["dict_size"], VQGAN_CFG["emb_dim"])
    gvars = jax.jit(lambda k: vqgan.init(k, x[:1], gvq, train=False))(jax.random.key(10))
    return SimpleNamespace(
        jenc=jenc, jdec=jdec, state=State(enc_vars, jvq.VQState(*map(jnp.asarray, vq)),
                                          dec_vars),
        unet=unet, unet_vars=unet_vars, patch=patch, patch_vars=patch_vars,
        vqgan=vqgan, vqgan_vars=_np(gvars), vqgan_vq=_np(gvq))


def _jax_named(jm, kind):
    """What the JAX package's `export-ckpt` writes for `kind`."""
    if kind == "vqgan":
        named = {"decoder": jte.export_vqgan(jm.vqgan_vars, jm.vqgan_vq, jm.vqgan)}
    else:
        named = {"encoder": jte.export_unet_encoder(jm.state.enc_vars, jm.state.vq),
                 "decoder": jte.export_unet_decoder(jm.state.dec_vars)}
    if kind in ("unet", "vqgan"):
        named["discriminator"] = jte.export_unet_discriminator(jm.unet_vars, jm.unet)
    elif kind == "patchgan":
        named["discriminator"] = jte.export_nlayer_discriminator(jm.patch_vars)
    return named


def _port_state(cfg_path, kind, ckpt_dir=None):
    cfg = to_config(json.load(open(cfg_path)))
    trainer = Trainer(cfg, use_vqgan=kind == "vqgan", device="cpu")
    state = trainer.init_state(load_staged=False, with_discriminator=kind != "first_stage")
    if ckpt_dir is not None:
        restore_state(ckpt_dir, state)
    return state


def _ids(seed=12):
    return np.random.default_rng(seed).integers(0, DICT + 1, (2, SIZE, SIZE)).astype(np.int32)


def _agree_first_stage(penc, pdec, jm, state):
    """The port's encode ids against JAX's, and the decode of JAX's painted
    ids through both, lung-windowed."""
    x = _images()
    with jax.default_matmul_precision("highest"):
        jrecon, jids = j_eval_forward(jm.jenc, jm.jdec)(state, jnp.asarray(x))
        jedit = np.asarray(jeb.make_batched_edit_fn(jm.jdec, is_lung=True)(
            state.dec_vars, state.vq, jnp.asarray(_ids())))
    recon, ids = make_eval_forward(penc, pdec, device="cpu")(torch.from_numpy(x))
    agree = (ids.numpy() == np.asarray(jids)).mean()
    assert agree > 0.99, agree
    if agree == 1.0:
        np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon), atol=ATOL, rtol=0)
    edit = teb.make_batched_edit_fn(pdec, is_lung=True, device="cpu")(penc.vq.state(), _ids())
    np.testing.assert_allclose(edit.numpy(), jedit, atol=LUNG_ATOL, rtol=0)


def _agree_discriminator(dis, jdis, jvars, kind):
    x = np.random.default_rng(13).normal(size=(2, 128 if kind == "unet" else SIZE,
                                               128 if kind == "unet" else SIZE, 1))
    x = x.astype(np.float32)
    want = jax.jit(lambda v, a: jdis.apply(v, a, False))(jvars, jnp.asarray(x))
    dis.eval()
    with torch.no_grad():
        got = dis(_nchw(x))
    if kind == "unet":
        _close(got[0].permute(0, 2, 3, 1).numpy(), want[0])
        _close(got[1].numpy(), want[1])
    else:
        _close(got.permute(0, 2, 3, 1).numpy(), want)


def _agree_vqgan(vqgan, jm, gvars, gvq):
    x = _images()
    _, _, jids, _, _ = jm.vqgan.apply(gvars, jnp.asarray(x), gvq, False)
    vqgan.eval()
    with torch.no_grad():
        _, _, ids, _ = vqgan(_nchw(x), train=False)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        paint = np.random.default_rng(14).integers(0, VQGAN_CFG["dict_size"], (2, 8, 8))
        got = vqgan.generate_image_from_ids(torch.from_numpy(paint.astype(np.int32)))
    want = jm.vqgan.apply(gvars, jnp.asarray(paint.astype(np.int32)), gvq,
                          method=jm.vqgan.generate_image_from_ids)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_export_imports_into_the_port(jax_models, tmp_path, kind):
    jm = jax_models
    ckpt = str(tmp_path / "jax.ckpt")
    jte.save_lightning_ckpt(ckpt, _jax_named(jm, kind), epoch=3, step=17)
    cfg = _write_config(tmp_path, kind)
    out = tmp_path / "imported"
    argv = ["-c", cfg, "--ckpt", ckpt, "--out", str(out), "--device", "cpu"]
    assert import_ckpt.main(argv + (["-v"] if kind == "vqgan" else [])) == 0
    assert sorted(os.listdir(out)) == ["ckpt-epoch=0003"]
    state = _port_state(cfg, kind, str(out))
    assert (state.epoch, state.step) == (3, 17)
    if kind == "vqgan":
        _agree_vqgan(state.decoder, jm, jm.vqgan_vars, jm.vqgan_vq)
    else:
        _agree_first_stage(state.encoder, state.decoder, jm, jm.state)
    if kind in ("unet", "vqgan"):
        _agree_discriminator(state.discriminator, jm.unet, jm.unet_vars, "unet")
    elif kind == "patchgan":
        _agree_discriminator(state.discriminator, jm.patch, jm.patch_vars, kind)


def _trained_port_checkpoint(tmp_path, cfg, kind):
    """A port state at its seeded init with its discriminator run once in
    train mode (spectral-norm vectors moved, ActNorms initialised), saved
    at epoch 3, step 17."""
    state = _port_state(cfg, kind)
    if state.discriminator is not None:
        size = 128 if kind in ("unet", "vqgan") else SIZE
        x = torch.from_numpy(np.random.default_rng(15).normal(
            size=(2, 1, size, size)).astype(np.float32))
        state.discriminator.train()
        with torch.no_grad():
            state.discriminator(x)
    state.epoch, state.step = 3, 17
    return CheckpointManager(str(tmp_path / "port")).save(state, epoch=3), state


@pytest.mark.parametrize("kind", KINDS)
def test_port_export_reads_into_jax(jax_models, tmp_path, kind):
    """`export_ckpt`'s file: the JAX export's keys, and JAX's strict import
    of it computes what the port computes."""
    jm = jax_models
    cfg = _write_config(tmp_path, kind)
    ckpt_dir, state = _trained_port_checkpoint(tmp_path, cfg, kind)
    out = str(tmp_path / "port.ckpt")
    argv = ["-c", cfg, "--ckpt", str(tmp_path / "port"), "--out", out, "--device", "cpu"]
    assert export_ckpt.main(argv + (["-v"] if kind == "vqgan" else [])) == 0
    sd, meta = jti.load_reference_ckpt(out)
    assert meta == {"epoch": 3, "step": 17} == read_ckpt_meta(out)
    want_keys = {f"{g}.{k}" for g, part in _jax_named(jm, kind).items() for k in part}
    assert set(sd) == want_keys
    if kind == "vqgan":
        gvars, gvq = jti.import_vqgan(sd, "decoder.", target_vars=jm.vqgan_vars,
                                      target_vq=jm.vqgan_vq)
        _agree_vqgan(state.decoder, jm, gvars, gvq)
    else:
        enc_vars = jti.import_unet_encoder(sd, "encoder.", target_vars=jm.state.enc_vars)
        vq = jti.import_vq_state(sd, "encoder.vq.", target=jm.state.vq)
        dec_vars = jti.import_unet_decoder(sd, "decoder.", target_vars=jm.state.dec_vars)
        _agree_first_stage(state.encoder, state.decoder, jm, State(enc_vars, vq, dec_vars))
    if kind in ("unet", "vqgan"):
        dis_vars = jti.import_unet_discriminator(sd, "discriminator.",
                                                 target_vars=jm.unet_vars)
        _agree_discriminator(state.discriminator, jm.unet, dis_vars, "unet")
    elif kind == "patchgan":
        dis_vars = jti.import_nlayer_discriminator(sd, "discriminator.",
                                                   target_vars=jm.patch_vars)
        _agree_discriminator(state.discriminator, jm.patch, dis_vars, kind)


def _effective(module_sd, modules):
    """A state dict with each ActNorm's affine in place of its four tensors."""
    sd = dict(module_sd)
    for name in modules:
        p = f"{name}."
        sd[p + "loc"] = sd[p + "loc"] + sd.pop(p + "data_loc")
        sd[p + "scale"] = sd[p + "scale"] * sd.pop(p + "data_scale")
    return sd


@pytest.mark.parametrize("kind", KINDS)
def test_port_round_trip_is_bit_identical(tmp_path, kind):
    cfg = _write_config(tmp_path, kind)
    ckpt_dir, state = _trained_port_checkpoint(tmp_path, cfg, kind)
    out = str(tmp_path / "port.ckpt")
    v = ["-v"] if kind == "vqgan" else []
    assert export_ckpt.main(["-c", cfg, "--ckpt", ckpt_dir, "--out", out, "--device",
                             "cpu"] + v) == 0
    back = tmp_path / "back"
    assert import_ckpt.main(["-c", cfg, "--ckpt", out, "--out", str(back), "--device",
                             "cpu"] + v) == 0
    before, after = load_state_file(ckpt_dir), load_state_file(resolve(str(back)))
    assert (after["epoch"], after["step"]) == (3, 17)
    parts = [p for p in ("encoder", "decoder", "discriminator") if p in before]
    assert parts == [p for p in ("encoder", "decoder", "discriminator") if p in after]
    actnorms = ([n for n, m in state.discriminator.named_modules() if isinstance(m, ActNorm)]
                if kind == "patchgan" else [])
    assert bool(actnorms) == (kind == "patchgan")
    for part in parts:
        a, b = before[part], after[part]
        if part == "discriminator" and actnorms:
            assert any(a[f"{n}.data_loc"].any() for n in actnorms)  # initialised
            a, b = _effective(a, actnorms), _effective(b, actnorms)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (part, k)


def test_import_refuses_a_file_without_models(tmp_path):
    ckpt = str(tmp_path / "other.ckpt")
    torch.save({"state_dict": {"generator.w": torch.zeros(2)}, "epoch": 1}, ckpt)
    cfg = _write_config(tmp_path, "first_stage")
    with pytest.raises(SystemExit, match="no encoder./decoder./discriminator. keys"):
        import_ckpt.main(["-c", cfg, "--ckpt", ckpt, "--out", str(tmp_path / "o"),
                          "--device", "cpu"])


def test_import_is_strict(jax_models, tmp_path):
    """A key the configured model does not have, or one it misses, is
    refused with the key named; `num_batches_tracked` may be absent."""
    named = _jax_named(jax_models, "first_stage")
    cfg = _write_config(tmp_path, "first_stage")
    for edit, match in ((lambda n: n["decoder"].update(extra=np.zeros(1, np.float32)),
                         "not consumed"),
                        (lambda n: n["encoder"].pop("double_conv1.double_conv.0.bias"),
                         "missing")):
        bad = {g: dict(part) for g, part in named.items()}
        edit(bad)
        path = str(tmp_path / "bad.ckpt")
        jte.save_lightning_ckpt(path, bad)
        with pytest.raises(ValueError, match=match):
            import_ckpt.main(["-c", cfg, "--ckpt", path, "--out", str(tmp_path / "o"),
                              "--device", "cpu"])
    lean = {g: {k: v for k, v in part.items() if not k.endswith("num_batches_tracked")}
            for g, part in named.items()}
    path = str(tmp_path / "lean.ckpt")
    jte.save_lightning_ckpt(path, lean)
    assert import_ckpt.main(["-c", cfg, "--ckpt", path, "--out", str(tmp_path / "o"),
                             "--device", "cpu"]) == 0


# -- fault C.4: the serving CLIs load the port's own checkpoints --------------


class _Tiny(run_recon.LungConfig):
    enc_filters = ENC
    dec_filters = DEC
    dict_size = DICT

    def __init__(self, ckpt):
        super().__init__()
        self.resume_checkpoint = ckpt


def test_port_run_serves_through_load_model(tmp_path, monkeypatch):
    """`run_vqwnet` trains 2 steps; `load_model` with `LUNG_CKPT` at the
    run's checkpoint directory, and at its `ckpt-epoch=...`, decodes a
    painted map bit for bit as the trained state's own modules do, through
    `make_edit_fn` and through `edit_batch`'s batched edit."""
    _lung_tree(tmp_path / "data")
    cfg = _config("first_stage")
    cfg["dataset"]["root_dir_path"] = str(tmp_path / "data")
    cfg["model"]["vqmodel"]["use_init_embed"] = False
    cfg["save"].update(save_dir=str(tmp_path / "results"), study_name="c4", n_save_images=2)
    cfg["run"]["n_epochs"] = 1
    path = tmp_path / "c4.json"
    path.write_text(json.dumps(cfg))
    assert run_vqwnet.main(["-c", str(path), "-m", "train", "--max-steps", "2",
                            "--device", "cpu"]) == 0
    run_dir = tmp_path / "results" / "c4" / "version_0" / "ckpt"
    (only,) = os.listdir(run_dir)
    trained = _port_state(str(path), "first_stage", str(run_dir))
    assert trained.step == 2
    ids = _ids(16)
    window = (4096.0, 0.0, 2.0)
    with torch.no_grad():
        want, _ = teb.decode_painted(trained.decoder.eval(), trained.vq, torch.from_numpy(ids),
                                     is_lung=True, dataset_window=window, per_slice=False)
        want_batched, _ = teb.decode_painted(trained.decoder, trained.vq,
                                             torch.from_numpy(ids), is_lung=True,
                                             dataset_window=window)
    for ckpt in (run_dir, run_dir / only):
        monkeypatch.setenv("LUNG_CKPT", str(ckpt))
        config = _Tiny(os.environ["LUNG_CKPT"])
        enc, dec, vq = run_recon.load_model(config, device="cpu")
        for name, t in trained.encoder.state_dict().items():
            assert torch.equal(enc.state_dict()[name], t), name
        recon, _ = run_recon.make_edit_fn(dec, vq, config, device="cpu")(ids)
        assert np.array_equal(recon, want.numpy())
        got = teb.make_batched_edit_fn(dec, is_lung=True, device="cpu")(vq, ids)
        assert torch.equal(got, want_batched)


def test_load_model_refuses_an_orbax_directory(tmp_path):
    """A checkpoint directory without `state.pt` (the JAX package's Orbax
    layout) is refused, pointing at the way across."""
    orbax = tmp_path / "ckpt" / "ckpt-epoch=0000"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    for path in (tmp_path / "ckpt", orbax):
        with pytest.raises(ValueError, match="export-ckpt.*import_ckpt"):
            run_recon.load_model(_Tiny(str(path)), device="cpu")
