"""The editing service's inference path, port vs JAX package, end to end at
small size on the CPU: encode (`make_eval_forward`) → label map → painted map
→ decode (`make_batched_edit_fn`, `edit_study`, `make_edit_fn` +
`process_edit`), plus model loading from a Lightning `.ckpt`.

Both decoders get the JAX encoder's ids, so a near-tie id flip in the encoder
cannot move the decode comparison. Tolerances: atol 1e-4 on f32 images (as
for the models; ×4096/1500 after the lung re-window), 1 LSB on uint8 images (a truncating cast of values that
agree to 1e-4).
"""

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.cli import edit_batch as jeb
from medical_image_editing_tpu.cli import run_recon as jrr
from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ as JEncoder
from medical_image_editing_tpu.ops import vq as jvq
from medical_image_editing_tpu.train.evaluate import make_eval_forward as j_eval_forward
from medical_image_editing_tpu.utils import nifti as jnifti
from medical_image_editing_tpu.utils import torch_export
from medical_image_editing_tpu_torch.cli import edit_batch as teb
from medical_image_editing_tpu_torch.cli import run_recon as trr
from medical_image_editing_tpu_torch.train.evaluate import make_eval_forward
from medical_image_editing_tpu_torch.utils import nifti as tnifti
from test_torch_port_models import (
    DEC,
    DICT,
    ENC,
    jax_decoder,
    jax_encoder,
    port_decoder,
    port_encoder,
)

ATOL = 1e-4
# the lung re-window maps the dataset window (width 4096) onto the lung
# window (width 1500): decoder differences grow by 4096/1500
LUNG_ATOL = ATOL * 4096 / 1500


class State(NamedTuple):
    enc_vars: dict
    vq: jvq.VQState
    dec_vars: dict


def _images(n=4, size=32, seed=11):
    """Gaussian "nodules" on an intensity gradient (as tools/demo_edit.py)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    imgs = []
    for _ in range(n):
        img = 0.4 * (yy - 0.5) + 0.1 * rng.normal()
        for _ in range(3):
            cy, cx = rng.uniform(0.2, 0.8, 2)
            s, a = rng.uniform(0.05, 0.1), rng.uniform(0.5, 0.9)
            img = img + a * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s**2)))
        imgs.append(np.clip(img, -1, 1))
    return np.stack(imgs)[..., None].astype(np.float32)


def _paint(ids, seed=12):
    """Insert a disc of one id and clear a band to background (0)."""
    rng = np.random.default_rng(seed)
    ids = np.array(ids, dtype=np.int32)
    b, h, w = ids.shape
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(b):
        cy, cx = rng.integers(8, h - 8, 2)
        ids[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= 25] = rng.integers(1, DICT + 1)
        ids[i][: 4 + i] = 0
    return ids


@pytest.fixture(scope="module")
def models():
    _, enc_vars, vq = jax_encoder(seed=3)
    jdec, dec_vars = jax_decoder(seed=4)
    jenc = JEncoder(filters=ENC, dict_size=DICT, knn_backend="pallas")
    state = State(enc_vars, jvq.VQState(*map(jnp.asarray, vq)), dec_vars)
    penc = port_encoder(enc_vars, vq, backend="pallas")
    pdec = port_decoder(dec_vars)
    return jenc, jdec, state, penc, pdec


def penc_state(models):
    return models[3].vq.state()


@pytest.fixture(scope="module")
def painted(models):
    jenc, jdec, state, _, _ = models
    with jax.default_matmul_precision("highest"):
        _, ids = j_eval_forward(jenc, jdec)(state, jnp.asarray(_images()))
    return _paint(np.asarray(ids))


def test_eval_forward_matches_jax(models):
    jenc, jdec, state, penc, pdec = models
    x = _images()
    with jax.default_matmul_precision("highest"):
        jrecon, jids = j_eval_forward(jenc, jdec)(state, jnp.asarray(x))
    recon, ids = make_eval_forward(penc, pdec, device="cpu")(torch.from_numpy(x))
    assert recon.shape == x.shape and ids.dtype == torch.int32
    # the encoder features agree to ~1e-4: ids may flip only at near ties
    agree = (ids.numpy() == np.asarray(jids)).mean()
    assert agree > 0.99, agree
    if agree == 1.0:
        np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon), atol=ATOL, rtol=0)


@pytest.mark.parametrize("is_lung", [False, True])
@pytest.mark.parametrize("output_dtype", [None, "uint8"])
@pytest.mark.parametrize("microbatch", [None, 2])
def test_batched_edit_matches_jax(models, painted, is_lung, output_dtype, microbatch):
    _, jdec, state, _, pdec = models
    kw = dict(is_lung=is_lung, output_dtype=output_dtype, microbatch=microbatch)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jeb.make_batched_edit_fn(jdec, **kw)(
            state.dec_vars, state.vq, jnp.asarray(painted)))
    vq = penc_state(models)
    got = teb.make_batched_edit_fn(pdec, device="cpu", **kw)(vq, painted).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if output_dtype == "uint8":
        assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=LUNG_ATOL if is_lung else ATOL,
                                   rtol=0)


def test_microbatch_must_divide(models, painted):
    edit = teb.make_batched_edit_fn(models[4], microbatch=3, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        edit(penc_state(models), painted)


def test_edit_study_matches_jax(models, painted, tmp_path):
    _, jdec, state, _, pdec = models
    label_dir = tmp_path / "labels"
    label_dir.mkdir()
    for i, m in enumerate(painted):
        jnifti.save(jnifti.to_nifti_array(m), str(label_dir / f"label_{i:04d}.nii.gz"),
                    dtype=np.int32)
    with jax.default_matmul_precision("highest"):
        jw = jeb.edit_study(jdec, state, str(label_dir), str(tmp_path / "jax"),
                            batch_size=3, is_lung=True)
    tw = teb.edit_study(pdec, penc_state(models), str(label_dir), str(tmp_path / "port"),
                        batch_size=3, is_lung=True, device="cpu")
    assert tw == jw and len(tw) == len(painted)
    for name in tw:
        np.testing.assert_allclose(tnifti.load(str(tmp_path / "port" / name)),
                                   jnifti.load(str(tmp_path / "jax" / name)),
                                   atol=LUNG_ATOL, rtol=0)


@pytest.mark.parametrize("config_name", ["LungConfig", "CRCConfig"])
def test_edit_fn_and_process_edit_match_jax(models, painted, config_name, tmp_path):
    _, jdec, state, _, pdec = models
    jcfg = getattr(jrr, config_name)()
    tcfg = getattr(trr, config_name)()
    for cfg in (jcfg, tcfg):
        cfg.edited_file_path = "edited.nii.gz"
    with jax.default_matmul_precision("highest"):
        jfn = jrr.make_edit_fn(jdec, state, jcfg)
        jrecon, jids = jrr.process_edit(jfn, jcfg, painted[1],
                                        save_dir=str(tmp_path / "jax"))
    tfn = trr.make_edit_fn(pdec, penc_state(models), tcfg, device="cpu")
    trecon, tids = trr.process_edit(tfn, tcfg, painted[1], save_dir=str(tmp_path / "port"))
    atol = LUNG_ATOL if config_name == "LungConfig" else ATOL
    np.testing.assert_allclose(trecon, jrecon, atol=atol, rtol=0)
    np.testing.assert_array_equal(tids, jids)
    assert len(os.listdir(tmp_path / "port")) == 2  # recon + label PNGs


def test_load_model_reads_lightning_ckpt(models, tmp_path, monkeypatch):
    _, _, state, penc, pdec = models
    path = torch_export.save_lightning_ckpt(str(tmp_path / "lung.ckpt"), {
        "encoder": torch_export.export_unet_encoder(state.enc_vars, state.vq),
        "decoder": torch_export.export_unet_decoder(state.dec_vars),
    })
    monkeypatch.setenv("LUNG_CKPT", path)
    cfg = trr.LungConfig()
    cfg.enc_filters, cfg.dec_filters, cfg.dict_size = ENC, DEC, DICT
    enc, dec, vq_state = trr.load_model(cfg, device="cpu")
    for got, want in ((enc, penc), (dec, pdec)):
        for key, value in want.state_dict().items():
            assert torch.equal(got.state_dict()[key], value), key
    assert not enc.training and not dec.training
    np.testing.assert_array_equal(vq_state.embed.numpy(), np.asarray(state.vq[0]))

    monkeypatch.setenv("LUNG_CKPT", str(tmp_path))
    with pytest.raises(ValueError, match="export_ckpt"):
        trr.load_model(trr.LungConfig(), device="cpu")


def test_load_model_is_seeded():
    cfg = trr.LungConfig()
    cfg.resume_checkpoint = None
    cfg.enc_filters, cfg.dec_filters, cfg.dict_size = ENC, DEC, DICT
    a = trr.load_model(cfg, device="cpu", seed=5)
    b = trr.load_model(cfg, device="cpu", seed=5)
    c = trr.load_model(cfg, device="cpu", seed=6)
    sa, sb, sc = (m[1].state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    assert torch.equal(a[2].embed, b[2].embed)


def test_load_edited_map_matches_jax(painted, tmp_path):
    path = str(tmp_path / "edited.nii.gz")
    jnifti.save(jnifti.to_nifti_array(painted[0]), path, dtype=np.int32)
    got = trr.load_edited_map(path)
    np.testing.assert_array_equal(got, jrr.load_edited_map(path))
    np.testing.assert_array_equal(got, painted[0])
