"""The VQGAN trainer through `run_vqwnet -v` on the CPU, port vs JAX package:
over a fabricated CRC tree (2 patients × 4 slices of 32², 0-255 valued,
batch 2: 4 steps an epoch), `configs/crc_vqgan.json` shrunk to the JAX
package's test widths (`mid_channels` 4, `emb_dim` 8, `dict_size` 6,
multipliers (1, 2, 4), one res block a level, decoder attention at 8²,
resolution 32) and the U-Net discriminator at `D_ch` 4, resolution 128:
* `-m train --max-steps 3` trains (finite losses, no codebook k-means, a
  checkpoint with the VQGAN and its codebook in the decoder slot, the
  discriminator and both Adams, no encoder);
* a run resumed mid-way (3 steps, a resume to 5, across the epoch end)
  equals an uninterrupted one bit for bit;
* `-m test` from a checkpoint of the JAX trainer's initial state writes
  the `result.csv` of the JAX trainer's VQGAN test on that state (NMSE,
  SSIM and PSNR rtol 1e-5: the reconstructions agree to the forward's
  f32 floor, `tests/test_torch_port_vqgan.py`; the label entropy of
  ids + 1 exactly, the ids being equal);
* `"training_mode": "inference"` exports JAX's 0-based label maps exactly,
  image and recon within atol 1e-5;
* `validate_config(vqgan=True)` returns JAX's warnings, or raises JAX's
  message;
* the trainer's wiring: the VQGAN's EMA momentum is the class default
  0.99, not `vqmodel.momentum`, as the JAX trainer builds it; the
  discriminator is built in `first_step`; a reference VQGAN `.ckpt`
  (`decoder.` field) stages with `strict=True`; `-v` and
  `model_name: "VQGAN"` go together; the PatchGAN with actnorm trains in
  the second stage.
"""

import copy
import csv
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.utils.config import to_config as j_to_config
from medical_image_editing_tpu.utils.config import validate_config as j_validate_config
from medical_image_editing_tpu_torch.utils import nifti
from medical_image_editing_tpu_torch.utils.checkpoint import CheckpointManager, load_state_file
from medical_image_editing_tpu_torch.utils.config import to_config, validate_config
from test_torch_port_trainer import _csv

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "crc_vqgan.json")
SIZE = 32
VQGAN_CFG = dict(mid_channels=4, emb_dim=8, dict_size=6, enc_ch_multiplier=[1, 2, 4],
                 dec_ch_multiplier=[1, 2, 4], num_res_blocks=1, dec_attn_resolutions=[8],
                 resolution=SIZE)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors (several test workers
    share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crc_tree(root, n_patients=2, n_slices=4, seed=0):
    """`root/patNN/slice_SSSS.npy`: smooth 0-255 slices with a blob."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    for p in range(n_patients):
        d = root / f"pat{p:02d}"
        d.mkdir(parents=True)
        for s in range(n_slices):
            img = 60 + 80 * yy + 100 * np.exp(
                -((yy - rng.uniform(0.3, 0.7)) ** 2 + (xx - rng.uniform(0.3, 0.7)) ** 2) / 0.02)
            img = np.clip(img + rng.normal(0, 10, img.shape), 0, 255)
            np.save(d / f"slice_{s:04d}.npy", img.astype(np.float32))
    return root


def _config(root, **run):
    cfg = json.load(open(CONFIG))
    cfg["dataset"].update(root_dir_path=str(root / "data"), batch_size=2, num_workers=0,
                          image_size=[SIZE, SIZE])
    cfg["model"]["vqgan"].update(VQGAN_CFG)
    cfg["model"]["dis"].update(D_ch=4, resolution=128)
    cfg["save"].update(save_dir=str(root / "results"), n_save_images=2)
    cfg["run"].update({"n_epochs": 1, **run})
    return cfg


def _cli(root, name, argv, save_dir=None, **run):
    from medical_image_editing_tpu_torch.cli import run_vqwnet

    cfg = _config(root, n_epochs=2, **run)
    cfg["save"].update(study_name=name, save_every_n_steps=3)
    if save_dir is not None:
        cfg["save"]["save_dir"] = str(save_dir)
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    assert run_vqwnet.main(["-v", "-c", str(path), "--device", "cpu", *argv]) == 0
    return root / "results" / name


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The tree, the JAX trainer's initial VQGAN state (numpy), its VQGAN
    test (`result.csv`) and its inference export of that state."""
    from medical_image_editing_tpu.train.trainer import Trainer as JTrainer

    root = tmp_path_factory.mktemp("vqgan_trainer")
    _crc_tree(root / "data")
    jt = JTrainer(j_to_config(_config(root)), use_vqgan=True, rng_key=jax.random.key(3),
                  devices=jax.devices()[:1])
    state = jt.init_state(SIZE, 2)
    _, jresult = jt.test(state, save_dir_path=str(root / "jax_test"))
    icfg = _config(root, training_mode="inference")
    icfg["save"]["save_dir"] = str(root / "jax_export")
    ji = JTrainer(j_to_config(icfg), use_vqgan=True, devices=jax.devices()[:1])
    jwritten = ji.test(state)
    s0 = SimpleNamespace(**{f: jax.tree.map(np.asarray, getattr(state, f))
                            for f in ("enc_vars", "dec_vars", "vq", "dis_vars")})
    return SimpleNamespace(root=root, s0=s0, jresult=jresult, jwritten=jwritten,
                           jroot=root / "jax_export" / icfg["save"]["study_name"])


def _jax_state_ckpt(env, name):
    """A port checkpoint of the JAX trainer's initial state."""
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils.weights import load_jax_train_state

    trainer = Trainer(to_config(_config(env.root)), use_vqgan=True, device="cpu")
    state = load_jax_train_state(trainer.init_state(), env.s0)
    ckpt = env.root / name
    CheckpointManager(str(ckpt)).save(state, 0)
    return ckpt


def test_cli_trains(env, capsys):
    run = _cli(env.root, "train", ["-m", "train", "--max-steps", "3"]) / "version_0"
    rows = _csv(run / "log.csv")
    assert [r["iteration"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert {"total", "gen_total", "commit", "recon", "freq"} <= set(rows[0])
    assert "k-means" not in capsys.readouterr().out
    saved = load_state_file(str(run / "ckpt" / "ckpt-epoch=0000-step=00000003"))
    assert "encoder" not in saved and "enc_opt" not in saved
    assert "encoder.conv_in.weight" in saved["decoder"] and "vq.embed" in saved["decoder"]
    assert saved["decoder"]["vq.embed"].shape == (6, 8)
    assert saved["dec_opt"]["state"] and saved["dis_opt"]["state"]
    assert "blocks.0.0.conv1.u0" in saved["discriminator"]


def test_cli_resume_is_bit_identical(env):
    """5 steps straight against 3, a resume, 2 more (across the epoch end,
    whose validation grids run through the VQGAN)."""
    straight = _cli(env.root, "straight", ["-m", "train", "--max-steps", "5"]) / "version_0"
    part = _cli(env.root, "split", ["-m", "train", "--max-steps", "3"]) / "version_0"
    resumed = _cli(env.root, "split", ["-m", "train", "--max-steps", "5"],
                   resume_checkpoint=str(part / "ckpt")) / "version_1"
    a, b = _csv(straight / "log.csv"), _csv(part / "log.csv") + _csv(resumed / "log.csv")
    assert [r["iteration"] for r in b] == [1, 2, 3, 4, 5] and a == b
    name = "ckpt-epoch=0001-step=00000005"
    sa, sb = (load_state_file(str(p / "ckpt" / name)) for p in (straight, resumed))
    assert (sa["step"], sa["epoch"]) == (sb["step"], sb["epoch"]) == (5, 1)
    assert torch.equal(sa["generator"], sb["generator"])
    for part_name in ("decoder", "discriminator"):
        for k in sa[part_name]:
            assert torch.equal(sa[part_name][k], sb[part_name][k]), (part_name, k)
    for opt in ("dec_opt", "dis_opt"):
        assert sa[opt]["state"]
        for i, s in sa[opt]["state"].items():
            for k, v in s.items():
                assert torch.equal(v, sb[opt]["state"][i][k]), (opt, i, k)
    assert (straight / "val_0000_0.png").exists()


def _read_result(path):
    rows = list(csv.reader(open(path)))
    return rows[0], [float(v) for v in rows[1][1:]]


def test_cli_test_result_matches_jax(env):
    ckpt = _jax_state_ckpt(env, "jax_state_test")
    run = _cli(env.root, "test", ["-m", "test"], resume_checkpoint=str(ckpt))
    header, got = _read_result(run / "version_0" / "result.csv")
    jheader, want = _read_result(env.jresult)
    assert header == jheader == ["", "Entropy_avg", "Entropy_std", "NMSE_avg", "NMSE_std",
                                 "PSNR_avg", "PSNR_std", "SSIM_avg", "SSIM_std"]
    np.testing.assert_array_equal(got[:2], want[:2])  # the entropy of equal ids
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-5, atol=1e-7)
    # the VQGAN's test writes result.csv alone, as JAX's
    assert sorted(os.listdir(run / "version_0")) == ["config.json", "result.csv"]


def test_cli_inference_export_matches_jax(env):
    ckpt = _jax_state_ckpt(env, "jax_state_export")
    out = env.root / "port_export"
    _cli(env.root, "export", ["-m", "test"], save_dir=out, resume_checkpoint=str(ckpt),
         training_mode="inference")
    proot = out / "export"
    assert len(env.jwritten) == 8
    for patient in sorted(os.listdir(env.jroot)):
        files = sorted(os.listdir(env.jroot / patient))
        assert sorted(os.listdir(proot / patient)) == files and len(files) == 6 * 4
        for f in (f for f in files if f.endswith(".nii.gz")):
            got, want = nifti.load(str(proot / patient / f)), nifti.load(str(env.jroot / patient / f))
            if f.startswith("label_"):
                np.testing.assert_array_equal(got, want)
                assert got.shape == (8, 8) and got.min() >= 0 and got.max() <= 5
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _validate_cases(root):
    base = _config(root)
    patch = copy.deepcopy(base)
    patch["model"]["dis"] = {"model_name": "NLayerDiscriminator", "n_filters": 4, "n_layers": 1,
                             "normalization": "actnorm"}
    patch_test = copy.deepcopy(patch)
    patch_test["run"]["training_mode"] = "test"
    odd_size = copy.deepcopy(base)
    odd_size["dataset"]["image_size"] = [36, 36]  # not a multiple of 2^(len(enc_filters)−1)
    no_dis = copy.deepcopy(base)
    no_dis["model"].pop("dis")
    full = json.load(open(CONFIG))
    return {"crc_vqgan": full, "shrunk": base, "patchgan": patch, "patchgan_test": patch_test,
            "odd_size": odd_size, "no_dis": no_dis}


def _outcome(fn, cfg):
    try:
        return ("ok", fn(cfg, vqgan=True))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("case", ["crc_vqgan", "no_dis", "odd_size", "patchgan",
                                  "patchgan_test", "shrunk"])
def test_validate_config_vqgan_matches_jax(tmp_path, case):
    cfg = _validate_cases(tmp_path)[case]
    got = _outcome(validate_config, to_config(cfg))
    assert got == _outcome(j_validate_config, j_to_config(cfg))
    assert got[0] == ("error" if case in ("no_dis", "patchgan") else "ok")


def test_trainer_builds_the_vqgan_as_jax(env):
    """The VQGAN's EMA momentum is the class default (the JAX trainer passes
    no `vq_momentum`; the config's `vqmodel.momentum` is 0.999), its
    `knn_backend` is `vqmodel`'s, and the discriminator is built although
    `crc_vqgan.json` trains in `first_step`."""
    from medical_image_editing_tpu.train.trainer import Trainer as JTrainer
    from medical_image_editing_tpu_torch.models import VQGAN, UNetDiscriminator
    from medical_image_editing_tpu_torch.train.trainer import Trainer

    cfg = _config(env.root)
    assert cfg["model"]["vqmodel"]["momentum"] == 0.999 and cfg["run"]["training_mode"] == \
        "first_step"
    jt = JTrainer(j_to_config(cfg), use_vqgan=True, devices=jax.devices()[:1])
    trainer = Trainer(to_config(cfg), use_vqgan=True, device="cpu")
    state = trainer.init_state()
    assert isinstance(state.decoder, VQGAN) and state.encoder is None
    assert state.decoder.momentum == jt.vqgan.vq_momentum == 0.99
    assert state.decoder.knn_backend == jt.vqgan.knn_backend == "pallas"
    assert isinstance(state.discriminator, UNetDiscriminator) and state.dis_opt is not None
    assert trainer.eval_dict_size == jt.eval_dict_size == 6
    assert state.vq.embed.shape == (6, 8) and state.vq.cluster_size.abs().sum() == 0
    assert torch.equal(state.vq.embed_avg, state.vq.embed)
    with pytest.raises(ValueError, match="go together"):
        Trainer(to_config(cfg), device="cpu")
    plain = _config(env.root)
    plain["model"]["vqmodel"]["model_name"] = None
    with pytest.raises(ValueError, match="go together"):
        Trainer(to_config(plain), use_vqgan=True, device="cpu")


def test_trainer_stages_a_reference_vqgan_ckpt(env, tmp_path):
    """`run.first_stage_ckpt_path` = a reference-format Lightning `.ckpt`
    whose `decoder.` field is the whole VQGAN (written by the JAX package's
    `torch_export`): it loads with `strict=True`."""
    from medical_image_editing_tpu.models.vqgan import VQGAN as JVQGAN
    from medical_image_editing_tpu.utils import torch_export
    from medical_image_editing_tpu_torch.train.trainer import Trainer

    cfg = _config(env.root)
    v = cfg["model"]["vqgan"]
    jm = JVQGAN(**{k: tuple(x) if isinstance(x, list) else x for k, x in v.items()
                   if k != "knn_backend"})
    ref = torch_export.export_vqgan(env.s0.dec_vars, env.s0.vq, jm)
    path = torch_export.save_lightning_ckpt(str(tmp_path / "vqgan.ckpt"), {"decoder": ref})
    cfg["run"]["first_stage_ckpt_path"] = path
    state = Trainer(to_config(cfg), use_vqgan=True, device="cpu").init_state()
    for k, val in state.decoder.state_dict().items():
        np.testing.assert_array_equal(val.numpy(), np.asarray(ref[k]), err_msg=k)


def test_second_stage_trains_the_patchgan_with_actnorm(tmp_path):
    """The second stage with `normalization: "actnorm"` (refused before the
    ActNorm was ported): a step initialises every ActNorm on the first
    train-mode forward (the reconstruction) and trains."""
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from test_torch_port_trainer import _config as lung_config

    cfg = lung_config(tmp_path)
    cfg["run"]["training_mode"] = "second_step"
    cfg["model"]["dis"].update(normalization="actnorm", n_layers=2)
    trainer = Trainer(to_config(cfg), device="cpu")
    state = trainer.init_state()
    norms = [m for m in state.discriminator.modules() if type(m).__name__ == "ActNorm"]
    assert len(norms) == 2 and not any(int(m.initialized) for m in norms)
    x = np.random.default_rng(2).uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(np.float32)
    before = [p.detach().clone() for p in state.discriminator.parameters()]
    state, metrics = trainer.train_step(state, x)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(int(m.initialized) == 1 for m in norms)
    assert any(not torch.equal(a, b) for a, b in zip(before, state.discriminator.parameters()))
