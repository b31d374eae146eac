"""The multi-window trainer through `run_vqwnet -w` on the CPU, port vs JAX
package where the JAX trainer has a counterpart: over a fabricated lung
tree (2 patients × 4 slices of 64² HU, batch 2: 4 steps an epoch), the
joint config (`configs/lung_multiwindow_joint.json`) shrunk to filters
(4, 8, 16, 32, 64), `dict_size` 5, f32, the U-Net discriminator at `D_ch`
4 and resolution 128, in each of its three modes:
* `-m train --max-steps 3` trains (finite losses, the k-means gate at step
  0, a checkpoint with the mode's modules and Adams);
* `-m test` writes `image_SSSS`, `recon_SSSS` and `label_SSSS` NIfTI files
  for every slice under `save.save_dir/<patient>/`, equal to the JAX
  trainer's multi-window test (`evaluate.multi_window_test_export`) on the
  same state: the same file names, labels exactly, image and recon in HU
  within atol 1e-4 × 2048 (the dataset window's HU per normalized unit:
  width 4096 over scale 2; the port's and JAX's normalized outputs agree to
  1e-4, as the first-stage export test holds them);
* a joint run resumed mid-way (3 steps, resume to 5, across the epoch end)
  equals an uninterrupted one bit for bit: losses, parameters, the three
  Adams, spectral-norm vectors and the generator;
* `validate_config(multi_window=True)` returns JAX's warnings, or raises
  JAX's message.
"""

import copy
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
from medical_image_editing_tpu_torch.utils.config import to_config, validate_config
from test_torch_port_multi_window import jax_init
from test_torch_port_trainer import _csv, _lung_tree

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "lung_multiwindow_joint.json")
MODES = ["joint_step", "first_step", "second_step"]
SIZE = 64
HU_PER_UNIT = 4096 / 2.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors (several test workers
    share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(root, mode="joint_step", **run):
    cfg = json.load(open(CONFIG))
    cfg["dataset"].update(root_dir_path=str(root / "data"), batch_size=2, num_workers=0,
                          image_size=[SIZE, SIZE])
    cfg["model"]["vqmodel"].update(enc_filters=[4, 8, 16, 32, 64],
                                   dec_filters=[4, 8, 16, 32, 64], dict_size=5,
                                   compute_dtype="float32")
    cfg["model"]["dis"].update(D_ch=4, resolution=128)
    cfg["save"].update(save_dir=str(root / "results"), n_save_images=2)
    cfg["run"].update({"training_mode": mode, "n_epochs": 1, **run})
    return cfg


def _cli(root, name, argv, mode="joint_step", save_dir=None, **run):
    from medical_image_editing_tpu_torch.cli import run_vqwnet

    cfg = _config(root, mode, n_epochs=2, **run)
    cfg["save"].update(study_name=name, save_every_n_steps=3)
    if save_dir is not None:
        cfg["save"]["save_dir"] = str(save_dir)
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    assert run_vqwnet.main(["-w", "-c", str(path), "--device", "cpu", *argv]) == 0
    return root / "results" / name


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The tree, JAX's initial variables and the JAX trainer's multi-window
    test export of them."""
    from medical_image_editing_tpu.train import state as jstate
    from medical_image_editing_tpu.train.trainer import Trainer as JTrainer

    root = tmp_path_factory.mktemp("multi_window_trainer")
    _lung_tree(root / "data", size=SIZE)
    ji = jax_init()
    jcfg = _config(root)
    jcfg["save"]["save_dir"] = str(root / "jax_export")
    jt = JTrainer(j_to_config(jcfg), use_multi_window=True, devices=jax.devices()[:1])
    state = jstate.create_train_state(jax.random.key(4), ji.enc_vars, ji.dec_vars, ji.vq,
                                      jt.enc_tx, jt.dec_tx)
    jwritten = jt.test(state)
    s0 = SimpleNamespace(**{f: jax.tree.map(np.asarray, getattr(ji, f))
                            for f in ("enc_vars", "dec_vars", "vq", "dis_vars")})
    return SimpleNamespace(root=root, s0=s0, jroot=root / "jax_export", jwritten=jwritten)


@pytest.mark.parametrize("mode", MODES)
def test_cli_trains(env, mode, capsys):
    run = _cli(env.root, f"train_{mode}", ["-m", "train", "--max-steps", "3"], mode=mode)
    rows = _csv(run / "version_0" / "log.csv")
    assert [r["iteration"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert "Initialized codebook with k-means" in capsys.readouterr().out
    from medical_image_editing_tpu_torch.utils.checkpoint import load_state_file

    saved = load_state_file(str(run / "version_0" / "ckpt" / "ckpt-epoch=0000-step=00000003"))
    assert ("discriminator" in saved) == (mode != "first_step")
    trained = {"joint_step": ("enc_opt", "dec_opt", "dis_opt"),
               "first_step": ("enc_opt", "dec_opt"), "second_step": ("dec_opt", "dis_opt")}
    for opt in ("enc_opt", "dec_opt", "dis_opt"):
        if opt in saved:
            assert bool(saved[opt]["state"]) == (opt in trained[mode]), (mode, opt)


@pytest.mark.parametrize("mode", MODES)
def test_cli_test_export_matches_jax(env, mode):
    """The port's `-w -m test` from a checkpoint of JAX's initial state
    against the JAX trainer's multi-window test on that state."""
    from medical_image_editing_tpu_torch.train.trainer import Trainer
    from medical_image_editing_tpu_torch.utils.checkpoint import CheckpointManager
    from medical_image_editing_tpu_torch.utils.weights import load_jax_train_state

    trainer = Trainer(to_config(_config(env.root, mode)), use_multi_window=True, device="cpu")
    state = load_jax_train_state(trainer.init_state(), env.s0)
    ckpt = env.root / f"jax_state_{mode}"
    CheckpointManager(str(ckpt)).save(state, 0)
    out = env.root / f"port_export_{mode}"
    _cli(env.root, f"test_{mode}", ["-m", "test"], mode=mode, save_dir=out,
         resume_checkpoint=str(ckpt))
    jrel = sorted(os.path.relpath(d, env.jroot) for d in env.jwritten)
    assert len(jrel) == 8
    for patient in sorted(os.listdir(env.jroot)):
        files = sorted(os.listdir(env.jroot / patient))
        assert len(files) == 3 * 4
        assert sorted(f for f in os.listdir(out / patient) if f.endswith(".nii.gz")) == files
        for f in files:
            got, want = nifti.load(str(out / patient / f)), nifti.load(str(env.jroot / patient / f))
            if f.startswith("label_"):
                np.testing.assert_array_equal(got, want)
                assert got.min() >= 1 and got.max() <= 5
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * HU_PER_UNIT, err_msg=f)
                if f.startswith("image_"):
                    assert got.min() < -500 and got.max() > 200  # HU, not normalized


def test_cli_joint_resume_is_bit_identical(env):
    """5 joint steps straight against 3, a resume, 2 more (across the epoch
    end, whose validation grid carries the discriminator's maps)."""
    from medical_image_editing_tpu_torch.utils.checkpoint import load_state_file

    straight = _cli(env.root, "mw_straight", ["-m", "train", "--max-steps", "5"]) / "version_0"
    part = _cli(env.root, "mw_split", ["-m", "train", "--max-steps", "3"]) / "version_0"
    resumed = _cli(env.root, "mw_split", ["-m", "train", "--max-steps", "5"],
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
    for opt in ("enc_opt", "dec_opt", "dis_opt"):
        assert sa[opt]["state"]
        for i, s in sa[opt]["state"].items():
            for k, v in s.items():
                assert torch.equal(v, sb[opt]["state"][i][k]), (opt, i, k)
    assert (straight / "val_0000_0.png").exists()


def _validate_cases(root):
    base = _config(root)
    patch = copy.deepcopy(base)
    patch["model"]["dis"] = {"model_name": "NLayerDiscriminator", "n_filters": 4, "n_layers": 1,
                             "normalization": "instancenorm"}
    no_window = copy.deepcopy(base)
    for k in ("window_width", "window_center", "window_scale"):
        no_window["dataset"].pop(k)
    first_patch = copy.deepcopy(patch)
    first_patch["run"]["training_mode"] = "first_step"
    perceptual = copy.deepcopy(base)
    perceptual["loss"]["use_perceptual_loss"] = True
    bad_resolution = copy.deepcopy(base)
    bad_resolution["model"]["dis"]["resolution"] = 96
    return {"joint": base, "joint_patchgan": patch, "no_window": no_window,
            "first_step_patchgan": first_patch, "perceptual": perceptual,
            "bad_resolution": bad_resolution}


def _outcome(fn, cfg):
    try:
        return ("ok", fn(cfg, multi_window=True))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("case", ["bad_resolution", "first_step_patchgan", "joint",
                                  "joint_patchgan", "no_window", "perceptual"])
def test_validate_config_multi_window_matches_jax(tmp_path, case, monkeypatch):
    monkeypatch.delenv("MEDIMG_VGG19_NPZ", raising=False)
    monkeypatch.delenv("MEDIMG_LPIPS_NPZ", raising=False)
    cfg = _validate_cases(tmp_path)[case]
    got = _outcome(validate_config, to_config(cfg))
    assert got == _outcome(j_validate_config, j_to_config(cfg))
    assert got[0] == ("ok" if case in ("joint", "first_step_patchgan", "perceptual") else "error")
