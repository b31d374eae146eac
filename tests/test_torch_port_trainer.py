"""The port's first-stage trainer and `run_vqwnet` CLI against the JAX
package's, end to end on the CPU at test sizes (32², filters
(4, 8, 8, 16, 16) / (8, 8, 16, 16, 32), batch 2, a fabricated lung slice
tree of 2 patients × 4 slices: 4 steps an epoch).

The JAX side is built once, in a module fixture, on one device (the
tests' conftest gives JAX eight CPU devices, over which its trainer would
split the batch): its trainer's initial
state (the port loads the same weights through `utils/weights.py::
from_jax_train_state`), a 2-step `fit` with `augmentation.modules: []` and
`use_init_embed: false` (so neither side draws a random number that
matters: no k-means start rows, no augmentation; the loader's order is
the same pure function of (seed, epoch) on both), and `test` in both modes
on the initial weights.

Tolerances, float32:
* step 1 losses: the step test's (tests/test_torch_port_train.py), rtol
  1e-4, the distance loss atol 1e-3 (a rounding residue under a square
  root);
* step 2 losses: the total rtol 4.5e-4, 5× the route floor: the JAX
  step's two conv routes, which differ only in 9 convolutions' summation
  order, differ by at most 9e-5 in these losses (the port differs from
  JAX in every convolution and norm). The reconstruction term rtol 1e-2;
  every other term rtol 2e-2 or atol 2e-4 × the total, whichever is
  wider. Step 2 runs on parameters after one Adam step,
  −lr·g/(|g| + 1e-8): ±lr wherever |g| ≫ 1e-8, so a parameter whose
  gradient differs in sign between the frameworks moves the other way
  (the step test holds those updates to 5× the JAX routes' floor), and
  an id at a near-tie can then flip, which moves the cross loss by
  ~1/(pixels of its code). Measured here, relative: total 7.4e-5, commit
  5.6e-4, cross 0.14 (1e-4 of the total), dist 1.4e-4, recon 2.7e-3,
  freq 3.5e-3. A wrong first update shows in the reconstruction term,
  not in the total: with the update skipped (lr 0), halved or doubled,
  the total is off by 2.0e-4, 1.3e-4 and 2.9e-4 (inside its limit), the
  reconstruction term by 2.8e-2, 3.4e-2 and 3.4e-2 (outside its limit);
  `test_step2_limits_catch_a_wrong_update` plants each of the three;
* test metrics on the same weights: rtol 1e-4; label maps exactly equal
  (ids), image and recon NIfTI maps atol 1e-4·4096/1500 (the lung
  re-window scales decoder differences by 4096/1500).

Port only: a resumed run (3 steps, resume, 3 steps, across an epoch end,
with k-means and the config's augmentation drawing from the generator) is
bit for bit an uninterrupted 6-step run; the CLI writes metrics,
checkpoints and `config.json`; the parts not ported yet are refused (the
second stage's are in tests/test_torch_port_gan.py).
"""

import copy
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from medical_image_editing_tpu.train.trainer import Trainer as JTrainer
from medical_image_editing_tpu.utils.config import to_config as j_to_config
from medical_image_editing_tpu.utils.logging import Logger as JLogger
from medical_image_editing_tpu_torch.cli import run_vqwnet
from medical_image_editing_tpu_torch.train import trainer as ttrainer
from medical_image_editing_tpu_torch.train.trainer import Trainer, TrainingDivergedError
from medical_image_editing_tpu_torch.utils import nifti
from medical_image_editing_tpu_torch.utils import weights as bridge
from medical_image_editing_tpu_torch.utils.checkpoint import load_state_file
from medical_image_editing_tpu_torch.utils.config import to_config
from medical_image_editing_tpu_torch.utils.logging import Logger

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "lung_first_stage.json")
LOSSES = ["total", "commit", "cross", "dist", "reg", "recon", "freq", "perceptual"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: several test workers on
    one host, each with a thread per core, spin OpenMP barriers against
    each other (the resumed-run test took 269 s beside another torch-heavy
    file, 4.7 s with one thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lung_tree(root, n_patients=2, n_slices=4, size=32, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for p in range(n_patients):
        d = root / f"pat{p}"
        d.mkdir(parents=True)
        for s in range(n_slices):
            img = -600 + 800 * (yy - 0.5) + 1200 * np.exp(
                -((yy - rng.uniform(0.3, 0.7)) ** 2 + (xx - rng.uniform(0.3, 0.7)) ** 2) / 0.02)
            img = img + rng.normal(0, 150, img.shape)
            np.save(d / f"ct_img_{s:04d}.npy", img.astype(np.float32))
    return root


def _config(root, *, plain=True, **run):
    cfg = json.load(open(CONFIG))
    cfg["dataset"].update(root_dir_path=str(root / "data"), batch_size=2, num_workers=0,
                          image_size=[32, 32])
    cfg["model"]["vqmodel"].update(enc_filters=[4, 8, 8, 16, 16],
                                   dec_filters=[8, 8, 16, 16, 32], knn_backend="xla",
                                   compute_dtype="float32")
    cfg["model"]["dis"] = {"model_name": "NLayerDiscriminator", "n_filters": 4, "n_layers": 1,
                           "normalization": "instancenorm", "apply_spectral_norm": False}
    cfg["save"].update(save_dir=str(root / "results"), n_save_images=2)
    cfg["run"].update({"n_epochs": 1, **run})
    if plain:  # nothing random that matters on either side
        cfg["augmentation"]["modules"] = []
        cfg["model"]["vqmodel"]["use_init_embed"] = False
    return cfg


# step 2's limits (see the docstring): 5× the JAX routes' loss floor for
# the total, the reconstruction term's own limit, the rest near-tie-wide
ROUTE_FLOOR = 9e-5
STEP2_RTOL = {"total": 5 * ROUTE_FLOOR, "recon": 1e-2}


def _step2_within(name, got, want):
    rtol = STEP2_RTOL.get(name, 2e-2)
    atol = 0.0 if name in STEP2_RTOL else 2e-4 * want["total"]
    return abs(got[name] - want[name]) <= atol + rtol * abs(want[name])


def _np(state):
    return SimpleNamespace(**{f: jax.tree.map(np.asarray, getattr(state, f))
                              for f in ("enc_vars", "dec_vars", "vq")})


def _csv(path):
    rows = open(path).read().splitlines()
    cols = rows[0].split(",")
    return [{c: float(v) for c, v in zip(cols, r.split(",")) if v} for r in rows[1:]]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    _lung_tree(root / "data")
    cfg = _config(root)
    metrics = cfg["run"]["monitoring_metrics"]
    jcfg = j_to_config(cfg)
    jt = JTrainer(jcfg, logger=JLogger(str(root / "jax"), config=jcfg,
                                       monitoring_metrics=metrics),
                  rng_key=jax.random.key(0), devices=jax.devices()[:1])
    s0 = _np(jt.init_state(32, 2))  # fit donates its state's buffers: keep numpy
    jt.fit(state=jt.init_state(32, 2), max_steps=2)
    _, jresult = jt.test(jt.init_state(32, 2), save_dir_path=str(root / "jax_test"))

    icfg = copy.deepcopy(cfg)
    icfg["run"]["training_mode"] = "inference"
    icfg["save"]["save_dir"] = str(root / "jax_export")
    ji = JTrainer(j_to_config(icfg), rng_key=jax.random.key(0), devices=jax.devices()[:1])
    jwritten = ji.test(ji.init_state(32, 2))
    return SimpleNamespace(root=root, cfg=cfg, s0=s0, jlog=jt.logger.log_dir,
                           jresult=jresult, jwritten=jwritten, icfg=icfg)


def _port_state(trainer, s0):
    state = trainer.init_state()
    sds = bridge.from_jax_train_state(s0)
    state.encoder.load_state_dict(sds["encoder"], strict=True)
    state.decoder.load_state_dict(sds["decoder"], strict=True)
    return state


@pytest.fixture(scope="module")
def port_fit(env):
    cfg = to_config(env.cfg)
    logger = Logger(str(env.root / "port"), config=cfg,
                    monitoring_metrics=env.cfg["run"]["monitoring_metrics"])
    trainer = Trainer(cfg, logger=logger, device="cpu")
    images, step = [], trainer.train_step

    def recorded(state, image, draws=None):  # the batches fit consumes
        images.append(image.clone())
        return step(state, image, draws)

    trainer.train_step = recorded
    state = trainer.fit(state=_port_state(trainer, env.s0), max_steps=2)
    return SimpleNamespace(state=state, log=logger.log_dir, images=images)


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("name", LOSSES)
def test_fit_losses_match_jax(env, port_fit, step, name):
    got = _csv(os.path.join(port_fit.log, "log.csv"))
    want = _csv(os.path.join(env.jlog, "log.csv"))
    assert len(got) == len(want) == 2
    g, w = got[step - 1], want[step - 1]
    assert (g["epoch"], g["iteration"]) == (w["epoch"], w["iteration"]) == (0, step)
    if step == 1:
        np.testing.assert_allclose(g[name], w[name], rtol=1e-4,
                                   atol=1e-3 if name == "dist" else 1e-7)
    else:
        assert _step2_within("total", g, w) and _step2_within(name, g, w), (g, w)


@pytest.mark.parametrize("lr_scale", [0.0, 0.5, 2.0], ids=["skipped", "halved", "doubled"])
def test_step2_limits_catch_a_wrong_update(env, lr_scale):
    """The step-2 limits fail a fit whose first update is skipped or has
    the wrong size: the same fit as `port_fit`, both learning rates scaled."""
    cfg = copy.deepcopy(env.cfg)
    for optim in ("enc_optim", "dec_optim"):
        cfg[optim]["lr"] *= lr_scale
    logger = Logger(str(env.root / f"wrong_update_{lr_scale}"), config=to_config(cfg),
                    monitoring_metrics=cfg["run"]["monitoring_metrics"])
    trainer = Trainer(to_config(cfg), logger=logger, device="cpu")
    trainer.fit(state=_port_state(trainer, env.s0), max_steps=2)
    g = _csv(os.path.join(logger.log_dir, "log.csv"))[1]
    w = _csv(os.path.join(env.jlog, "log.csv"))[1]
    assert not _step2_within("recon", g, w), (g["recon"], w["recon"])


def test_fit_consumes_the_jax_batch_stream(env, port_fit):
    from medical_image_editing_tpu.data import get_data_loader as j_get_data_loader

    ds = env.cfg["dataset"]
    j = j_get_data_loader("train", ds["dataset_name"], ds["root_dir_path"], ds["batch_size"],
                          drop_last=True, window_width=ds["window_width"],
                          window_center=ds["window_center"], window_scale=ds["window_scale"])
    want = [b for _, b in zip(range(2), j.epoch_iterator(0))]
    assert len(port_fit.images) == 2 and port_fit.state.step == 2
    for got, b in zip(port_fit.images, want):  # native or numpy on either side
        np.testing.assert_allclose(got.numpy(), np.asarray(b["image"]), rtol=1e-5, atol=1e-6)
    # max_steps mid-epoch: one step-tagged save, the epoch counter unmoved
    ckpts = sorted(os.listdir(os.path.join(port_fit.log, "ckpt")))
    assert ckpts == ["ckpt-epoch=0000-step=00000002"]
    assert load_state_file(os.path.join(port_fit.log, "ckpt", ckpts[0]))["epoch"] == 0


def test_test_mode_result_csv_matches_jax(env):
    trainer = Trainer(to_config(env.cfg), device="cpu")
    outputs, result = trainer.test(_port_state(trainer, env.s0),
                                   save_dir_path=str(env.root / "port_test"))
    got, want = pd.read_csv(result), pd.read_csv(env.jresult)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=1e-4)
    assert len(outputs) == 4  # 8 test slices at batch 2
    assert sorted(os.listdir(env.root / "port_test")) == sorted(
        os.listdir(env.root / "jax_test"))


def test_inference_export_matches_jax(env):
    icfg = copy.deepcopy(env.icfg)
    icfg["save"]["save_dir"] = str(env.root / "port_export")
    trainer = Trainer(to_config(icfg), device="cpu")
    written = trainer.test(_port_state(trainer, env.s0))
    rel = lambda ds: sorted(os.path.relpath(d, icfg["save"]["save_dir"]) for d in ds)
    jrel = sorted(os.path.relpath(d, env.icfg["save"]["save_dir"]) for d in env.jwritten)
    assert rel(written) == jrel and len(written) == 8
    jroot = os.path.join(env.icfg["save"]["save_dir"], icfg["save"]["study_name"])
    proot = os.path.join(icfg["save"]["save_dir"], icfg["save"]["study_name"])
    for patient in sorted(os.listdir(jroot)):
        files = sorted(os.listdir(os.path.join(jroot, patient)))
        assert sorted(os.listdir(os.path.join(proot, patient))) == files
        for f in (f for f in files if f.endswith(".nii.gz")):
            got = nifti.load(os.path.join(proot, patient, f))
            want = nifti.load(os.path.join(jroot, patient, f))
            if f.startswith("label_"):
                np.testing.assert_array_equal(got, want)
                assert got.min() >= 1 and got.max() <= icfg["model"]["vqmodel"]["dict_size"]
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * 4096 / 1500)


def _cli(root, name, argv, **run):
    cfg = _config(root, plain=False, n_epochs=2, **run)
    cfg["save"].update(study_name=name, save_every_n_steps=2)
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    assert run_vqwnet.main(["-c", str(path), "--device", "cpu", *argv]) == 0
    return root / "results" / name


def test_cli_train_writes_metrics_and_checkpoints(env):
    run = _cli(env.root, "cli", ["-m", "train", "--max-steps", "3"]) / "version_0"
    rows = _csv(run / "log.csv")
    assert [r["iteration"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r["total"]) for r in rows)
    # step 2's periodic save is superseded by the max_steps save at step 3
    assert sorted(os.listdir(run / "ckpt")) == ["ckpt-epoch=0000-step=00000003"]
    cfg = json.load(open(run / "config.json"))
    assert cfg["seed_list"] == [42] and cfg["save_dir_path"] == str(run)


def test_resumed_run_is_bit_identical(env):
    """6 steps straight vs 3 steps, resume, 3 more: the same losses and the
    same final state, bit for bit (generator, moments, codebook included)."""
    straight = _cli(env.root, "straight", ["-m", "train", "--max-steps", "6"]) / "version_0"
    first = _cli(env.root, "split", ["-m", "train", "--max-steps", "3"]) / "version_0"
    resumed = _cli(env.root, "split", ["-m", "train", "--max-steps", "6"],
                   resume_checkpoint=str(first / "ckpt")) / "version_1"
    a, b = _csv(straight / "log.csv"), _csv(first / "log.csv") + _csv(resumed / "log.csv")
    assert [r["iteration"] for r in b] == list(range(1, 7))
    assert a == b
    assert sorted(os.listdir(straight / "ckpt")) == sorted(os.listdir(resumed / "ckpt")) == [
        "ckpt-epoch=0000", "ckpt-epoch=0001-step=00000006"]
    sa = load_state_file(str(straight / "ckpt" / "ckpt-epoch=0001-step=00000006"))
    sb = load_state_file(str(resumed / "ckpt" / "ckpt-epoch=0001-step=00000006"))
    assert (sa["step"], sa["epoch"]) == (sb["step"], sb["epoch"]) == (6, 1)
    assert torch.equal(sa["generator"], sb["generator"])
    for part in ("encoder", "decoder"):
        assert sa[part].keys() == sb[part].keys()
        for k in sa[part]:
            assert torch.equal(sa[part][k], sb[part][k]), (part, k)
    for part in ("enc_opt", "dec_opt"):
        for i, s in sa[part]["state"].items():
            for k, v in s.items():
                assert torch.equal(v, sb[part]["state"][i][k]), (part, i, k)


def test_cli_test_mode_writes_result_csv(env):
    first = env.root / "results" / "cli" / "version_0" / "ckpt"
    if not first.exists():
        _cli(env.root, "cli", ["-m", "train", "--max-steps", "3"])
    run = _cli(env.root, "cli_test", ["-m", "test"], resume_checkpoint=str(first))
    result = pd.read_csv(run / "version_0" / "result.csv")
    assert {"NMSE_avg", "SSIM_std", "PSNR_avg", "Entropy_avg"} <= set(result.columns)
    assert np.isfinite(result.to_numpy()[:, 1:].astype(float)).all()


def test_divergence_guard_profile_and_snapshot(env, monkeypatch):
    cfg = _config(env.root, profile_dir=str(env.root / "trace"), profile_start_step=1,
                  profile_num_steps=2)
    logger = Logger(str(env.root / "guard"), config=to_config(cfg),
                    monitoring_metrics=cfg["run"]["monitoring_metrics"])
    trainer = Trainer(to_config(cfg), logger=logger, device="cpu")
    monkeypatch.setattr(ttrainer, "SNAPSHOT_INTERVAL", 2)
    state = trainer.fit(max_steps=3)
    assert state.step == 3
    assert os.path.exists(os.path.join(logger.log_dir, "train_000002.png"))
    trace = json.load(open(env.root / "trace" / "trace.json"))
    assert trace["traceEvents"]

    def poisoned(state, image, draws=None):
        state.step += 1
        return state, {"total": torch.tensor(float("nan"))}

    monkeypatch.setattr(trainer, "train_step", poisoned)
    with pytest.raises(TrainingDivergedError, match="non-finite 'total' at step 1"):
        trainer.fit(max_steps=2)


def test_staged_first_stage_from_checkpoint_and_lightning(env, port_fit):
    ckpt = os.path.join(port_fit.log, "ckpt")
    want = port_fit.state.encoder.state_dict()
    for staged in (ckpt, str(env.root / "first.ckpt")):
        if staged.endswith(".ckpt"):
            sd = {f"{m}.{k}": v for m in ("encoder", "decoder")
                  for k, v in getattr(port_fit.state, m).state_dict().items()}
            torch.save({"state_dict": sd}, staged)
        cfg = _config(env.root, first_stage_ckpt_path=staged)
        state = Trainer(to_config(cfg), device="cpu").init_state()
        got = state.encoder.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert state.step == 0 and not state.enc_opt.state


@pytest.mark.parametrize("what", ["multiwindow", "vqgan", "second_step", "joint_step",
                                  "dropblock", "perceptual", "discriminator"])
def test_parts_not_ported_are_refused(env, what):
    """The second stage, the multi-window trainer and the VQGAN trainer are
    ported (tests/test_torch_port_gan.py, tests/test_torch_port_multi_window*.py,
    tests/test_torch_port_vqgan*.py); "second_step", "discriminator",
    "multiwindow", "vqgan" and "joint_step" check what of them is not:
    DropBlock in the second stage, projection discrimination, the
    perceptual loss under `-w` and under `-v`, projection discrimination in
    the joint step."""
    cfg = _config(env.root)
    kw = {}
    if what == "multiwindow":
        kw = {"use_multi_window": True}
        cfg["loss"]["use_perceptual_loss"] = True
    elif what == "vqgan":
        kw = {"use_vqgan": True}
        cfg["model"]["vqmodel"]["model_name"] = "VQGAN"
        cfg["model"]["vqgan"] = {"in_channels": 1, "mid_channels": 4, "out_channels": 1,
                                 "emb_dim": 8, "dict_size": 6, "enc_ch_multiplier": [1, 2],
                                 "dec_ch_multiplier": [1, 2], "num_res_blocks": 1,
                                 "enc_attn_resolutions": [], "dec_attn_resolutions": [],
                                 "resolution": 32}
        cfg["model"]["dis"] = {"model_name": "UNetDiscriminator", "D_ch": 4,
                               "resolution": 128}
        cfg["loss"]["use_perceptual_loss"] = True
    elif what == "joint_step":
        kw = {"use_multi_window": True}
        cfg["run"]["training_mode"] = what
        cfg["model"]["dis"] = {"model_name": "UNetDiscriminator", "D_ch": 4,
                               "resolution": 128, "n_classes": 3}
    elif what == "second_step":
        cfg["run"]["training_mode"] = what
        cfg["model"]["vqmodel"]["use_dropblock"] = True
    elif what == "dropblock":
        cfg["model"]["vqmodel"]["use_dropblock"] = True
    elif what == "perceptual":
        cfg["loss"]["use_perceptual_loss"] = True
    else:
        cfg["run"]["training_mode"] = "second_step"
        cfg["model"]["dis"] = {"model_name": "UNetDiscriminator", "D_ch": 4,
                               "resolution": 128, "n_classes": 3}
    with pytest.raises(NotImplementedError, match="ROADMAP item (1[4678]|21)"):
        Trainer(to_config(cfg), device="cpu", **kw)
