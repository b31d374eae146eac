"""The port's training-runtime utilities against the JAX package's, on the
CPU: `CheckpointManager` retention (the same directory names remain after
the same save sequences), a `TrainState` round trip bit for bit
(parameters, Adam moments, VQ buffers, generator, step, epoch),
`restore_fields`, the refusal of a checkpoint the port cannot read, the
`Logger` files, `validate_config`'s warnings and errors, the config loader's
`false_to_none` switch, `init_seed`, and the image helpers.
"""

import glob
import json
import os
import random

import numpy as np
import pytest
import torch

from medical_image_editing_tpu.utils import CheckpointManager as JCheckpointManager
from medical_image_editing_tpu.utils import Logger as JLogger
from medical_image_editing_tpu.utils.config import load_json as j_load_json
from medical_image_editing_tpu.utils.config import to_config as j_to_config
from medical_image_editing_tpu.utils.config import validate_config as j_validate_config
from medical_image_editing_tpu_torch.models import UNetDecoder
from medical_image_editing_tpu_torch.models.blocks import seeded_init
from medical_image_editing_tpu_torch.models.unet_encoder import EncoderWithVQ
from medical_image_editing_tpu_torch.train import first_stage as tfs
from medical_image_editing_tpu_torch.train import state as tstate
from medical_image_editing_tpu_torch.utils import imaging
from medical_image_editing_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    restore_fields,
    restore_state,
)
from medical_image_editing_tpu_torch.utils.config import load_json, to_config, validate_config
from medical_image_editing_tpu_torch.utils.logging import Logger
from medical_image_editing_tpu_torch.utils.seed import init_seed
from test_utils import _tiny_state

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(ROOT, "configs", "lung_first_stage.json")

# (limit_num, save_interval, [(epoch, step or None), ...]); the first is
# tests/test_utils.py::test_checkpoint_retention_policy's sequence
SEQUENCES = [
    (2, 3, [(e, None) for e in range(6)]),
    (3, 2, [(0, 2), (0, 4), (0, None), (1, 6), (1, 8), (1, None), (2, 10)]),
    (1, 4, [(0, None), (1, 3), (1, None), (2, None), (3, None), (4, 5), (4, 6)]),
    (2, 2, [(0, 1), (0, 2), (0, 2), (0, None), (1, None), (2, None), (3, 9), (3, None)]),
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small tensors: test workers sharing a
    host otherwise spin OpenMP barriers against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("limit,interval,saves", SEQUENCES)
def test_retention_keeps_the_jax_directory_names(tmp_path, limit, interval, saves):
    jm = JCheckpointManager(str(tmp_path / "jax"), limit_num=limit, save_interval=interval)
    tm = CheckpointManager(str(tmp_path / "port"), limit_num=limit, save_interval=interval)
    jstate = _tiny_state(1)
    tiny = _state(0)
    for epoch, step in saves:
        jm.save(jstate, epoch, step=step)
        tm.save(tiny, epoch, step=step)
    jm.close()
    want = sorted(n for n in os.listdir(tmp_path / "jax") if n.startswith("ckpt-"))
    assert sorted(os.listdir(tmp_path / "port")) == want  # no temporary left either
    assert os.path.basename(tm.latest_path()) == os.path.basename(jm.latest_path())
    assert tm.latest_epoch() == jm.latest_epoch()


def _models(seed):
    enc = EncoderWithVQ(1, (4, 8, 8, 16, 16), 6, momentum=0.99, knn_backend="xla")
    dec = UNetDecoder(4, 1, (8, 8, 16, 16, 32), dropped_skip_layers=(),
                      use_pixel_shuffle=False)
    gen = torch.Generator().manual_seed(seed)
    return seeded_init(enc, gen), seeded_init(dec, gen)


def _state(seed):
    cfg = load_json(CONFIG)
    enc, dec = _models(seed)
    return tstate.create_train_state(
        enc, dec, tstate.make_optimizer_from_config(enc.parameters(), cfg.enc_optim),
        tstate.make_optimizer_from_config(dec.parameters(), cfg.dec_optim),
        seed=seed, device="cpu")


def _trained(seed, steps=2):
    """A state after k-means and `steps` augmented steps: moments, the
    codebook EMA and the generator have all moved."""
    cfg = load_json(CONFIG)
    state = _state(seed)
    image = np.random.default_rng(seed).uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    tfs.init_codebook_step(state.encoder)(state, image)
    step = tfs.make_first_stage_step(state.encoder, state.decoder,
                                     loss_cfg=tfs.loss_config_from_json(cfg.loss),
                                     aug_cfg=cfg.augmentation, dict_size=6, device="cpu")
    for _ in range(steps):
        state, _ = step(state, image)
    state.epoch = 3
    return state, step, image


def _flat(sd, prefix=""):
    """Every tensor and number of a (nested) state dict, by path."""
    out = {}
    if isinstance(sd, dict):
        for k, v in sd.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif isinstance(sd, (list, tuple)):
        for i, v in enumerate(sd):
            out.update(_flat(v, f"{prefix}{i}/"))
    else:
        out[prefix] = sd
    return out


def _assert_equal_state(a, b):
    fa, fb = _flat(a.state_dict()), _flat(b.state_dict())
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_train_state_round_trip_is_bit_exact(tmp_path):
    state, step, image = _trained(1)
    assert state.step == 2 and state.enc_opt.state and state.vq.cluster_size.sum() > 0
    mgr = CheckpointManager(str(tmp_path), limit_num=2, save_interval=2)
    path = mgr.save(state, epoch=3)
    assert os.path.basename(path) == "ckpt-epoch=0003"
    fresh = _state(7)
    mgr.restore(fresh)
    _assert_equal_state(state, fresh)
    for key in ("vq.embed", "vq.cluster_size", "vq.embed_avg"):
        assert torch.equal(fresh.encoder.state_dict()[key], state.encoder.state_dict()[key])
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())
    assert (fresh.step, fresh.epoch) == (2, 3)
    # the restored state steps on exactly as the original: same draws, same updates
    cfg = load_json(CONFIG)
    fresh_step = tfs.make_first_stage_step(fresh.encoder, fresh.decoder,
                                           loss_cfg=tfs.loss_config_from_json(cfg.loss),
                                           aug_cfg=cfg.augmentation, dict_size=6, device="cpu")
    _, m1 = step(state, image)
    _, m2 = fresh_step(fresh, image)
    assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}
    _assert_equal_state(state, fresh)


def test_restore_fields_copies_only_the_named_fields(tmp_path):
    first, _, _ = _trained(1)
    CheckpointManager(str(tmp_path / "first")).save(first, epoch=0)
    second, _, _ = _trained(2, steps=1)
    keep = {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in _flat({"enc_opt": second.enc_opt.state_dict(),
                               "generator": second.generator.get_state()}).items()}
    restore_fields(str(tmp_path / "first"), second, ("encoder", "decoder"))
    for name in ("encoder", "decoder"):
        got, want = getattr(second, name).state_dict(), getattr(first, name).state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
    now = _flat({"enc_opt": second.enc_opt.state_dict(),
                 "generator": second.generator.get_state()})
    for k, v in keep.items():
        assert (torch.equal(now[k], v) if isinstance(v, torch.Tensor) else now[k] == v), k
    assert second.step == 1
    # a specific checkpoint directory works too
    restore_state(str(tmp_path / "first" / "ckpt-epoch=0000"), second)
    _assert_equal_state(first, second)


def test_unreadable_checkpoint_points_at_lightning(tmp_path):
    # what an Orbax checkpoint directory looks like to the port
    d = tmp_path / "run" / "ckpt-epoch=0000"
    d.mkdir(parents=True)
    (d / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="load_lightning_state"):
        CheckpointManager(str(tmp_path / "run")).restore(_state(0))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_state(0))


def test_logger_files_match_jax(tmp_path):
    metrics = ["epoch", "iteration", "total", "gen_total", "recon"]
    rows = [{"epoch": 0, "iteration": 1, "total": 1.5, "recon": np.float32(0.25)},
            {"epoch": 0, "iteration": 2, "total": 1.25, "recon": 0.125, "extra": 3.0}]
    out = {}
    for side, (cls, tc) in {"jax": (JLogger, j_to_config), "port": (Logger, to_config)}.items():
        cfg = tc({"run": {"seed": 1}, "loss": {"flag": False}})
        (tmp_path / f"{side}_logs" / "study" / "version_0").mkdir(parents=True)  # next: 1
        logger = cls(str(tmp_path / f"{side}_logs"), config=cfg, monitoring_metrics=metrics,
                     name="study")
        for r in rows:
            logger.log_metrics(r, step=r["iteration"])
        logger.log_val_metrics({"NMSE": 0.5, "SSIM": 0.25})
        logger.log_test_metrics({"PSNR": 20.0})
        logger.log_hyperparams([1, 2])
        out[side] = logger.log_dir
    for side in out:
        assert out[side].endswith(os.path.join("study", "version_1"))
    for name in ("log.csv", "val_logs.csv", "test_logs.csv"):
        jtext = open(os.path.join(out["jax"], name)).read()
        assert open(os.path.join(out["port"], name)).read() == jtext, name
    jcfg = json.load(open(os.path.join(out["jax"], "config.json")))
    pcfg = json.load(open(os.path.join(out["port"], "config.json")))
    assert jcfg.pop("save_dir_path").replace("jax_logs", "port_logs") == pcfg.pop("save_dir_path")
    assert pcfg == jcfg


def _bad_configs():
    tiny_dis = {"model_name": "NLayerDiscriminator", "n_filters": 4, "n_layers": 1,
                "normalization": "instancenorm"}
    base = {"run": {"training_mode": "second_step"},
            "dataset": {"dataset_name": "CRCDataset", "image_size": [32, 32]},
            "model": {"vqmodel": {"enc_filters": [4, 8, 16, 32, 64]},
                      "dis": {"model_name": "UNetDiscriminator", "resolution": 32}}}
    warn = {"run": {"training_mode": "first_step"},
            "dataset": {"dataset_name": "CRCDataset", "image_size": [64, 64]},
            "model": {"vqmodel": {"enc_filters": [4, 8]}, "dis": tiny_dis},
            "loss": {"use_perceptual_loss": True}}
    return {
        "dis_resolution": (base, {}),
        "mode": (dict(base, run={"training_mode": "trian"}), {}),
        "size": ({"run": {"training_mode": "first_step"},
                  "dataset": {"dataset_name": "CRCDataset", "image_size": [50, 50]},
                  "model": {"vqmodel": {"enc_filters": [4, 8, 16, 32, 64]},
                            "dis": tiny_dis}}, {}),
        "brats": ({"run": {"training_mode": "first_step"},
                   "dataset": {"dataset_name": "MICCAIBraTSDataset", "image_size": [64, 64]},
                   "model": {"vqmodel": {"enc_filters": [4, 8]}, "dis": tiny_dis}}, {}),
        "perceptual": (warn, {}),
        "scalar_size": ({**warn, "dataset": {"dataset_name": "CRCDataset", "image_size": 64},
                         "loss": {}}, {}),
        "no_dis": ({**warn, "model": {"vqmodel": {"enc_filters": [4, 8]}}}, {}),
        "lung_window": ({"run": {"training_mode": "first_step"},
                         "dataset": {"dataset_name": "NCCLungDataset", "image_size": 256},
                         "model": {"vqmodel": {"enc_filters": [4, 8]},
                                   "dis": {"model_name": "UNetDiscriminator",
                                           "resolution": 128}}}, {}),
        "joint_without_w": (dict(base, run={"training_mode": "joint_step"}), {}),
        "multi_window_no_window": ({**warn, "loss": {}}, {"multi_window": True}),
        "vqgan_patchgan": ({**warn, "loss": {}}, {"vqgan": True}),
    }


def _outcome(fn, cfg, kw):
    try:
        return ("ok", fn(cfg, **kw))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("case", sorted(_bad_configs()))
def test_validate_config_matches_jax(case, monkeypatch):
    monkeypatch.delenv("MEDIMG_VGG19_NPZ", raising=False)
    monkeypatch.delenv("MEDIMG_LPIPS_NPZ", raising=False)
    cfg, kw = _bad_configs()[case]
    got = _outcome(validate_config, to_config(cfg), kw)
    assert got == _outcome(j_validate_config, j_to_config(cfg), kw)
    assert got[0] == "error" or got[1] or case == "scalar_size"  # the one clean case


def test_validate_config_shipped_configs_match_jax():
    for p in sorted(glob.glob(os.path.join(ROOT, "configs", "*.json"))):
        kw = dict(multi_window="multiwindow" in p, vqgan="vqgan" in p)
        assert validate_config(load_json(p), **kw) == j_validate_config(j_load_json(p), **kw)


@pytest.mark.parametrize("false_to_none", [True, False])
def test_false_to_none_switch(tmp_path, false_to_none):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"loss": {"use_recon_loss": False, "w": [1, False]}}))
    got = load_json(str(p), false_to_none=false_to_none)
    want = j_load_json(str(p), false_to_none=false_to_none)
    assert got.to_dict() == want.to_dict()
    assert got.loss.use_recon_loss is (None if false_to_none else False)
    assert "loss" in got and "run" not in got


def test_init_seed_seeds_every_rng():
    seed, logged = init_seed([123, 7])
    assert (seed, logged) == (123, [123, 7])
    draws = (random.random(), np.random.rand(), torch.rand(1).item())
    random.seed(123)
    np.random.seed(123)
    torch.manual_seed(123)
    assert draws == (random.random(), np.random.rand(), torch.rand(1).item())
    seed, logged = init_seed(None)
    assert logged == [seed] and 1 <= seed <= 10000


def test_image_helpers(tmp_path):
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(rng.uniform(0, 1, (4, 8, 6, 1)).astype(np.float32))
    assert imaging.to_image(batch).shape == (8, 6)
    assert imaging.to_image(batch[..., 0], is_ids=True).shape == (8, 6)
    assert imaging.to_image(batch, retain_batch=True).shape == (4, 8, 6)
    ids = rng.integers(0, 6, (8, 6))
    imaging.save_fused_image(batch[0, ..., 0], "gray", -1, 1, ids, "Spectral", 0, 5, 0.3,
                             str(tmp_path / "fused.png"))
    imaging.save_image_grid(batch, str(tmp_path / "grid.png"), nrow=2)
    for name in ("fused.png", "grid.png"):
        assert (tmp_path / name).read_bytes()[:8] == imaging.PNG_SIGNATURE
    # cells: row-major, 1-based; empty cells stay white; a flat panel is level 0
    grid = imaging.compose_grid([(np.ones((8, 6)), "gray", 0, 1, 1),
                                 (np.zeros((8, 6)), "gray", None, None, 5)],
                                n_row=2, n_col=3, pad=2)
    assert grid.shape == (2 * 10 + 2, 3 * 8 + 2, 3)
    assert (grid[2:10, 2:8] == 255).all()            # cell 1: white (1.0 in [0, 1])
    assert (grid[12:20, 10:16] == 0).all()           # cell 5: flat → lowest level
    assert (grid[12:20, 2:8] == 255).all()           # cell 4: empty
    imaging.save_snapshot_grid(str(tmp_path / "snap.png"),
                               [(ids, "ids", "Spectral", 0, 5, 2)], n_row=1, n_col=3)
    assert (tmp_path / "snap.png").stat().st_size > 0
