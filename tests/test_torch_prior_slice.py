"""The prior slice as a whole, port vs JAX package, on the CPU at small
size, and the port's `train_prior` CLI end to end.

The chain (`cli/train_prior.py`'s path): a first stage (encoder with its
codebook, decoder: filters (4, 8, 16, 32, 64), `dict_size` 6, as JAX's
`tests/test_prior.py::test_prior_end_to_end_with_vqwnet`) encodes two 16²
images to id grids (ids − 1), a GPT over the 256-token raster (1 layer, 2
heads, `n_embed` 16, dropout 0) takes two AdamW steps on them, the
sampler draws two grids, and the decoder renders the codebook rows of the
sampled ids. Both sides start from the same weights: the port's seeded
first stage (its codebook DICT feature rows of the images, so that the ids
vary), carried to JAX by the JAX package's `utils/torch_import.py`, and
flax's GPT initialisation carried to the port by
`utils/weights.py::from_jax_gpt`; the port runs its plain route on the
CPU. JAX runs under
`default_matmul_precision("highest")`.

Tolerances (float32; readings on this suite's CPU host in brackets):
* ids exactly wherever JAX's top-two VQ score gap is clear of 1e-4 (every
  id at these seeds);
* the prior's losses rtol 1e-5 and accuracies exactly (the ids equal);
* the sampled grids by the margin rule of `tests/test_torch_prior.py`:
  with JAX's own Gumbel draws replayed, equal up to the first step whose
  top-two margin of logits + g is within 1e-4 (none here; the smallest
  margin is printed: 2.5e-3);
* the decoded images atol 1e-4 (the models' tolerance in
  `tests/test_torch_port_models.py`).

The CLI runs `train_prior.main([..., "--device", "cpu"])` over a seeded
lung slice tree at 16²: its files and their shapes and ranges, the
reloaded prior's logits equal to the trained model's, and `--ckpt`
restoring a first-stage checkpoint written by `utils/checkpoint.py`.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medical_image_editing_tpu.models import UNetDecoder as JDecoder
from medical_image_editing_tpu.models.blocks import instance_norm as j_instance_norm
from medical_image_editing_tpu.models.mingpt import GPT as JGPT
from medical_image_editing_tpu.models.mingpt import GPTConfig as JGPTConfig
from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ as JEncoder
from medical_image_editing_tpu.models.unet_encoder import get_embed_from_ids as j_embed
from medical_image_editing_tpu.train.prior import PriorTrainState as JPriorTrainState
from medical_image_editing_tpu.train.prior import make_prior_train_step as j_make_step
from medical_image_editing_tpu.utils.torch_import import (
    import_unet_decoder,
    import_unet_encoder,
    import_vq_state,
)
from medical_image_editing_tpu_torch.cli import train_prior
from medical_image_editing_tpu_torch.models import UNetDecoder
from medical_image_editing_tpu_torch.models.blocks import instance_norm, seeded_init
from medical_image_editing_tpu_torch.models.mingpt import GPT, GPTConfig
from medical_image_editing_tpu_torch.models.unet_encoder import EncoderWithVQ, get_embed_from_ids
from medical_image_editing_tpu_torch.train import prior as tprior
from medical_image_editing_tpu_torch.train.state import create_train_state, make_optimizer
from medical_image_editing_tpu_torch.utils import weights as bridge
from medical_image_editing_tpu_torch.utils.checkpoint import CheckpointManager, load_state_file
from test_torch_prior import MARGIN_TOL, jax_sample_replay

FILTERS = (4, 8, 16, 32, 64)
DICT = 6
SOS = DICT
SIZE = 16
GRID = (SIZE, SIZE)
B = 2
LR = 1e-3
GPT_KW = dict(vocab_size=DICT + 1, block_size=SIZE * SIZE, n_layer=1, n_head=2, n_embed=16,
              emb_pdrop=0.0, res_pdrop=0.0, att_pdrop=0.0)
ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    imgs = [np.tanh(0.8 * (yy - 0.5) + np.exp(-((yy - rng.uniform(0.3, 0.7)) ** 2
                                                 + (xx - rng.uniform(0.3, 0.7)) ** 2) / 0.05)
                    + 0.2 * rng.normal(size=(SIZE, SIZE)))
            for _ in range(B)]
    return np.stack(imgs)[..., None].astype(np.float32)


def port_first_stage():
    """The port's encoder (with a codebook of DICT distinct feature rows of
    the test images, so that the ids vary) and decoder, seeded weights, in
    eval mode."""
    gen = torch.Generator().manual_seed(0)
    enc = seeded_init(EncoderWithVQ(1, FILTERS, DICT, momentum=0.9), gen).eval()
    dec = seeded_init(UNetDecoder(FILTERS[0], 1, FILTERS, dropped_skip_layers=(),
                                  use_pixel_shuffle=False), gen).eval()
    with torch.no_grad():
        feats = enc(torch.from_numpy(_images()).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        rows = feats.reshape(-1, FILTERS[0])
        pick = torch.randperm(rows.shape[0], generator=gen)[:DICT]
        enc.vq.embed.copy_(rows[pick])
        enc.vq.embed_avg.copy_(rows[pick].t())  # the reference keeps it (C, K)
    return enc, dec


@pytest.fixture(scope="module")
def chain():
    """The whole chain on the JAX side, from the port's first-stage weights
    (carried by the JAX package's `utils/torch_import.py`) and flax's GPT
    initialisation: the ids and VQ score gaps, the losses and accuracies of
    two steps, the sampled grids with the replayed Gumbel draws and
    margins, and the decoded images; with the port's modules and the GPT's
    initial parameters."""
    x = _images()
    enc, dec = port_first_stage()
    enc_sd = {k: v.numpy() for k, v in enc.state_dict().items()}
    dec_sd = {k: v.numpy() for k, v in dec.state_dict().items()}
    enc_vars = import_unet_encoder(enc_sd, prefix="")
    vq = import_vq_state(enc_sd, prefix="vq.")
    dec_vars = import_unet_decoder(dec_sd, prefix="")
    jenc = JEncoder(filters=FILTERS, dict_size=DICT, momentum=0.9)
    jdec = JDecoder(out_channels=1, filters=FILTERS, dropped_skip_layers=(),
                    use_pixel_shuffle=False)
    config = JGPTConfig(**GPT_KW)
    jgpt = JGPT(config)
    tx = optax.adamw(LR, weight_decay=0.01)
    with jax.default_matmul_precision("highest"):
        ids, feats = jax.jit(lambda v, q, im: (jenc(v, q, im, train=False)[2],
                                               jenc.module.apply(v, im, train=False)))(
            enc_vars, vq, jnp.asarray(x))
        ids = np.asarray(ids) - 1
        # the VQ's top-two score gap per pixel
        e = np.asarray(vq.embed)
        scores = 2 * np.asarray(feats) @ e.T - (e * e).sum(-1)
        top2 = np.sort(scores, -1)[..., -2:]
        gap = top2[..., 1] - top2[..., 0]

        variables = jax.jit(lambda k: jgpt.init({"params": k},
                                                 jnp.zeros((1, SIZE * SIZE), jnp.int32),
                                                 False))(jax.random.key(3))
        params = jax.tree.map(np.asarray, variables["params"])
        params["pos_emb"] = np.random.default_rng(4).normal(
            0, 0.3, params["pos_emb"].shape).astype(np.float32)
        state = JPriorTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.key(0),
                                 variables={"params": jax.tree.map(jnp.asarray, params)},
                                 opt_state=tx.init(params))
        step = jax.jit(j_make_step(jgpt, tx, sos_token=SOS))
        metrics = []
        for _ in range(2):
            state, m = step(state, jnp.asarray(ids, jnp.int32))
            metrics.append((float(m["loss"]), float(m["acc"])))
        trained = jax.tree.map(np.asarray, state.variables["params"])
        compiled, replay, gumbel, margins = jax_sample_replay(
            config, trained, jax.random.key(5), grid=GRID, batch=B)
        images = np.asarray(jax.jit(lambda v, g: jdec.apply(v, j_embed(vq, g), False))(
            dec_vars, jnp.asarray(compiled)))
    return dict(x=x, enc=enc, dec=dec, params=params, ids=ids, gap=gap, metrics=metrics,
                compiled=compiled, replay=replay, gumbel=gumbel, margins=margins,
                images=images)


@pytest.fixture(scope="module")
def port(chain):
    """The same chain on the port's side."""
    enc, dec = chain["enc"], chain["dec"]
    with torch.no_grad():
        _, _, ids, _ = enc.encode(torch.from_numpy(chain["x"]))
    ids = ids - 1
    gpt = GPT(GPTConfig(**GPT_KW))
    gpt.load_state_dict(bridge.from_jax_gpt(chain["params"]), strict=True)
    state = tprior.PriorTrainState(gpt, tprior.make_prior_optimizer(gpt.parameters(), LR),
                                   torch.Generator().manual_seed(0))
    step = tprior.make_prior_train_step(sos_token=SOS)
    metrics = []
    for _ in range(2):
        state, m = step(state, ids)
        metrics.append((float(m["loss"]), float(m["acc"])))
    grids = tprior.make_prior_sampler(gpt, sos_token=SOS, grid_hw=GRID)(
        B, gumbel=torch.from_numpy(chain["gumbel"]))
    with torch.no_grad():
        q = get_embed_from_ids(enc.vq.state(), grids)
        images = dec(q.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return dict(ids=ids.numpy(), metrics=metrics, grids=grids.numpy(), images=images.numpy())


@pytest.mark.parametrize("shape", [(2, 3, 1, 1), (2, 3, 1, 4)])
def test_instance_norm_of_small_maps_matches_jax(shape):
    """A 16² image reaches the 4-level U-Nets' bottleneck as 1×1 maps, which
    `F.instance_norm` refuses; JAX normalises them to 0 (x − mean)."""
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(j_instance_norm(jnp.asarray(x.transpose(0, 2, 3, 1))))
    x_t = torch.from_numpy(x).requires_grad_()
    got = instance_norm(x_t)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), want, atol=1e-5)
    got.sum().backward()  # the 1×1 branch keeps the graph
    assert x_t.grad is not None


def test_slice_ids_match_jax(chain, port):
    clear = chain["gap"] > 1e-4
    assert clear.all(), f"{(~clear).sum()} ids at a near-tie"
    np.testing.assert_array_equal(port["ids"][clear], chain["ids"][clear])


def test_slice_prior_steps_match_jax(chain, port):
    for (gl, ga), (wl, wa) in zip(port["metrics"], chain["metrics"]):
        np.testing.assert_allclose(gl, wl, rtol=1e-5)
        assert ga == wa


def test_slice_sampled_grids_match_jax(chain, port):
    np.testing.assert_array_equal(chain["replay"], chain["compiled"])
    clear = np.cumprod(chain["margins"].min(0) > MARGIN_TOL).astype(bool)
    print(f"slice: smallest margin {chain['margins'].min():.3e}, steps clear {int(clear.sum())}")
    assert clear.all()
    assert port["grids"].dtype == np.int32
    np.testing.assert_array_equal(port["grids"], chain["compiled"])


def test_slice_decoded_samples_match_jax(chain, port):
    assert port["images"].shape == (B, SIZE, SIZE, 1)
    np.testing.assert_allclose(port["images"], chain["images"], atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the CLI end to end on the CPU
# ---------------------------------------------------------------------------

CLI_MODEL = {"in_channels": 1, "enc_filters": [4, 8, 8, 16, 16],
             "dec_filters": [8, 8, 16, 16, 32], "dict_size": 5, "momentum": 0.99,
             "knn_backend": "pallas", "dec_use_styled_up_block": True,
             "dropped_skip_layers": [], "use_pixel_shuffle": False}


def _lung_tree(root, n=4, seed=0):
    rng = np.random.default_rng(seed)
    d = root / "pat00"
    d.mkdir(parents=True)
    for s in range(n):
        np.save(d / f"ct_img_{s:04d}.npy",
                rng.normal(-500, 300, (SIZE, SIZE)).astype(np.float32))


def _cli_config(tmp_path):
    _lung_tree(tmp_path / "data")
    cfg = {"dataset": {"dataset_name": "NCCLungDataset", "root_dir_path": str(tmp_path / "data"),
                       "batch_size": 2, "num_workers": 0, "image_size": [SIZE, SIZE],
                       "window_width": 4096, "window_center": 0.0, "window_scale": 2.0},
           "model": {"vqmodel": CLI_MODEL}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return cfg, path


def _first_stage_ckpt(tmp_path, cfg):
    """A first-stage train state's checkpoint, written by
    `utils/checkpoint.py`, of modules with weights other than the CLI's
    seeded ones."""
    enc, dec, _ = train_prior.build_first_stage(cfg, device="cpu", seed=11)
    with torch.no_grad():
        enc.vq.embed.mul_(3.0)
    state = create_train_state(enc, dec, make_optimizer(enc.parameters(), 1e-4),
                               make_optimizer(dec.parameters(), 1e-4), device="cpu")
    path = CheckpointManager(str(tmp_path / "ckpt")).save(state, 0)
    return path, load_state_file(path)


def test_cli_trains_samples_and_restores(tmp_path, monkeypatch, capsys):
    cfg, cfg_path = _cli_config(tmp_path)
    ckpt, saved = _first_stage_ckpt(tmp_path, cfg)
    seen = {}
    create, build = tprior.create_prior_state, train_prior.build_first_stage

    def recording_create(*args, **kw):
        seen["prior"] = create(*args, **kw)
        return seen["prior"]

    def recording_build(*args, **kw):
        built = build(*args, **kw)
        seen["first_stage"] = built[:2]
        return built

    monkeypatch.setattr(tprior, "create_prior_state", recording_create)
    monkeypatch.setattr(train_prior, "build_first_stage", recording_build)
    out = tmp_path / "prior_out"
    rc = train_prior.main(["-c", str(cfg_path), "--ckpt", str(tmp_path / "ckpt"),
                           "--steps", "3", "--sample", "2", "--n-layer", "1", "--n-head", "2",
                           "--n-embd", "16", "--log-every", "1", "--out", str(out),
                           "--device", "cpu"])
    assert rc == 0
    log = capsys.readouterr().out
    assert f"first stage restored from {tmp_path / 'ckpt'}" in log
    assert [line.split(":")[0] for line in log.splitlines() if line.startswith("step")] == [
        "step 1", "step 2", "step 3"]

    # --ckpt: the frozen modules are the checkpoint's
    encoder, decoder = seen["first_stage"]
    for part, module in (("encoder", encoder), ("decoder", decoder)):
        for k, v in module.state_dict().items():
            assert torch.equal(v, saved[part][k]), (part, k)
    assert encoder.knn_backend == "xla" and not encoder.training and not decoder.training

    # the files
    assert (out / "samples.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    ids = np.load(out / "sample_ids.npy")
    assert ids.shape == (2, SIZE, SIZE) and ids.dtype == np.int32
    assert ids.min() >= 0 and ids.max() < CLI_MODEL["dict_size"]

    # the reloaded prior gives the trained model's logits exactly
    stored = load_state_file(str(out / "prior_ckpt"))
    gcfg = GPTConfig(**stored["config"])
    assert (gcfg.block_size, gcfg.vocab_size, gcfg.n_layer) == (SIZE * SIZE, 6, 1)
    reloaded = GPT(gcfg)
    reloaded.load_state_dict(stored["gpt"], strict=True)
    trained = seen["prior"].gpt.eval()
    assert seen["prior"].step == 3
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 6, (2, SIZE * SIZE)))
    with torch.no_grad():
        assert torch.equal(reloaded.eval()(idx), trained(idx))


def test_cli_refuses_a_missing_checkpoint(tmp_path):
    _, cfg_path = _cli_config(tmp_path)
    with pytest.raises(FileNotFoundError):
        train_prior.main(["-c", str(cfg_path), "--ckpt", str(tmp_path / "nothing"),
                          "--steps", "1", "--sample", "0", "--device", "cpu"])


def test_build_first_stage_follows_jax_constructor_calls():
    """The encoder's assignment is the plain one (JAX passes no
    `knn_backend`) whatever the config names, and the grid is the image's
    full resolution."""
    cfg = {"dataset": {"image_size": [32, 16]}, "model": {"vqmodel": CLI_MODEL}}
    enc, dec, grid = train_prior.build_first_stage(cfg, device="cpu")
    assert grid == (32, 16)
    assert enc.knn_backend == "xla" and enc.vq.embed.shape == (5, 4)
    assert enc.compute_dtype is None and dec.compute_dtype is None
