"""Rank processes of `tests/test_torch_port_parallel.py` and
`tests/test_torch_port_parallel_gan*.py`: each imports torch and the port
only, joins a gloo process group, runs one task on the inputs the test
wrote (numpy arrays and the port's state dicts, made from seeds) and saves
what it computed for the test to hold against JAX.

Started by the test with `torch.multiprocessing`'s spawn context:
`run(rank, world, init, task, workdir)`; `init` is a `file://` path (the
group made here) or "env" (`parallel.initialize_distributed` from a
one-rank `torchrun`-style environment).
"""

import contextlib
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from medical_image_editing_tpu_torch.parallel import mesh

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "lung_first_stage.json")
ENC = (4, 8, 16, 32, 64)
DEC = (32, 8, 16)  # level 0 at 32 channels: the decoder's convs there route to the kernel
DICT = 10


def lung_tree(root, n_patients=2, n_slices=5, size=32, seed=0):
    """A fabricated lung slice tree (HU `.npy` slices), as the trainer
    tests write one."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for p in range(n_patients):
        d = os.path.join(root, f"pat{p}")
        os.makedirs(d)
        for s in range(n_slices):
            img = -600 + 800 * (yy - 0.5) + 1200 * np.exp(
                -((yy - rng.uniform(0.3, 0.7)) ** 2 + (xx - rng.uniform(0.3, 0.7)) ** 2) / 0.02)
            img = img + rng.normal(0, 150, img.shape)
            np.save(os.path.join(d, f"ct_img_{s:04d}.npy"), img.astype(np.float32))


def cli_config(root, **run):
    """The lung first-stage config at test widths over `root/data`, saving
    under `root/results`."""
    cfg = json.load(open(CONFIG))
    cfg["dataset"].update(root_dir_path=os.path.join(root, "data"), batch_size=2,
                          num_workers=0, image_size=[32, 32])
    cfg["model"]["vqmodel"].update(enc_filters=[4, 8, 8, 16, 16],
                                   dec_filters=[8, 8, 16, 16, 32], knn_backend="pallas",
                                   compute_dtype="float32")
    cfg["save"].update(save_dir=os.path.join(root, "results"), n_save_images=2)
    cfg["run"].update({"n_epochs": 2, **run})
    return cfg


def _models(axis_name, weights):
    from medical_image_editing_tpu_torch.models import UNetDecoder
    from medical_image_editing_tpu_torch.models.unet_encoder import EncoderWithVQ
    from medical_image_editing_tpu_torch.train import state as tstate
    from medical_image_editing_tpu_torch.utils.config import load_json

    cfg = load_json(CONFIG)
    enc = EncoderWithVQ(1, ENC, DICT, momentum=float(cfg.model.vqmodel.momentum),
                        knn_backend="pallas", axis_name=axis_name)
    dec = UNetDecoder(ENC[0], 1, DEC, dropped_skip_layers=(), use_pixel_shuffle=False,
                      axis_name=axis_name)
    enc.load_state_dict(weights["encoder"], strict=True)
    dec.load_state_dict(weights["decoder"], strict=True)
    state = tstate.create_train_state(
        enc, dec, tstate.make_optimizer_from_config(enc.parameters(), cfg.enc_optim),
        tstate.make_optimizer_from_config(dec.parameters(), cfg.dec_optim), seed=5,
        device="cpu")
    return cfg, state


def _step_fn(cfg, state, axis_name):
    from medical_image_editing_tpu_torch.train import first_stage as tfs

    return tfs.make_first_stage_step(state.encoder, state.decoder,
                                     loss_cfg=tfs.loss_config_from_json(cfg.loss),
                                     aug_cfg=cfg.augmentation, dict_size=DICT, device="cpu",
                                     axis_name=axis_name)


def _snapshot(state):
    """Every tensor of the state, cloned: modules, Adam states, generator."""
    sd = state.state_dict()
    return {"encoder": {k: v.clone() for k, v in sd["encoder"].items()},
            "decoder": {k: v.clone() for k, v in sd["decoder"].items()},
            "enc_opt": sd["enc_opt"], "dec_opt": sd["dec_opt"],
            "generator": sd["generator"].clone(), "step": sd["step"]}


def _grads(opt, module):
    """Adam's first moment after one step is (1 − b1)·g → {key: g}."""
    names = {id(p): k for k, p in module.named_parameters()}
    b1 = opt.param_groups[0]["betas"][0]
    return {names[id(p)]: s["exp_avg"] / (1 - b1) for p, s in opt.state.items()}


def task_pieces(rank, world, workdir):
    """pmean, the synced batch norm, quantize's averaged statistics and EMA,
    the gathered k-means, each on this rank's block of the inputs."""
    from medical_image_editing_tpu_torch.models.blocks import FlaxBatchNorm
    from medical_image_editing_tpu_torch.models.unet_encoder import init_codebook_from_batch
    from medical_image_editing_tpu_torch.ops.vq import VQState, vq_apply

    npz = np.load(os.path.join(workdir, "pieces.npz"))
    x = {k: torch.from_numpy(v) for k, v in npz.items()}
    ax = mesh.DATA_AXIS
    out = {"pmean": mesh.pmean([x["a"][rank], x["b"][rank]])}

    # batch norm: NHWC inputs, this rank's rows
    bn = FlaxBatchNorm(x["bn_x"].shape[-1], affine=True, axis_name=ax)
    with torch.no_grad():
        bn.weight.copy_(x["bn_scale"])
        bn.bias.copy_(x["bn_bias"])
    xb = mesh.shard_batch(x["bn_x"], rank, world).permute(0, 3, 1, 2).clone()
    xb.requires_grad_()
    tb = mesh.shard_batch(x["bn_t"], rank, world).permute(0, 3, 1, 2)
    y = bn(xb)
    (y * tb).mean().backward()
    gw, gb = mesh.pmean([bn.weight.grad, bn.bias.grad])
    out["bn"] = {"y": y.detach().permute(0, 2, 3, 1), "dx": xb.grad.permute(0, 2, 3, 1),
                 "dscale": gw, "dbias": gb, "mean": bn.running_mean, "var": bn.running_var,
                 "tracked": bn.num_batches_tracked}

    # quantize: momentum 0 leaves the averaged counts and sums in the state
    state = VQState(x["vq_embed"], x["vq_cluster"], x["vq_avg"])
    feats = mesh.shard_batch(x["vq_x"], rank, world)
    out["vq"] = {m: tuple(vq_apply(state, feats, momentum=m, train=True, backend="pallas",
                                   axis_name=ax)[3]) for m in (0.0, 0.99)}
    out["vq_local_ids"] = vq_apply(state, feats, train=True, backend="pallas")[2]

    feats = mesh.shard_batch(x["km_x"], rank, world)
    out["kmeans"] = tuple(init_codebook_from_batch(
        feats, state, num_iters=10, init_idx=x["km_idx"], axis_name=ax))
    return out


def task_step(rank, world, workdir):
    """k-means then one first-stage step on this rank's rows, the draws and
    start rows given (from the JAX keys)."""
    from medical_image_editing_tpu_torch.train import first_stage as tfs

    inputs = torch.load(os.path.join(workdir, "step.pt"), weights_only=True)
    cfg, state = _models(mesh.DATA_AXIS, inputs["weights"])
    image = mesh.shard_batch(inputs["image"], rank, world)
    tfs.init_codebook_step(state.encoder)(
        state, image, init_idx=inputs["init_idx"])
    vq_init = tuple(t.clone() for t in state.vq)
    mesh.collectives.clear()
    state, metrics = _step_fn(cfg, state, mesh.DATA_AXIS)(state, image,
                                                          draws=inputs["draws"][rank])
    return {"vq_init": vq_init, "metrics": metrics, "state": _snapshot(state),
            "collectives": dict(mesh.collectives),
            "enc_grads": _grads(state.enc_opt, state.encoder),
            "dec_grads": _grads(state.dec_opt, state.decoder)}


def _short_run(axis_name, weights, image):
    from medical_image_editing_tpu_torch.train import first_stage as tfs

    cfg, state = _models(axis_name, weights)
    tfs.init_codebook_step(state.encoder)(state, image)
    step = _step_fn(cfg, state, axis_name)
    metrics = [step(state, image)[1] for _ in range(2)]
    return {"state": _snapshot(state), "metrics": metrics}


def task_one_rank(rank, world, workdir):
    """The k-means and two steps (draws from the generator) under this
    one-rank group, built with `DATA_AXIS`; then the group destroyed and
    the same built without it."""
    inputs = torch.load(os.path.join(workdir, "step.pt"), weights_only=True)
    out = {"backend": dist.get_backend(), "world": mesh.world(),
           "again": mesh.initialize_distributed("cpu")}
    out["group"] = _short_run(mesh.DATA_AXIS, inputs["weights"], inputs["image"])
    mesh.destroy_distributed()
    out["none"] = _short_run(None, inputs["weights"], inputs["image"])
    return out


def task_cli(rank, world, workdir):
    """`run_vqwnet.main` on this rank: 4 steps straight, 2 and a resume to
    4, `-m test`."""
    from medical_image_editing_tpu_torch.cli import run_vqwnet

    def cli(name, argv, **run):
        path = os.path.join(workdir, f"{name}.json")
        if rank == 0:
            with open(path, "w") as f:
                json.dump(cli_config(workdir, **run), f)
        dist.barrier()
        run_vqwnet.main(["-c", path, "--device", "cpu"] + argv)
        return os.path.join(workdir, "results", "lung_first_stage")

    out = {}
    run = cli("straight", ["-m", "train", "--max-steps", "4"])
    cli("split", ["-m", "train", "--max-steps", "2"])
    cli("split", ["-m", "train", "--max-steps", "4"],
        resume_checkpoint=os.path.join(run, "version_1", "ckpt"))
    cli("test", ["-m", "test"], resume_checkpoint=os.path.join(run, "version_0", "ckpt"))
    out["save_dir"] = run
    return out


def task_main(rank, world, workdir):
    return {**task_pieces(rank, world, workdir), **task_step(rank, world, workdir)}


def run(rank, world, init, task, workdir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if init == "env":
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT="0")
        if not mesh.initialize_distributed("cpu"):
            raise RuntimeError("initialize_distributed made no group")
    else:
        dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                                world_size=world)
    try:
        out = TASKS[task](rank, world, workdir)
    finally:
        mesh.destroy_distributed()
    torch.save(out, os.path.join(workdir, f"{task}-{rank}.pt"))


# ---------------------------------------------------------------------------
# the GAN trainers (ROADMAP 15(ii))
# ---------------------------------------------------------------------------
CONFIGS = {kind: os.path.join(os.path.dirname(__file__), "..", "configs", name)
           for kind, name in (("second", "lung_second_stage.json"),
                              ("mw_first", "lung_multiwindow_joint.json"),
                              ("mw_second", "lung_multiwindow_joint.json"),
                              ("joint", "lung_multiwindow_joint.json"),
                              ("vqgan", "crc_vqgan.json"))}
GAN_ENC = (4, 4, 8, 8, 8)
GAN_DEC = (4, 8, 8)  # no level at 32 channels: no routed convolution
GAN_DICT = 5
GAN_DCH = 2
VQGAN_KW = dict(in_channels=1, mid_channels=4, out_channels=1, emb_dim=8, dict_size=6,
                enc_ch_multiplier=(1, 2, 4), dec_ch_multiplier=(1, 2, 4), num_res_blocks=1,
                enc_attn_resolutions=(), dec_attn_resolutions=(8,), resolution=32,
                knn_backend="pallas")
MODULES = {"second": ("decoder", "discriminator"), "mw_first": ("encoder", "decoder"),
           "mw_second": ("decoder", "discriminator"),
           "joint": ("encoder", "decoder", "discriminator"),
           "vqgan": ("decoder", "discriminator")}
OPTS = {"encoder": "enc_opt", "decoder": "dec_opt", "discriminator": "dis_opt"}


def dataset_window(cfg):
    ds = cfg.dataset
    return (float(ds.window_width), float(ds.window_center), float(ds.window_scale))


def gan_state(kind, weights, axis_name):
    """The port's state of `kind` at test widths, from `weights` (the JAX
    initial state through the weight bridge), its modules built with
    `axis_name`."""
    from medical_image_editing_tpu_torch.models import VQGAN, UNetDecoder
    from medical_image_editing_tpu_torch.models.unet_discriminator import UNetDiscriminator
    from medical_image_editing_tpu_torch.models.unet_encoder import EncoderWithVQ
    from medical_image_editing_tpu_torch.train import state as tstate
    from medical_image_editing_tpu_torch.utils.config import load_json

    cfg = load_json(CONFIGS[kind])
    opt = tstate.make_optimizer_from_config
    dis = dis_opt = None
    if kind != "mw_first":
        dis = UNetDiscriminator(D_ch=GAN_DCH, D_attn="0", resolution=128)
        dis.load_state_dict(weights["discriminator"], strict=True)
        dis_opt = opt(dis.parameters(), cfg.dis_optim)
    if kind == "vqgan":
        vqgan = VQGAN(**VQGAN_KW, axis_name=axis_name)
        vqgan.load_state_dict(weights["decoder"], strict=True)
        state = tstate.create_train_state(None, vqgan, None, opt(vqgan.parameters(),
                                                                  cfg.dec_optim),
                                          device="cpu", discriminator=dis, dis_opt=dis_opt)
        return cfg, state
    enc = EncoderWithVQ(1, GAN_ENC, GAN_DICT, momentum=float(cfg.model.vqmodel.momentum),
                        knn_backend="pallas", axis_name=axis_name)
    dec = UNetDecoder(GAN_ENC[0], 1, GAN_DEC, dropped_skip_layers=(), use_pixel_shuffle=False,
                      axis_name=axis_name)
    enc.load_state_dict(weights["encoder"], strict=True)
    dec.load_state_dict(weights["decoder"], strict=True)
    state = tstate.create_train_state(enc, dec, opt(enc.parameters(), cfg.enc_optim),
                                      opt(dec.parameters(), cfg.dec_optim), device="cpu",
                                      discriminator=dis, dis_opt=dis_opt)
    return cfg, state


def gan_step_fn(kind, cfg, state, axis_name):
    """The port's step of `kind` on `state`'s models, the configs' losses."""
    from medical_image_editing_tpu_torch.train import first_stage as tfs
    from medical_image_editing_tpu_torch.train import multi_window as tmw
    from medical_image_editing_tpu_torch.train import second_stage as tss
    from medical_image_editing_tpu_torch.train import vqgan_stage as tvs
    from medical_image_editing_tpu_torch.utils.config import getattr_else_none as g

    fc = tfs.loss_config_from_json(cfg.loss)
    sc = tss.second_stage_config_from_json(cfg.loss)
    kw = dict(device="cpu", axis_name=axis_name)
    if kind == "second":
        return tss.make_second_stage_step(state.encoder, state.decoder, state.discriminator,
                                          loss_cfg=sc, **kw)
    if kind == "vqgan":
        return tvs.make_vqgan_step(state.decoder, state.discriminator, loss_cfg=sc,
                                   w_commit=fc.w_commit, **kw)
    mw = dict(dataset_window=dataset_window(cfg),
              **{k: tuple(float(v) for v in g(cfg.loss, k))
                 for k in ("recon_weights", "freq_weights", "percep_weights")}, **kw)
    if kind == "mw_first":
        return tmw.make_multi_window_first_stage_step(
            state.encoder, state.decoder, loss_cfg=fc, aug_cfg=cfg.augmentation,
            dict_size=GAN_DICT, **mw)
    if kind == "mw_second":
        return tmw.make_multi_window_second_stage_step(
            state.encoder, state.decoder, state.discriminator, loss_cfg=sc, **mw)
    return tmw.make_joint_step(state.encoder, state.decoder, state.discriminator, first_cfg=fc,
                               second_cfg=sc, aug_cfg=cfg.augmentation, dict_size=GAN_DICT,
                               **mw)


@contextlib.contextmanager
def rounding_floor(seed=0):
    """Inside the block the steps run perturbed at the rounding level, as
    the single-process step tests' floors: PyTorch's native CPU
    convolutions in place of oneDNN's, and the quantized features moved by
    one ulp up or down at random (the gradient still flows straight
    through)."""
    from medical_image_editing_tpu_torch.models import vqgan as tvqgan
    from medical_image_editing_tpu_torch.train import first_stage as tfs
    from medical_image_editing_tpu_torch.train import multi_window as tmw
    from medical_image_editing_tpu_torch.train import second_stage as tss

    gen = torch.Generator().manual_seed(seed)

    def nudge(fn):
        def nudged(*args, **kw):
            q, *rest = fn(*args, **kw)
            up = torch.randint(0, 2, q.shape, generator=gen).bool()
            moved = torch.where(up, torch.nextafter(q, q + 1), torch.nextafter(q, q - 1))
            return (q + (moved - q).detach(), *rest)
        return nudged

    sites = [(tfs, "encode_quantize"), (tmw, "encode_quantize"), (tss, "encode_quantize"),
             (tvqgan, "vq_apply")]
    real = [getattr(m, n) for m, n in sites]
    for (m, n), fn in zip(sites, real):
        setattr(m, n, nudge(fn))
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        for (m, n), fn in zip(sites, real):
            setattr(m, n, fn)


def gan_snapshot(state, kind):
    """The modules' state dicts, Adam's first moments (under the modules'
    parameter names), the generator and the step count, cloned."""
    out = {"step": state.step, "generator": state.generator.get_state().clone()}
    for part in MODULES[kind]:
        module, opt = getattr(state, part), getattr(state, OPTS[part])
        out[part] = {k: v.clone() for k, v in module.state_dict().items()}
        out[part + "_mu"] = {k: opt.state[p]["exp_avg"].clone() for k, p in
                             module.named_parameters()}
    return out


def gan_step(kind, inputs, rank, world, floor=False):
    """One data-parallel step of `kind` on this rank's rows with this
    rank's draws (replayed from JAX's per-device keys)."""
    from medical_image_editing_tpu_torch.ops import _build

    cfg, state = gan_state(kind, inputs["weights"][kind], mesh.DATA_AXIS)
    image = mesh.shard_batch(inputs["image"][kind], rank, world)
    step = gan_step_fn(kind, cfg, state, mesh.DATA_AXIS)
    mesh.collectives.clear()
    _build.launches.clear()
    with rounding_floor() if floor else contextlib.nullcontext():
        state, metrics = step(state, image, draws=inputs["draws"][kind][rank])
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "state": gan_snapshot(state, kind), "collectives": dict(mesh.collectives)}
    if state.discriminator is not None:
        out["buffer_drift"] = int(state.discriminator.buffer_drift)
    return out


def task_gan(rank, world, workdir):
    """Each GAN step of the inputs' kinds, then the same perturbed at the
    rounding level (the tolerances' floor)."""
    inputs = torch.load(os.path.join(workdir, "gan.pt"), weights_only=False)
    return {kind: {"run": gan_step(kind, inputs, rank, world),
                   "floor": gan_step(kind, inputs, rank, world, floor=True)}
            for kind in inputs["kinds"]}


def task_gan_pieces(rank, world, workdir):
    """ActNorm's data init, the PatchGAN's synced BatchNorm, the VQGAN's
    averaged codebook statistics and the discriminator inner loop's
    averaged gradients and buffers, each on this rank's rows."""
    from medical_image_editing_tpu_torch.models import VQGAN
    from medical_image_editing_tpu_torch.models.actnorm import ActNorm
    from medical_image_editing_tpu_torch.models.discriminator import NLayerDiscriminator
    from medical_image_editing_tpu_torch.train import second_stage as tss
    from medical_image_editing_tpu_torch.train import state as tstate
    from medical_image_editing_tpu_torch.utils.config import load_json

    x = torch.load(os.path.join(workdir, "gan_pieces.pt"), weights_only=False)
    ax = mesh.DATA_AXIS
    out = {}

    def rows(t):
        return mesh.shard_batch(t, rank, world)

    an = ActNorm(x["an_x"].shape[-1], axis_name=ax)
    with torch.no_grad():
        an.loc.copy_(x["an_loc"].reshape(an.loc.shape))
        an.scale.copy_(x["an_scale"].reshape(an.scale.shape))
    mesh.collectives.clear()
    with torch.no_grad():
        y = an(rows(x["an_x"]).permute(0, 3, 1, 2).contiguous())
    out["actnorm"] = {"y": y.permute(0, 2, 3, 1), "data_loc": an.data_loc.flatten(),
                      "data_scale": an.data_scale.flatten(),
                      "initialized": int(an.initialized),
                      "collectives": dict(mesh.collectives)}

    def patchgan():
        d = NLayerDiscriminator(n_filters=4, n_layers=2, normalization="batchnorm",
                                apply_spectral_norm=True, axis_name=ax)
        d.load_state_dict(x["patchgan"], strict=True)
        return d.train()

    d = patchgan()
    xb = rows(x["pg_x"]).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    logits = d(xb)
    (logits * rows(x["pg_t"]).permute(0, 3, 1, 2)).mean().backward()
    names = [k for k, _ in d.named_parameters()]
    grads = mesh.pmean([p.grad for p in d.parameters()])
    out["patchgan"] = {"logits": logits.detach().permute(0, 2, 3, 1),
                       "dx": xb.grad.permute(0, 2, 3, 1), "grads": dict(zip(names, grads)),
                       "state": {k: v.clone() for k, v in d.state_dict().items()}}

    vqgan = VQGAN(**VQGAN_KW, axis_name=ax)
    vqgan.load_state_dict(x["vqgan"], strict=True)
    with torch.no_grad():
        recon, commit, ids, _ = vqgan.train()(rows(x["vq_x"]).permute(0, 3, 1, 2))
    out["vqgan"] = {"recon": recon.permute(0, 2, 3, 1), "commit": commit, "ids": ids,
                    "vq": tuple(t.clone() for t in vqgan.vq.state())}

    # the inner loop: the PatchGAN (batch norm, spectral norm), two
    # iterations on the real rows and the fake ones
    cfg = load_json(CONFIGS["second"])
    d = patchgan()
    opt = tstate.make_optimizer_from_config(d.parameters(), cfg.dis_optim)
    loss_cfg = tss.second_stage_config_from_json(cfg.loss)._replace(n_inner_loops=2)
    mesh.collectives.clear()
    _, metrics = tss.discriminator_inner_loop(
        d, rows(x["pg_x"]).permute(0, 3, 1, 2), rows(x["pg_fake"]).permute(0, 3, 1, 2), None,
        loss_cfg, opt, is_unet=False, axis_name=ax)
    out["inner_loop"] = {"dis": float(metrics["dis"].detach()),
                         "collectives": dict(mesh.collectives),
                         "buffer_drift": int(d.buffer_drift),
                         "state": {k: v.clone() for k, v in d.state_dict().items()},
                         "mu": {k: opt.state[p]["exp_avg"].clone()
                                for k, p in d.named_parameters()}}
    return out


def task_gan_cli(rank, world, workdir):
    """`run_vqwnet.main` of each GAN trainer on this rank, on the configs
    the test wrote (`workdir/gan_cli.json`: {name: CLI flags}, each config
    at `workdir/<name>.json`): 2 steps straight, then 1 and a resume to 2;
    `-w` then exports its test set with `-m test`. First a 1-step first
    stage that the second stage stages
    (`first_stage_ckpt_path`); the codebooks the trainer's step-0 k-means
    leaves are recorded."""
    from medical_image_editing_tpu_torch.cli import run_vqwnet
    from medical_image_editing_tpu_torch.train import trainer as ttrainer

    kmeans = []
    real = ttrainer.init_codebook_step

    def recording(encoder, **kw):
        init = real(encoder, **kw)

        def fn(state, image, init_idx=None):
            state = init(state, image, init_idx)
            kmeans.append(state.vq.embed.detach().clone())
            return state

        return fn

    def main(path, flags, steps):
        run_vqwnet.main(["-c", path, "--device", "cpu", "-m", "train", "--max-steps",
                         str(steps)] + flags)

    ttrainer.init_codebook_step = recording
    out = {"kmeans": {}}
    try:
        main(os.path.join(workdir, "stage.json"), [], 1)
        for name, flags in json.load(open(os.path.join(workdir, "gan_cli.json"))).items():
            path = os.path.join(workdir, f"{name}.json")
            cfg = json.load(open(path))
            run = os.path.join(cfg["save"]["save_dir"], cfg["save"]["study_name"])
            kmeans.clear()
            main(path, flags, 2)
            out["kmeans"][name] = list(kmeans)
            main(path, flags, 1)
            if rank == 0:
                cfg["run"]["resume_checkpoint"] = os.path.join(run, "version_1", "ckpt")
                with open(path + ".resume", "w") as f:
                    json.dump(cfg, f)
            dist.barrier()
            main(path + ".resume", flags, 2)
            out[name] = run
            if flags == ["-w"]:  # the multi-window export of the resumed state
                run_vqwnet.main(["-c", path + ".resume", "--device", "cpu", "-m", "test"]
                                + flags)
    finally:
        ttrainer.init_codebook_step = real
    return out


TASKS = {"main": task_main, "one_rank": task_one_rank, "cli": task_cli, "gan": task_gan,
         "gan_pieces": task_gan_pieces, "gan_cli": task_gan_cli}
