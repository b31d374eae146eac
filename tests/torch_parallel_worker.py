"""Rank processes of `tests/test_torch_port_parallel.py`: each imports torch
and the port only, joins a gloo process group, runs one task on the inputs
the test wrote (numpy arrays and the port's state dicts, made from seeds)
and saves what it computed for the test to hold against JAX.

Started by the test with `torch.multiprocessing`'s spawn context:
`run(rank, world, init, task, workdir)`; `init` is a `file://` path (the
group made here) or "env" (`parallel.initialize_distributed` from a
one-rank `torchrun`-style environment).
"""

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


def _refusal(fn):
    try:
        fn()
    except (ValueError, SystemExit) as e:
        return f"{type(e).__name__}: {e}"
    return None


def task_cli(rank, world, workdir):
    """`run_vqwnet.main` on this rank: 4 steps straight, 2 and a resume to
    4, `-m test`; then the trainers that must refuse two ranks."""
    from medical_image_editing_tpu_torch.cli import edit_volume, run_vqwnet, train_volumetric

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
    mode = {"training_mode": "second_step"}
    out["refused"] = {
        "second_step": _refusal(lambda: cli("second", ["-m", "train"], **mode)),
        "multi_window": _refusal(lambda: cli("mw", ["-w", "-m", "train"])),
        "vqgan": _refusal(lambda: cli("vqgan", ["-v", "-m", "train"])),
        "train_volumetric": _refusal(lambda: train_volumetric.main(
            ["--steps", "1", "--size", "8", "--device", "cpu"])),
        "edit_volume_spatial": _refusal(lambda: edit_volume.main(
            ["--ckpt", ".", "--labels", ".", "--out", ".", "--partition", "spatial",
             "--device", "cpu"])),
    }
    return out


def task_main(rank, world, workdir):
    return {**task_pieces(rank, world, workdir), **task_step(rank, world, workdir)}


TASKS = {"main": task_main, "one_rank": task_one_rank, "cli": task_cli}


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
