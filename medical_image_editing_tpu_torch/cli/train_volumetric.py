"""3-D volumetric VQ training CLI (BASELINE config #5).

Counterpart of `medical_image_editing_tpu/cli/train_volumetric.py`. Trains the
volumetric VQ-WNet (`models/volumetric.py`) on a directory of 3-D `.npy`
volumes (one fixed-shape array per file, any dtype convertible to float32,
mapped to [-1, 1] with --vmin/--vmax) or, with no --data-dir, on synthetic
structured volumes; batches are drawn as the JAX CLI draws them, so both
train on the same volumes in the same order.

    python -m medical_image_editing_tpu_torch.cli.train_volumetric \\
        --size 128 --batch 2 --steps 200 --out volumetric_out [--device cpu]

    torchrun --nproc-per-node 4 -m medical_image_editing_tpu_torch.cli.train_volumetric \\
        --mesh 2,2 --size 128 --batch 2 --steps 200 --out volumetric_out

Outputs under --out: `volumetric_ckpt/state.pt` = {"enc", "dec", "vq":
{embed, cluster_size, embed_avg (C, K)}} (the modules' state dicts and the
codebook as every checkpoint of the port holds it), written atomically
(`utils/checkpoint.py::save_state_dir`); the JAX CLI writes Orbax there. And
`recon_mid.png`, the centre slices of the first batch and their
reconstructions.

`--mesh data,spatial` shards every batch over a `data × spatial` grid of
the `torchrun` group's ranks (`parallel/mesh.py::create_volumetric_mesh`,
`train/volumetric.py`): every rank draws the same batch indices from the
seed and takes its (batch block, depth block); rank 0 writes the
checkpoint, and the panel's centre slices are gathered from the ranks
that hold them. More than one rank without `--mesh` is refused.
"""

import argparse
import contextlib
import glob
import os


def _load_volumes(data_dir, vmin, vmax):
    import numpy as np

    paths = sorted(glob.glob(os.path.join(data_dir, "*.npy")))
    if not paths:
        raise SystemExit(f"no .npy volumes under {data_dir}")
    vols = []
    shape = None
    for p in paths:
        v = np.load(p).astype(np.float32)
        if v.ndim != 3:
            raise SystemExit(f"{p}: expected 3-D volume, got shape {v.shape}")
        if shape is None:
            shape = v.shape
        elif v.shape != shape:
            raise SystemExit(f"{p}: shape {v.shape} != first volume {shape}")
        v = np.clip(v, vmin, vmax)
        v = (v - vmin) / (vmax - vmin) * 2.0 - 1.0
        vols.append(v)
    return np.stack(vols)[..., None]  # (N, D, H, W, 1)


def _synthetic_volumes(n, size, seed):
    """Smooth blobs on a gradient — structured enough for the VQ to learn."""
    import numpy as np

    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, size)] * 3, indexing="ij")
    vols = []
    for _ in range(n):
        v = 0.3 * zz
        for _ in range(4):
            c = rng.uniform(-0.7, 0.7, 3)
            r = rng.uniform(0.15, 0.4)
            d2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
            v = v + rng.uniform(0.4, 1.0) * np.exp(-d2 / (2 * r * r))
        vols.append(np.tanh(v).astype(np.float32))
    return np.stack(vols)[..., None]


def main(argv=None):
    from ..utils.device import apply_conv_precision

    apply_conv_precision()
    parser = argparse.ArgumentParser(description="3-D volumetric VQ trainer")
    parser.add_argument("--data-dir", default=None,
                        help=".npy 3-D volumes; omit for synthetic volumes")
    parser.add_argument("--vmin", type=float, default=-1000.0)
    parser.add_argument("--vmax", type=float, default=1000.0)
    parser.add_argument("--size", type=int, default=64,
                        help="synthetic volume edge length")
    parser.add_argument("--n-synthetic", type=int, default=16)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--filters", default="8,16,32,64")
    parser.add_argument("--dict-size", type=int, default=10)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--mesh", default=None,
                        help="'data,spatial' rank counts under torchrun, e.g. '2,2'")
    parser.add_argument("--out", default="volumetric_out")
    parser.add_argument("--log-every", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from ..models.volumetric import volumetric_forward
    from ..ops.vq import VQModule
    from ..parallel.mesh import VolumetricMesh, barrier, rank_device, torchrun_mesh
    from ..train.volumetric import init_volumetric, make_volumetric_train_step, refuse_ranks
    from ..utils.checkpoint import save_state_dir
    from ..utils.imaging import save_image_grid

    if args.mesh:
        md, ms = (int(x) for x in args.mesh.split(","))
        grid = torchrun_mesh(md, ms, args.device)
    else:
        refuse_ranks()
        grid = contextlib.nullcontext(VolumetricMesh(1, 1))
    with grid as mesh:
        device = rank_device(args.device)
        writer = mesh.rank == 0
        if args.data_dir:
            data = _load_volumes(args.data_dir, args.vmin, args.vmax)
        else:
            data = _synthetic_volumes(args.n_synthetic, args.size, args.seed)
        n, d, h, w, _ = data.shape
        if writer:
            print(f"{n} volumes of {d}x{h}x{w}")
        if args.mesh and writer:
            print(f"mesh: data={mesh.data} x spatial={mesh.spatial}")

        filters = tuple(int(f) for f in args.filters.split(","))
        enc, dec, vq, enc_opt, dec_opt = init_volumetric(
            torch.Generator().manual_seed(args.seed), filters=filters,
            dict_size=args.dict_size, volume_shape=(args.batch, d, h, w, 1), lr=args.lr,
            device=device,
        )
        step = make_volumetric_train_step(enc, dec, enc_opt, dec_opt, mesh=mesh)

        rng = np.random.default_rng(args.seed)
        for i in range(args.steps):
            idx = rng.choice(n, args.batch, replace=n < args.batch)
            vq, metrics = step(vq, mesh.block(data[idx]))
            if writer and ((i + 1) % args.log_every == 0 or i == 0 or i + 1 == args.steps):
                print(f"step {i + 1}: total={float(metrics['total']):.4f} "
                      f"recon={float(metrics['recon']):.4f} "
                      f"commit={float(metrics['commit']):.4f}", flush=True)

        if writer:
            codebook = VQModule(*vq.embed.shape)
            codebook.set_state(vq)
            path = save_state_dir(os.path.join(args.out, "volumetric_ckpt"),
                                  {"enc": enc.state_dict(), "dec": dec.state_dict(),
                                   "vq": codebook.state_dict()})
            print(f"checkpoint: {path}")

        # centre-slice recon panel: input | recon for the first batch
        vol = data[: args.batch]
        with torch.no_grad():
            recon, _, _, _ = volumetric_forward(enc, dec, vq,
                                                torch.as_tensor(mesh.block(vol), device=device),
                                                train=False, mesh=mesh)
        # each batch block's centre slices, from the rank whose depth block holds them
        mid = d // 2
        centre = recon.new_zeros((args.batch,) + tuple(recon.shape[2:]))
        rows, slabs = recon.shape[0], recon.shape[1]
        row, col = mesh.coords
        if mid // slabs == col:
            centre[row * rows:(row + 1) * rows] = recon[:, mid % slabs]
        (centre,) = mesh.psum([centre])
        if writer:
            panel = np.concatenate([vol[:, mid], centre.cpu().numpy()])  # (2B, H, W, 1)
            save_image_grid((panel + 1.0) / 2.0, os.path.join(args.out, "recon_mid.png"),
                            nrow=args.batch)
            print(f"recon panel: {os.path.join(args.out, 'recon_mid.png')}")
        barrier()
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
