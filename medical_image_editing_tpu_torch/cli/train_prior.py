"""Train an autoregressive prior over VQ ids and sample novel images.

Counterpart of `medical_image_editing_tpu/cli/train_prior.py`: freeze a
trained first-stage VQ-WNet, encode the dataset to id grids, teacher-force
a causal transformer over the raster order (`train/prior.py`), then sample
grids with the KV-cache sampler and decode them through the codebook and
the decoder.

    python -m medical_image_editing_tpu_torch.cli.train_prior -c config.json \\
        --ckpt RUN_DIR/version_0/ckpt [--steps 2000] [--sample 8] [--out prior_out] \\
        [--n-layer 8 --n-head 8 --n-embd 256] [--temperature 1.0 --top-k 5] [--device cpu]

The first stage is built as the JAX CLI builds it (`build_first_stage`),
in f32: the encoder with the default plain VQ assignment ("xla", whatever
`knn_backend` the config names) and the decoder from the config's
`dec_filters`. `--ckpt` restores its encoder (with the codebook) and
decoder from a checkpoint of the port's trainer (`run_vqwnet`'s `ckpt`
directory, whose newest save is taken, or one `ckpt-epoch=...`
directory) through `cli/run_recon.py::load_model`; without it the ids
come from a seeded random first stage. Under `MEDIMG_CONV_IMPL=packed` the
first stage's packable 3×3 convolutions run on the packed conv kernel.

The id grid has the image's full resolution, so `block_size` is H*W: a
64² image is 4,096 tokens, and the full attention of a 256² image (65,536
tokens) does not fit one card.

Outputs under --out: `prior_ckpt/state.pt` = {"gpt": the prior's state
dict, "config": its `GPTConfig` as a dict}, written atomically
(`utils/checkpoint.py::save_state_dir`; the JAX CLI writes Orbax there);
with --sample N > 0, `samples.png` (the decoded grids, 4 a row) and
`sample_ids.npy` ((N, H, W) int32 ids in [0, dict_size)).
"""

import argparse
import copy
import json
import os
from types import SimpleNamespace


def first_stage_config(cfg, ckpt=None):
    """The frozen first stage of a run_vqwnet-style config dict as a
    `run_recon.load_model` config, with JAX `build_first_stage`'s
    constructor calls: f32, the encoder at the default `knn_backend` ("xla",
    the plain assignment) whatever the config names, the decoder without
    `dec_use_styled_up_block` (neither package's decoder has one); `ckpt`
    (or None: seeded weights) restored."""
    vqm = cfg["model"]["vqmodel"]
    return SimpleNamespace(
        in_channels=int(vqm.get("in_channels", 1)),
        enc_filters=tuple(vqm["enc_filters"]),
        dec_filters=tuple(vqm["dec_filters"]),
        dict_size=int(vqm["dict_size"]),
        momentum=float(vqm.get("momentum", 0.99)),
        enc_use_styled_up_block=bool(vqm.get("enc_use_styled_up_block", False)),
        knn_backend="xla",
        compute_dtype=None,
        use_dropblock=bool(vqm.get("use_dropblock", False)),
        block_size=int(vqm.get("block_size", 3)),
        dropped_skip_layers=tuple(vqm.get("dropped_skip_layers", ()) or ()),
        use_pixel_shuffle=bool(vqm.get("use_pixel_shuffle", False)),
        resume_checkpoint=ckpt,
    )


def build_first_stage(cfg, *, device="cuda", seed: int = 0, ckpt=None):
    """The frozen first stage of a run_vqwnet-style config dict → (encoder,
    decoder, grid_hw), on `device` in eval mode, built and restored by
    `run_recon.load_model` (`first_stage_config`)."""
    import torch

    from .run_recon import load_model

    config = first_stage_config(cfg, ckpt)
    encoder, decoder, _ = load_model(config, device=device, seed=seed)
    h, w = (int(s) for s in cfg["dataset"]["image_size"])
    with torch.device("meta"), torch.no_grad():  # shapes only: no kernel runs on meta
        feats = copy.deepcopy(encoder).to("meta")(torch.zeros(1, config.in_channels, h, w))
    return encoder, decoder, tuple(int(s) for s in feats.shape[2:])


def main(argv=None):
    from ..utils.device import apply_conv_precision

    apply_conv_precision()
    parser = argparse.ArgumentParser(description="VQ-id prior trainer/sampler")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--ckpt", default=None,
                        help="first-stage checkpoint of the port's trainer to freeze "
                             "(default: random init — smoke/debug only)")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch", type=int, default=None,
                        help="prior batch size (default: dataset batch_size)")
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--n-layer", type=int, default=8)
    parser.add_argument("--n-head", type=int, default=8)
    parser.add_argument("--n-embd", type=int, default=256)
    parser.add_argument("--dropout", type=float, default=0.1)
    parser.add_argument("--sample", type=int, default=8,
                        help="grids to sample + decode at the end (0 = skip)")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--top-k", type=int, default=None)
    parser.add_argument("--out", default="prior_out")
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from ..data import get_data_loader
    from ..models.mingpt import GPTConfig
    from ..models.unet_encoder import get_embed_from_ids
    from ..train.prior import create_prior_state, make_prior_sampler, make_prior_train_step
    from ..utils.checkpoint import save_state_dir
    from ..utils.device import resolve_device
    from ..utils.imaging import save_image_grid

    device = resolve_device(args.device)
    with open(args.config) as f:
        cfg = json.load(f)

    encoder, decoder, grid_hw = build_first_stage(cfg, device=device, ckpt=args.ckpt)
    if args.ckpt:
        print(f"first stage restored from {args.ckpt}")
    else:
        print("WARNING: no --ckpt; prior trains on ids of a RANDOM first stage")

    dict_size = int(cfg["model"]["vqmodel"]["dict_size"])
    sos = dict_size
    gcfg = GPTConfig(
        vocab_size=dict_size + 1,
        block_size=grid_hw[0] * grid_hw[1],
        n_layer=args.n_layer,
        n_head=args.n_head,
        n_embed=args.n_embd,
        emb_pdrop=args.dropout,
        res_pdrop=args.dropout,
        att_pdrop=args.dropout,
    )
    pstate = create_prior_state(args.seed, gcfg, lr=args.lr, weight_decay=0.01, device=device)
    pstep = make_prior_train_step(sos_token=sos)

    @torch.no_grad()
    def extract_ids(image):
        # encoder ids are 1-based (0 = VQ background convention); the grids
        # seen in training have no background → 0-based LM vocab
        _, _, ids, _ = encoder.encode(image)
        return ids - 1

    ds = cfg["dataset"]
    loader = get_data_loader(
        "train", ds["dataset_name"], ds["root_dir_path"],
        batch_size=int(args.batch or ds["batch_size"]),
        num_workers=int(ds.get("num_workers", 0) or 0),
        modality=ds.get("modality"),
        augmentations=[],  # ids of the CLEAN slices are the LM corpus
        drop_last=True,
        window_width=ds.get("window_width"),
        window_center=ds.get("window_center"),
        window_scale=ds.get("window_scale"),
        seed=args.seed,
    )

    os.makedirs(args.out, exist_ok=True)
    step_n = 0
    while step_n < args.steps:
        for batch in loader:
            ids = extract_ids(torch.as_tensor(batch["image"], device=device))
            pstate, metrics = pstep(pstate, ids)
            step_n += 1
            if step_n % args.log_every == 0 or step_n == args.steps:
                print(f"step {step_n}: loss={float(metrics['loss']):.4f} "
                      f"acc={float(metrics['acc']):.3f}", flush=True)
            if step_n >= args.steps:
                break

    prior_path = save_state_dir(os.path.join(args.out, "prior_ckpt"),
                                {"gpt": pstate.gpt.state_dict(), "config": gcfg._asdict()})
    print(f"prior saved: {prior_path}")

    if args.sample > 0:
        sampler = make_prior_sampler(pstate.gpt, sos_token=sos, grid_hw=grid_hw,
                                     temperature=args.temperature, top_k=args.top_k)
        generator = torch.Generator(device=device).manual_seed(args.seed + 1)
        grids = sampler(args.sample, generator=generator)
        with torch.no_grad():
            q = get_embed_from_ids(encoder.vq.state(), grids)
            images = decoder(q.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        out_png = os.path.join(args.out, "samples.png")
        # decoder output is in [-1, 1]; the grid helper expects [0, 1]
        save_image_grid((images.float().cpu().numpy() + 1.0) / 2.0, out_png, nrow=4)
        np.save(os.path.join(args.out, "sample_ids.npy"), grids.cpu().numpy())
        print(f"samples: {out_png}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
