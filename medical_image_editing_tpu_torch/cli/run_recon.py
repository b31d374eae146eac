"""Interactive editing: model loading and the single-slice edit.

Counterpart of `medical_image_editing_tpu/cli/run_recon.py` (reference
`src/run_recon.py`): the env-configured LungConfig/CRCConfig, model loading
(seeded init, or a reference-format Lightning `.ckpt`), `load_edited_map`
(from `edit_batch`), and per edit
(`inner`, `:169-228`): CRC flip into model space, label 0 → background mask,
ids−1 → codebook lookup, embedding zeroed under the mask and rescaled by
numel/sum(mask), decode, lung re-window, PNG export. The file-watching
`serve` loop (and its `--show` display) is not ported yet.
"""

import datetime
import os

import numpy as np
import torch

from ..models.blocks import seeded_init
from ..models.unet_decoder import UNetDecoder
from ..models.unet_encoder import EncoderWithVQ
from ..utils.device import resolve_device
from .edit_batch import decode_painted, load_edited_map  # noqa: F401 (public here too)


class LungConfig:
    """Spec: `run_recon.py:27-48`."""

    config_name = "LungConfig"
    in_channels = 1
    enc_filters = (16, 32, 64, 128, 256)
    dec_filters = (32, 64, 128, 256, 512)
    dict_size = 10
    momentum = 0.999
    window_width = 4096
    window_center = 0.0
    window_scale = 2.0
    dropped_skip_layers = ()
    use_pixel_shuffle = False
    knn_backend = "xla"

    def __init__(self):
        self.resume_checkpoint = os.environ.get("LUNG_CKPT")
        self.edited_file_path = os.environ.get("LUNG_EDITED_FILE")
        self.save_dir_path = "inference"


class CRCConfig(LungConfig):
    """Spec: `run_recon.py:51-69` (no window re-normalization)."""

    config_name = "CRCConfig"

    def __init__(self):
        super().__init__()
        self.resume_checkpoint = os.environ.get("CRC_CKPT")
        self.edited_file_path = os.environ.get("CRC_EDITED_FILE")


def load_model(config, *, device="cuda", seed: int = 0):
    """Build the encoder (with its codebook) and decoder on `device`, in eval
    mode → (encoder, decoder, vq_state).

    Weights come from a `torch.Generator` seeded with `seed`, or, when
    `config.resume_checkpoint` names a Lightning `.ckpt` file, from that
    file, loaded strictly."""
    dev = resolve_device(device)
    with torch.device("meta"):
        encoder = EncoderWithVQ(
            in_channels=config.in_channels,
            filters=tuple(config.enc_filters),
            dict_size=config.dict_size,
            momentum=config.momentum,
            use_styled_up_block=False,
            knn_backend=config.knn_backend,
        )
        decoder = UNetDecoder(
            in_channels=encoder.emb_dim,
            out_channels=config.in_channels,
            filters=tuple(config.dec_filters),
            dropped_skip_layers=tuple(config.dropped_skip_layers),
            use_pixel_shuffle=bool(config.use_pixel_shuffle),
        )
    generator = torch.Generator().manual_seed(seed)
    for module in (encoder, decoder):
        seeded_init(module.to_empty(device="cpu"), generator)

    path = config.resume_checkpoint
    if path:
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is a directory (an Orbax checkpoint of the JAX "
                "package?); convert it to a Lightning .ckpt with "
                "medical_image_editing_tpu/cli/export_ckpt.py (export-ckpt) "
                "and point the config at that file"
            )
        from ..utils.weights import load_lightning_state

        groups = load_lightning_state(path)
        encoder.load_state_dict(groups["encoder"], strict=True)
        decoder.load_state_dict(groups["decoder"], strict=True)
        print(f"Loaded Lightning ckpt {path}")
    encoder.to(dev).eval()
    decoder.to(dev).eval()
    return encoder, decoder, encoder.vq.state()


def make_edit_fn(decoder, vq_state, config, *, device="cuda"):
    """The edit path: id map (B,H,W) numpy → (recon (B,H,W), mask (B,H,W))
    numpy. Spec: `run_recon.py:182-197`."""
    dev = resolve_device(device)
    decoder.to(dev).eval()
    vq_state = type(vq_state)(*(t.to(dev) for t in vq_state))
    window = (config.window_width, config.window_center, config.window_scale)
    is_lung = config.config_name == "LungConfig"

    @torch.inference_mode()
    def fn(id_map_np):
        ids = torch.as_tensor(np.asarray(id_map_np), device=dev)
        recon, mask = decode_painted(decoder, vq_state, ids, is_lung=is_lung,
                                     dataset_window=window, per_slice=False)
        return recon.cpu().numpy(), mask.cpu().numpy()

    return fn


def process_edit(edit_fn, config, loaded_map, *, save_dir: str = "."):
    """One edit: host-side orientation + PNG exports. Spec: `inner`, `:169-228`."""
    from ..utils.imaging import CMAP, save_image

    timestamp = datetime.datetime.now().strftime("%Y%m%d%H%M%S")
    work = loaded_map
    if config.config_name == "CRCConfig":
        work = np.flipud(work).copy()

    recon, mask = edit_fn(work[None].astype(np.int32))
    recon, mask = recon[0], mask[0]
    id_out = np.where(mask > 0, work, 0).astype(np.int32)

    if config.config_name == "CRCConfig":
        recon = np.flipud(recon).copy()
        id_out = np.flipud(id_out).copy()

    base = os.path.basename(str(config.edited_file_path)).split(".")[0]
    os.makedirs(save_dir, exist_ok=True)
    save_image(recon, "gray", -1, 1,
               os.path.join(save_dir, f"recon_{base}_{timestamp}_img.png"))
    save_image(id_out, CMAP, 0, config.dict_size,
               os.path.join(save_dir, f"label_{base}_{timestamp}_lbl.png"))
    return recon, id_out

