"""Eval forward, validation grids, test metrics (→ result.csv) and the
label-map export.

Counterpart of `medical_image_editing_tpu/train/evaluate.py` (reference
`src/trainers/single_window_trainer.py:541-848`):
  make_eval_forward    image → (recon, label map): the encode entry point
                       of the editing service; its ids are the
                       `label_*.nii.gz` maps a clinician paints. With the
                       encoder's `knn_backend` "pallas"/"faiss" and CUDA
                       tensors the VQ assignment runs the fused CUDA kernel.
  make_vqgan_eval_forward
                       the same through the whole VQGAN, its ids raw
                       (0-based) at the bottleneck resolution.
  test_step            NMSE/SSIM/PSNR + base-2 label entropy per batch
                       (pulled to the host in one copy), and the first
                       slice's PNGs + fused overlay (CRC flipped back).
  test_epoch_end       avg/std per metric → `result.csv`, written as pandas'
                       `to_csv` writes it (index column, `*_avg`/`*_std`),
                       with the `csv` module: the card's machine has no
                       pandas.
  inference_export     per-slice PNG + gzip NIfTI of image/recon/label keyed
                       by patient_id/slice_num (lung window for
                       NCCLungDataset, vertical flip for CRCDataset), ids as
                       int32.
  multi_window_test_export
                       the multi-window trainer's test: per-slice gzip
                       NIfTI of image and recon denormalized to HU and the
                       label map (int32) under save_root/patient_id/.
  validation_snapshot  the validation recon grid (`utils/imaging.py`: the
                       same panels in the same cells, titles dropped), with
                       the discriminator's maps on real and reconstruction
                       in the second stage.

The forwards here own their models (the JAX versions take the state as an
argument); exports run on the host, process 0 only.
"""

import csv
import os
from typing import Optional

import numpy as np
import torch

from ..ops.metrics import label_entropy, nmse, psnr, ssim
from ..utils.device import resolve_device
from ..utils.imaging import (
    CMAP,
    as_numpy,
    compose_grid,
    encode_png,
    save_fused_image,
    save_image,
)
from ..utils.logging import is_main_process
from ..utils.nifti import save as nifti_save
from ..utils.nifti import to_nifti_array


def make_eval_forward(encoder, decoder, *, device="cuda"):
    """Moves both models to `device` and returns forward(image (B,H,W,1))
    → (recon (B,H,W,1) f32, ids+1 (B,H,W) int32), run in eval mode (set on
    each call: a training step between two calls puts the models back in
    train mode)."""
    dev = resolve_device(device)
    encoder.to(dev)
    decoder.to(dev)

    @torch.inference_mode()
    def forward(image):
        encoder.eval()
        decoder.eval()
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        q, _, ids, _ = encoder.encode(image, train=False)
        recon = decoder(q.permute(0, 3, 1, 2))
        return recon.permute(0, 2, 3, 1).float(), ids

    return forward


def make_vqgan_eval_forward(vqgan, *, device="cuda"):
    """Moves the VQGAN to `device` and returns forward(image (B,H,W,1)) →
    (recon (B,H,W,1) f32, ids (B,h,w) int32, raw and 0-based at the
    bottleneck), through the whole autoencoder in eval mode (the codebook
    does not move)."""
    dev = resolve_device(device)
    vqgan.to(dev)

    @torch.inference_mode()
    def forward(image):
        vqgan.eval()
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        recon, _, ids, _ = vqgan(image.permute(0, 3, 1, 2), train=False)
        return recon.permute(0, 2, 3, 1).float(), ids

    return forward


def forward_metrics_fn(forward, dict_size: int, id_offset: int = 0):
    """fn(image) → (metrics {NMSE, SSIM, PSNR, Entropy} as 0-d tensors,
    recon, ids) from an eval forward; the entropy is of ids + `id_offset`
    (1 for the VQGAN's raw ids, as the JAX trainer counts them)."""

    def fn(image):
        recon, ids = forward(image)
        image = torch.as_tensor(image).to(recon)
        metrics = {"NMSE": nmse(recon, image), "SSIM": ssim(recon, image),
                   "PSNR": psnr(recon, image),
                   "Entropy": label_entropy(ids + id_offset, dict_size)}
        return metrics, recon, ids

    return fn


def make_test_metrics_fn(encoder, decoder, dict_size: int, *, device="cuda"):
    """`forward_metrics_fn` of the encoder and decoder's eval forward."""
    return forward_metrics_fn(make_eval_forward(encoder, decoder, device=device), dict_size)


def host_metrics(metrics) -> dict:
    """{name: 0-d tensor} → {name: float}, keys sorted, as they leave the
    JAX package's jitted metrics; one device → host copy."""
    keys = sorted(metrics)
    return dict(zip(keys, torch.stack([metrics[k] for k in keys]).tolist()))


def test_step(forward_metrics, batch, batch_idx: int, *, dataset_name: str,
              dict_size: int, save_dir_path: Optional[str] = None):
    """One test batch → {metric: float} (+ the first slice's PNG exports
    under save_dir_path; CRC flipped back)."""
    if not is_main_process():
        return None
    metrics, recon, ids = forward_metrics(batch["image"])
    # the JAX package's result.csv columns are Entropy, NMSE, PSNR, SSIM
    out = host_metrics(metrics)

    if save_dir_path is not None:
        os.makedirs(save_dir_path, exist_ok=True)
        s = str(batch_idx).zfill(4)
        flip = np.flipud if dataset_name == "CRCDataset" else (lambda a: a)
        img = flip(as_numpy(batch["image"])[0, ..., 0])
        rec = flip(as_numpy(recon)[0, ..., 0])
        idm = flip(as_numpy(ids)[0])
        save_image(img, "gray", -1, 1, os.path.join(save_dir_path, f"image_{s}.png"))
        save_image(rec, "gray", -1, 1, os.path.join(save_dir_path, f"recon_{s}.png"))
        save_image(idm, CMAP, 0, dict_size, os.path.join(save_dir_path, f"idx_{s}.png"))
        save_fused_image(rec, "gray", -1, 1, idm, CMAP, 0, dict_size, 0.3,
                         os.path.join(save_dir_path, f"fused_{s}.png"))
    return out


def test_epoch_end(outputs, save_dir_path: str):
    """avg/std (population) per metric → `result.csv`; returns its path."""
    if not is_main_process() or not outputs:
        return None
    header, row = [""], ["0"]
    for key in outputs[0]:
        values = [o[key] for o in outputs]
        header += [f"{key}_avg", f"{key}_std"]
        row += [repr(float(np.mean(values))), repr(float(np.std(values)))]
    os.makedirs(save_dir_path, exist_ok=True)
    path = os.path.join(save_dir_path, "result.csv")
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerow(row)
    return path


def inference_export(forward, batch, *, dataset_name: str, dict_size: int, save_root: str,
                     study_name: str = "", to_lung_fn=None):
    """Per-slice PNG + NIfTI export of image, recon and label map under
    save_root/study_name/patient_id/; returns the directories written (one
    per slice)."""
    if not is_main_process():
        return []
    recon, ids = forward(batch["image"])
    image = torch.as_tensor(batch["image"]).to(recon)
    if dataset_name == "NCCLungDataset" and to_lung_fn is not None:
        image, recon = to_lung_fn(image), to_lung_fn(recon)
    image, recon = as_numpy(image), as_numpy(recon)
    ids = as_numpy(ids).astype(np.int32)

    written = []
    for i in range(image.shape[0]):
        img, rec, idm = image[i, ..., 0], recon[i, ..., 0], ids[i]
        if dataset_name == "CRCDataset":
            img, rec, idm = np.flipud(img), np.flipud(rec), np.flipud(idm)
        out_dir = os.path.join(save_root, study_name, batch["patient_id"][i])
        os.makedirs(out_dir, exist_ok=True)
        s = str(int(batch["slice_num"][i])).zfill(4)
        save_image(img, "gray", -1, 1, os.path.join(out_dir, f"image_{s}.png"))
        save_image(rec, "gray", -1, 1, os.path.join(out_dir, f"recon_{s}.png"))
        save_image(idm, CMAP, 0, dict_size, os.path.join(out_dir, f"label_{s}.png"))
        nifti_save(to_nifti_array(img), os.path.join(out_dir, f"image_{s}.nii.gz"))
        nifti_save(to_nifti_array(rec), os.path.join(out_dir, f"recon_{s}.nii.gz"))
        nifti_save(to_nifti_array(idm), os.path.join(out_dir, f"label_{s}.nii.gz"),
                   dtype=np.int32)
        written.append(out_dir)
    return written


def multi_window_test_export(forward, batch, *, save_root: str, denormalize_fn):
    """HU-denormalized per-slice NIfTI export (reference
    `multi_window_trainer.py:796-836`): `image_SSSS`, `recon_SSSS` (through
    `denormalize_fn`) and `label_SSSS` under save_root/patient_id/; returns
    the directories written (one per slice)."""
    if not is_main_process():
        return []
    recon, ids = forward(batch["image"])
    image = as_numpy(denormalize_fn(torch.as_tensor(batch["image"]).to(recon)))
    recon = as_numpy(denormalize_fn(recon))
    ids = as_numpy(ids).astype(np.int32)
    written = []
    for i in range(image.shape[0]):
        out_dir = os.path.join(save_root, batch["patient_id"][i])
        os.makedirs(out_dir, exist_ok=True)
        s = str(int(batch["slice_num"][i])).zfill(4)
        nifti_save(to_nifti_array(image[i, ..., 0]), os.path.join(out_dir, f"image_{s}.nii.gz"))
        nifti_save(to_nifti_array(recon[i, ..., 0]), os.path.join(out_dir, f"recon_{s}.nii.gz"))
        nifti_save(to_nifti_array(ids[i]), os.path.join(out_dir, f"label_{s}.nii.gz"),
                   dtype=np.int32)
        written.append(out_dir)
    return written


def validation_snapshot(forward, batch, *, dataset_name: str, dict_size: int,
                        n_save_images: int, save_path: str, dis_maps=None,
                        to_lung_fn=None, to_mediastinal_fn=None, forward_outputs=None):
    """The validation recon grid: n_rows = min(n_save_images, batch) rows of
    7 cells. Raw panels [image, recon, ids, r_map, f_map] for CRC or without
    the HU converters; else [lung image, lung recon, mediastinal image,
    mediastinal recon, ids, r_map, f_map]. `dis_maps` is the
    discriminator's (r_map, f_map) on image and reconstruction, (B,H,W,1)
    each (second-stage validation); without it both panels are zeros.
    `forward_outputs` is (recon, ids) when the caller already ran
    `forward` on the batch."""
    if not is_main_process():
        return None
    recon, ids = forward_outputs if forward_outputs is not None else forward(batch["image"])
    image = torch.as_tensor(batch["image"]).to(recon)
    if dis_maps is None:
        r_map = f_map = np.zeros(tuple(image.shape), np.float32)
    else:
        r_map, f_map = (as_numpy(m) for m in dis_maps)
    ids_h = as_numpy(ids)
    n_rows, n_cols = min(n_save_images, image.shape[0]), 7
    if dataset_name == "CRCDataset" or to_lung_fn is None or to_mediastinal_fn is None:
        views = [(as_numpy(image), "gray", -1, 1), (as_numpy(recon), "gray", -1, 1)]
    else:
        views = [(as_numpy(to_lung_fn(image)), "gray", -1, 1),
                 (as_numpy(to_lung_fn(recon)), "gray", -1, 1),
                 (as_numpy(to_mediastinal_fn(image)), "gray", -1, 1),
                 (as_numpy(to_mediastinal_fn(recon)), "gray", -1, 1)]
    panels = []
    for i in range(n_rows):
        row = [(a[i, ..., 0], cmap, lo, hi) for a, cmap, lo, hi in views]
        row += [(ids_h[i], CMAP, 0, dict_size), (r_map[i, ..., 0], "gray", None, None),
                (f_map[i, ..., 0], "gray", None, None)]
        panels += [(*p, n_cols * i + j + 1) for j, p in enumerate(row)]
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    with open(save_path, "wb") as f:
        f.write(encode_png(compose_grid(panels, n_rows, n_cols)))
    return save_path
