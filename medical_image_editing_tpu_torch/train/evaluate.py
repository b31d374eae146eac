"""Eval forward: image → (recon, label map).

Counterpart of `medical_image_editing_tpu/train/evaluate.py::
make_eval_forward`, the encode entry point of the editing service: its ids
are the `label_*.nii.gz` maps a clinician paints. With the encoder's
`knn_backend` "pallas"/"faiss" and CUDA tensors, the VQ assignment runs the
fused CUDA kernel. Validation grids, test metrics and the PNG/NIfTI export
of `inference_export` are not ported yet.
"""

import torch

from ..utils.device import resolve_device


def make_eval_forward(encoder, decoder, *, device="cuda"):
    """Moves both models to `device` in eval mode and returns
    forward(image (B,H,W,1)) → (recon (B,H,W,1) f32, ids+1 (B,H,W) int32)."""
    dev = resolve_device(device)
    encoder.to(dev).eval()
    decoder.to(dev).eval()

    @torch.inference_mode()
    def forward(image):
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        q, _, ids, _ = encoder.encode(image, train=False)
        recon = decoder(q.permute(0, 3, 1, 2))
        return recon.permute(0, 2, 3, 1), ids

    return forward
