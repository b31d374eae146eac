"""medical_image_editing_tpu_torch — the PyTorch/CUDA port of
`medical_image_editing_tpu`, for NVIDIA Hopper (H100, `sm_90a`).

The JAX package beside it is the reference; every module here mirrors its
counterpart at the same relative path and is held against it by the tests
under `tests/test_torch_port_*.py`. This package imports `torch` and never
`jax`, nor anything of the JAX package.

Covered so far: the editing service's inference path — image → encoder →
VQ label map (through the hand-written CUDA VQ kernel, `csrc/vq_fused.cu`)
→ painted map → SPADE decoder → image; and the first-stage training step
(k-means codebook init, two augmented views, VQ EMA, embedding / recon /
focal-frequency losses, Adam), whose packed 3×3 convolutions run the
hand-written CUDA kernel `csrc/conv3x3_packed.cu` under
`MEDIMG_CONV_IMPL=packed`.

Subpackages:
  ops       windowing, VQ (plain + fused CUDA kernel), the 3×3 conv (plain +
            CUDA kernel), warps, augmentation, losses, k-means, one-hot, the
            CUDA build
  models    UNetEncoder / UNetDecoder and their blocks (NCHW nn.Modules)
  train     the eval forward, the first-stage step, the train state
  utils     weight bridge from the JAX package's variable trees, NIfTI I/O,
            device resolution, JSON configs and .env loading, PNG export
  cli       edit_batch / run_recon entry points

Every entry point takes `device=`, defaulting to "cuda": a caller asks for
the CPU explicitly, as the tests do.
"""

__version__ = "0.1.0"
