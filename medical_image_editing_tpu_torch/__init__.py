"""medical_image_editing_tpu_torch — the PyTorch/CUDA port of
`medical_image_editing_tpu`, for NVIDIA Hopper (H100, `sm_90a`).

The JAX package beside it is the reference; every module here mirrors its
counterpart at the same relative path and is held against it by the tests
under `tests/test_torch_port_*.py`. This package imports `torch` and never
`jax`, nor anything of the JAX package.

Covered so far: the editing service's inference path — image → encoder →
VQ label map (through the hand-written CUDA VQ kernel, `csrc/vq_fused.cu`)
→ painted map → SPADE decoder → image.

Subpackages:
  ops       windowing, VQ (plain + fused CUDA kernel), the CUDA build
  models    UNetEncoder / UNetDecoder and their blocks (NCHW nn.Modules)
  train     the eval forward (encode entry point)
  utils     weight bridge from the JAX package's variable trees, NIfTI I/O,
            device resolution, .env loading, PNG export
  cli       edit_batch / run_recon entry points

Every entry point takes `device=`, defaulting to "cuda": a caller asks for
the CPU explicitly, as the tests do.
"""

__version__ = "0.1.0"
