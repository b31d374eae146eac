#!/usr/bin/env python3
"""Cross volumetric VQ-WNet checkpoints between the JAX package and the port.

The JAX package's `train_volumetric` saves an Orbax directory
(`volumetric_ckpt/`, {"enc", "dec", "vq"}: the flax variables and the
codebook, `cli/train_volumetric.py`); the port's saves
`volumetric_ckpt/state.pt` ({"enc", "dec", "vq"}: the modules' state dicts
and the codebook with `embed_avg` as (C, K)). The port reads neither JAX nor
Orbax, so the crossing lives here, outside both packages:

  to-port  restore the Orbax directory with Orbax's StandardCheckpointer
           (as the JAX package's `cli/edit_volume.py` restores it) and
           write the port's directory (`utils/weights.py::
           from_jax_volumetric`, `utils/checkpoint.py::save_state_dir`);
  to-jax   read the port's directory and write an Orbax directory that the
           JAX package's `load_volumetric_checkpoint` restores
           (`utils/weights.py::to_jax_volumetric`).

Both directions move float32 arrays without arithmetic: a round trip gives
the same bits.

    python tools/volumetric_ckpt.py to-port --src out/volumetric_ckpt --out port/volumetric_ckpt
    python tools/volumetric_ckpt.py to-jax --src port/volumetric_ckpt --out jax/volumetric_ckpt

Needs orbax (and JAX under it) beside torch: run it where the JAX package
runs.
"""

import argparse
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def to_port(src: str, out: str) -> str:
    """Orbax directory `src` → the port's checkpoint directory `out`."""
    import orbax.checkpoint as ocp

    from medical_image_editing_tpu_torch.utils.checkpoint import save_state_dir
    from medical_image_editing_tpu_torch.utils.weights import from_jax_volumetric

    restored = ocp.StandardCheckpointer().restore(os.path.abspath(src))
    tree = {part: _numpy(restored[part]) for part in ("enc", "dec", "vq")}
    sds = from_jax_volumetric(tree["enc"], tree["dec"], SimpleNamespace(**tree["vq"]))
    return save_state_dir(out, sds)


def to_jax(src: str, out: str) -> str:
    """The port's checkpoint directory `src` → an Orbax directory `out`."""
    import orbax.checkpoint as ocp

    from medical_image_editing_tpu_torch.utils.checkpoint import load_state_file
    from medical_image_editing_tpu_torch.utils.weights import to_jax_volumetric

    path = os.path.abspath(out)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, to_jax_volumetric(load_state_file(src)), force=True)
    ckptr.wait_until_finished()
    return path


def _numpy(tree):
    """A restored tree's leaves as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("direction", choices=["to-port", "to-jax"])
    parser.add_argument("--src", required=True, help="checkpoint directory to read")
    parser.add_argument("--out", required=True, help="checkpoint directory to write")
    args = parser.parse_args(argv)
    path = (to_port if args.direction == "to-port" else to_jax)(args.src, args.out)
    print(f"{args.direction}: {args.src} -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
