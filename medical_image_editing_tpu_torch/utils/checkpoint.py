"""Checkpoints of the train state with `torch.save`, with the JAX package's
save, retention and staged-restore rules.

Counterpart of `medical_image_editing_tpu/utils/checkpoint.py` (Orbax there;
reference `src/utils/logger.py:79-91`, `src/trainers/base.py:85-114`,
`run_vqwnet.py:90-100`):
  * the whole train state — both modules with the VQ buffers (`embed`,
    `cluster_size`, `embed_avg`: without them the codebook is lost), both
    Adam states, the generator, step and epoch, and in the second stage
    and the multi-window joint step the discriminator (with its spectral-norm vectors) and its Adam under
    `discriminator` and `dis_opt` (`TrainState.state_dict`) — is one
    `state.pt` in a directory `ckpt-epoch=EEEE` (epoch end) or
    `ckpt-epoch=EEEE-step=SSSSSSSS` (mid-epoch);
  * retention: the newest `limit_num` epoch checkpoints stay; older ones
    only every `save_interval` epochs ((epoch + 1) % interval == 0); a
    step-tagged checkpoint stays only while it is the newest overall;
  * `restore` loads the newest (or a given epoch's newest) into a state;
    `restore_fields` copies only the named top-level fields of the state
    dict (("encoder", "decoder") for a staged first stage,
    ("discriminator",) for `run.discriminator_ckpt_path`).

A checkpoint is written under a temporary name in the same directory and
moved into place with `os.replace`, so no partial checkpoint is ever
visible. Under a process group the state is replicated: rank 0 alone makes
the directory, writes and prunes, and every rank waits at a barrier after
each save; a resume reads the checkpoint on every rank. Saves are synchronous (the JAX package's `use_async` overlaps
Orbax writes with compute; here a save is one `torch.save`).

The JAX package's Orbax checkpoint directories cannot be read here (no orbax
on the card's machine): restoring one raises an error that points at the
crossing, the JAX package's `export-ckpt` to a Lightning `.ckpt` and then
the port's `cli/import_ckpt.py`, or the `.ckpt` itself, which the trainer
and the serving CLIs load. `load_fields` reads named fields of a checkpoint
(the serving CLIs' encoder and decoder).
"""

import os
import re
import shutil
from typing import Optional, Sequence, Tuple

import torch

from ..parallel.mesh import barrier, world

_CKPT_RE = re.compile(r"ckpt-epoch=(\d+)(?:-step=(\d+))?")
STATE_FILE = "state.pt"


def _ckpt_name(epoch: int, step: Optional[int] = None) -> str:
    if step is None:
        return f"ckpt-epoch={epoch:04d}"
    return f"ckpt-epoch={epoch:04d}-step={step:08d}"


def _sort_key(entry: Tuple[int, Optional[int]]):
    """Order by recency: an epoch-end save of epoch E holds the state after
    all of E's batches, so it outranks any step-tagged (E, s)."""
    epoch, step = entry
    return (epoch, float("inf") if step is None else step)


def load_state_file(path: str, map_location="cpu") -> dict:
    """The state dict saved in checkpoint directory `path`."""
    f = os.path.join(path, STATE_FILE)
    if not os.path.isfile(f):
        raise ValueError(
            f"{path} holds no {STATE_FILE}: not a checkpoint of the PyTorch port "
            "(an Orbax checkpoint of the JAX package cannot be read here). Convert "
            "it to a Lightning .ckpt with the JAX package's export-ckpt CLI "
            "(cli/export_ckpt.py), then to a port checkpoint with "
            "medical_image_editing_tpu_torch/cli/import_ckpt.py, or point the "
            "config at the .ckpt itself (utils/weights.py::load_lightning_state)"
        )
    return torch.load(f, map_location=map_location, weights_only=True)


def save_state_dir(path: str, state_dict: dict) -> str:
    """Write `state_dict` as `path/state.pt`, atomically: into a temporary
    directory beside `path`, moved into place with `os.replace` (a re-save
    of the same path swaps the old directory out, then drops it). Returns
    `path`."""
    parent, name = os.path.split(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    path = os.path.join(parent, name)
    tmp = os.path.join(parent, f".tmp-{os.getpid()}-{name}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state_dict, os.path.join(tmp, STATE_FILE))
    if os.path.isdir(path):
        old = tmp + ".old"
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)
    return path


class CheckpointManager:
    """Epoch checkpoints with the ModelSaver retention policy."""

    def __init__(self, directory: str, limit_num: int = 10, save_interval: int = 10):
        self.directory = os.path.abspath(directory)
        self.limit_num = limit_num
        self.save_interval = save_interval
        if world()[0] == 0:
            os.makedirs(self.directory, exist_ok=True)

    # -- save / prune ---------------------------------------------------------
    def save(self, state, epoch: int, step: Optional[int] = None) -> str:
        """Save `state` (anything with `state_dict()`). `step` marks a
        mid-epoch save; epoch-end saves omit it. Returns the path. Under a
        process group rank 0 writes and prunes, and every rank returns after
        the barrier that follows."""
        path = os.path.join(self.directory, _ckpt_name(epoch, step))
        if world()[0] == 0:
            save_state_dir(path, state.state_dict())
            self._prune()
        barrier()
        return path

    def _entries(self) -> Sequence[Tuple[int, Optional[int]]]:
        out = []
        for bn in os.listdir(self.directory):
            m = _CKPT_RE.fullmatch(bn)
            if m:
                out.append((int(m.group(1)), int(m.group(2)) if m.group(2) else None))
        return sorted(out, key=_sort_key)

    def _epochs(self) -> Sequence[int]:
        return sorted({e for e, s in self._entries() if s is None})

    def _prune(self):
        entries = self._entries()
        keep_tagged = {entries[-1]} if entries and entries[-1][1] is not None else set()
        for e, s in entries:
            if s is not None and (e, s) not in keep_tagged:
                shutil.rmtree(os.path.join(self.directory, _ckpt_name(e, s)))

        epochs = self._epochs()
        if len(epochs) <= self.limit_num:
            return
        for e in epochs[: len(epochs) - self.limit_num]:
            if (e + 1) % self.save_interval != 0:
                shutil.rmtree(os.path.join(self.directory, _ckpt_name(e)))

    # -- restore --------------------------------------------------------------
    def latest_epoch(self) -> Optional[int]:
        """Epoch index of the most recent checkpoint (epoch-end or tagged)."""
        entries = self._entries()
        return entries[-1][0] if entries else None

    def latest_path(self) -> Optional[str]:
        entries = self._entries()
        if not entries:
            return None
        return os.path.join(self.directory, _ckpt_name(*entries[-1]))

    def _path(self, epoch: Optional[int]) -> str:
        entries = self._entries()
        if epoch is not None:
            entries = [x for x in entries if x[0] == epoch]
        if not entries:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return os.path.join(self.directory, _ckpt_name(*entries[-1]))

    def restore(self, target, epoch: Optional[int] = None):
        """Full restore (resume) into `target` (a `TrainState`), on its
        device: that epoch's newest save, else the newest overall (which may
        be mid-epoch: the trainer replays the unseen tail from `step`)."""
        target.load_state_dict(load_state_file(self._path(epoch), target.device))
        return target


def resolve(ckpt_dir_or_path: str, epoch: Optional[int] = None) -> str:
    """A checkpoint directory `ckpt-epoch=...` (or any directory holding
    `state.pt`) as given, or the newest (or epoch's newest) under a parent
    directory. A directory with neither comes back as given, so that
    `load_state_file` says what it is not."""
    path = ckpt_dir_or_path
    if (_CKPT_RE.fullmatch(os.path.basename(os.path.normpath(path)))
            or os.path.isfile(os.path.join(path, STATE_FILE))):
        return path
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint directory does not exist: {path}")
    manager = CheckpointManager(path)
    if not manager._entries():
        return path
    return manager._path(epoch)


def restore_state(ckpt_dir_or_path: str, target_state, epoch: Optional[int] = None):
    """Full restore from a checkpoint parent directory or a specific
    `ckpt-epoch=NNNN[-step=M]` directory."""
    path = resolve(ckpt_dir_or_path, epoch)
    target_state.load_state_dict(load_state_file(path, target_state.device))
    return target_state


def load_fields(ckpt_dir_or_path: str, fields: Sequence[str], epoch: Optional[int] = None,
                map_location="cpu") -> dict:
    """The named top-level fields of the state dict saved in a checkpoint
    parent directory (its newest, or `epoch`'s newest) or a
    `ckpt-epoch=...` directory; `KeyError` if one is missing."""
    saved = load_state_file(resolve(ckpt_dir_or_path, epoch), map_location)
    missing = [f for f in fields if f not in saved]
    if missing:
        raise KeyError(f"checkpoint has no fields {missing}; it has {sorted(saved)}")
    return {f: saved[f] for f in fields}


def restore_fields(ckpt_dir_or_path: str, target_state, fields: Sequence[str],
                   epoch: Optional[int] = None):
    """Prefix-selective restore: copy only the named top-level fields of the
    saved state dict (e.g. ("encoder", "decoder") — the models with the
    codebook — for a first-stage init) into `target_state`; the rest keeps
    its values."""
    merged = target_state.state_dict()
    merged.update(load_fields(ckpt_dir_or_path, fields, epoch, target_state.device))
    target_state.load_state_dict(merged)
    return target_state
