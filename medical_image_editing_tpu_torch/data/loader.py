"""Host batch loader with background producers and device prefetch.

Counterpart of `medical_image_editing_tpu/data/loader.py` (reference
`src/dataio/data_loader.py`): the same mode × dataset factory
(`get_data_loader`), host transforms (RandomAffine ±5°, translate 0.01,
scale 0.9-1.1 and HFlip for train when configured; NormalizeIntensity for
BraTS/CRC), the same shuffles, and the same batches:
  * the batch order is a pure function of (seed, epoch) — one
    `default_rng(seed + epoch)` permutation — so a resumed run replays an
    uninterrupted run's order (`epoch_iterator(epoch, skip_batches)`);
  * a batch's transform draws come from `SeedSequence([seed, epoch, batch
    index])`, so workers may build batches in any order;
  * `num_workers` 0 builds batches on the caller's thread, 1 on one
    background producer, N on a pool of N threads, yielded in order;
  * fixed-size `.npy` slices without a host transform (or with one that is
    an elementwise epilogue: the lung HU window, CRC/BraTS intensity) load
    through the native C++ reader (`data/native_loader.py`) with the
    epilogue fused. Where that library cannot be built or loaded, the
    loader reads with numpy — the same numbers — and says so: `native` is
    False and a warning is issued once.
Producer threads run numpy and native IO only; `prefetch_to_device` makes
the CUDA calls on the caller's (training) thread: each batch's image is
copied into its own pinned host buffer and sent with a `non_blocking` copy,
`size` batches ahead. A `torch.distributed` run takes a strided shard of
the permutation per process (DistributedSampler semantics); with
`drop_last` (the train loader) the permutation is first cut to a multiple
of the world size, as `DistributedSampler(drop_last=True)` cuts it, so that
every rank gets as many full batches as every other and no rank waits in a
collective for a batch that another rank never gets (fault C.5: 9 slices,
2 ranks, batch 5 gave rank 0 one batch and rank 1 none).
"""

import collections
import queue
import threading
import warnings
from typing import Iterator, Optional

import numpy as np
import torch

from . import native_loader
from .datasets import CRCDataset, MICCAIBraTSDataset, NCCLungDataset, SyntheticSliceDataset

AHEAD = 2  # batches the producers build ahead of the consumer

# ---------------------------------------------------------------------------
# host-side per-sample transforms
# ---------------------------------------------------------------------------


def normalize_intensity_np(image, vmin=0.0, vmax=255.0):
    """clamp → [-1,1]."""
    image = np.clip(image, vmin, vmax)
    image = (image - vmin) / (vmax - vmin)
    return image * 2.0 - 1.0


def random_affine_np(rng, image, p=0.5, degrees=(-5, 5), translate=(0.01, 0.01),
                     scale=(0.9, 1.1)):
    """Host-side RandomAffine (bilinear, zero fill)."""
    from scipy import ndimage

    if rng.random() >= p:
        return image
    h, w = image.shape[:2]
    angle = np.deg2rad(rng.uniform(*degrees))
    s = rng.uniform(*scale)
    tx = rng.uniform(-translate[0], translate[0]) * w
    ty = rng.uniform(-translate[1], translate[1]) * h
    cos, sin = np.cos(angle) * s, np.sin(angle) * s
    lin = np.array([[cos, -sin], [sin, cos]], np.float64)
    center = np.array([(h - 1) / 2.0, (w - 1) / 2.0])
    offset = center + np.array([ty, tx]) - lin @ center
    inv = np.linalg.inv(lin)  # scipy maps output coordinates to input ones
    return ndimage.affine_transform(image, inv, offset=-inv @ offset, order=1,
                                    mode="constant", cval=0.0)


def random_hflip_np(rng, image, p=0.5):
    if rng.random() < p:
        return image[:, ::-1].copy()
    return image


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------


def _collate(samples):
    images = np.stack([s["image"] for s in samples]).astype(np.float32)
    if images.ndim == 3:
        images = images[..., None]  # (B,H,W,1) NHWC
    return {
        "image": images,
        "patient_id": [s["patient_id"] for s in samples],
        "slice_num": np.asarray([s["slice_num"] for s in samples], np.int32),
    }


def _process_shard():
    """(world size, rank) of an initialised process group, else (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DataLoader:
    """Epoch iterator: shuffle, batch, collate, optional background
    producers (the `num_workers` seam), native `.npy` reads."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        transform=None,
        num_workers: int = 0,
        seed: int = 0,
        native_epilogue=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.transform = transform
        self.num_workers = num_workers
        self._epoch = 0
        self._seed = seed
        self._process_shard = _process_shard()
        self._native_window = getattr(dataset, "window", None)
        self._native_epilogue = native_epilogue
        if self._native_window and native_epilogue:
            raise ValueError("dataset-level windowing and a transform epilogue cannot "
                             "both apply natively")
        files = getattr(dataset, "files", None)
        # the native reader serves fixed-size .npy files whose transform is
        # absent or an elementwise epilogue fused into the read
        eligible = bool(
            (transform is None or native_epilogue is not None)
            and files and all(f.get("image_path") for f in files[: min(len(files), 4)])
        )
        self.native = eligible and native_loader.is_available()
        if eligible and not self.native:
            self._fall_back(native_loader.unavailable_reason())

    def _fall_back(self, reason):
        self.native = False
        warnings.warn(f"native .npy loader unavailable ({reason}); loading with numpy "
                      "(the same numbers, slower)", RuntimeWarning, stacklevel=3)

    def __len__(self):
        """Batches per epoch for this process (its strided shard)."""
        n = len(self.dataset)
        pcount, pidx = self._process_shard
        if pcount > 1:
            n = n // pcount if self.drop_last else len(range(pidx, n, pcount))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        """Pin the next iteration's permutation to `epoch`."""
        self._epoch = int(epoch)

    def epoch_iterator(self, epoch: int, skip_batches: int = 0) -> Iterator[dict]:
        """Iterate epoch `epoch`, skipping its first `skip_batches` batches
        without loading them (mid-epoch resume)."""
        self.set_epoch(epoch)
        return self._iterate(skip_batches=skip_batches)

    def _batch_specs(self, skip_batches: int = 0):
        """(epoch, [(batch index, sample indices)]) of the current epoch;
        advances the epoch counter, as starting an iteration does."""
        n = len(self.dataset)
        epoch = self._epoch
        rng = np.random.default_rng(self._seed + epoch)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        pcount, pidx = self._process_shard
        if pcount > 1:
            if self.drop_last:
                order = order[: n - n % pcount]
            order = order[pidx::pcount]
            n = len(order)
        self._epoch += 1
        specs = []
        for bi, start in enumerate(range(0, n, self.batch_size)):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            if bi >= skip_batches:
                specs.append((bi, idx))
        return epoch, specs

    def _load_batch(self, epoch: int, bi: int, idx) -> dict:
        """One batch, a pure function of (epoch, bi, idx)."""
        if self.native:
            batch = self._native_batch(idx)
            if batch is not None:
                return batch
        sample_rng = np.random.default_rng(
            np.random.SeedSequence([self._seed & 0xFFFFFFFF, epoch, bi]))
        samples = []
        for i in idx:
            s = self.dataset[int(i)]
            if self.transform is not None:
                s = dict(s)
                s["image"] = self.transform(sample_rng, s["image"])
            samples.append(s)
        return _collate(samples)

    def _native_batch(self, idx):
        """The C++ batch read; None (numpy from then on) when the files are
        not 2-D slices or the read fails."""
        files = [self.dataset.files[int(i)] for i in idx]
        paths = [f["image_path"] for f in files]
        probe = np.load(paths[0], mmap_mode="r")
        if probe.ndim != 2:
            self.native = False
            return None
        try:
            images = native_loader.load_npy_batch(
                paths, *probe.shape, window=self._native_window,
                epilogue=self._native_epilogue)
        except (OSError, RuntimeError) as e:
            self._fall_back(f"{type(e).__name__}: {e}")
            return None
        return {
            "image": images[..., None],
            "patient_id": [f["patient_id"] for f in files],
            "slice_num": np.asarray([f["slice_num"] for f in files], np.int32),
        }

    def _batches(self, skip_batches: int = 0) -> Iterator[dict]:
        epoch, specs = self._batch_specs(skip_batches)
        for bi, idx in specs:
            yield self._load_batch(epoch, bi, idx)

    def __iter__(self) -> Iterator[dict]:
        return self._iterate(skip_batches=0)

    def _iterate(self, skip_batches: int = 0) -> Iterator[dict]:
        """0 workers: synchronous; 1 (or the native path, already a C++
        thread pool per batch): one background producer; N: a pool of N
        threads building whole batches, yielded in order."""
        if self.num_workers <= 0:
            yield from self._batches(skip_batches=skip_batches)
            return
        if self.num_workers == 1 or self.native:
            yield from self._background_single(skip_batches)
            return
        from concurrent.futures import ThreadPoolExecutor

        epoch, specs = self._batch_specs(skip_batches)
        window = self.num_workers + AHEAD
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        pending = {}
        try:
            submit = iter(specs)
            for bi, idx in (next(submit) for _ in range(min(window, len(specs)))):
                pending[bi] = pool.submit(self._load_batch, epoch, bi, idx)
            for bi, _ in specs:
                yield pending.pop(bi).result()
                nxt = next(submit, None)
                if nxt is not None:
                    pending[nxt[0]] = pool.submit(self._load_batch, epoch, *nxt)
        finally:
            # abandoned mid-epoch (a max_steps break): drop queued work and
            # do not wait on batches in flight
            pool.shutdown(wait=False, cancel_futures=True)

    def _background_single(self, skip_batches: int) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=AHEAD)
        done = object()
        stop = threading.Event()
        gen = self._batches(skip_batches=skip_batches)

        def produce():
            try:
                for b in gen:
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # handed to the consumer, raised there
                q.put(e)
                return
            q.put(done)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is done:
                    break
                if isinstance(b, BaseException):
                    raise b
                yield b
        finally:
            stop.set()


def prefetch_to_device(iterator, size: int = 2, device="cuda"):
    """Keep `size` batches in flight to `device`: each batch's "image"
    becomes a tensor on it. On a CUDA device the image is copied into a
    pinned host buffer of its own (a buffer is never refilled while its
    copy may be running) and sent with `non_blocking=True`, so the copy of
    the next batches overlaps the current step; call from the thread that
    runs the steps."""
    dev = torch.device(device)
    buf = collections.deque()

    def put(batch):
        image = torch.from_numpy(np.ascontiguousarray(batch["image"]))
        if dev.type == "cuda":
            image = image.pin_memory().to(dev, non_blocking=True)
        else:
            image = image.to(dev)
        buf.append({**batch, "image": image})

    it = iter(iterator)
    for batch in it:
        put(batch)
        if len(buf) >= size:
            break
    while buf:
        out = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            put(nxt)
        yield out


def get_data_loader(
    mode: str,
    dataset_name: str,
    root_dir_path: str,
    batch_size: int,
    num_workers: int = 0,
    modality: Optional[str] = None,
    augmentations: Optional[list] = None,
    drop_last: bool = False,
    window_width: Optional[float] = None,
    window_center: Optional[float] = None,
    window_scale: Optional[float] = None,
    seed: int = 0,
) -> DataLoader:
    """The reference's mode × dataset behaviour: train applies the optional
    host augmentations and the intensity normalization (BraTS/CRC) and
    shuffles; val normalizes and shuffles; test normalizes, no shuffle.
    Train drops the ragged tail batch (the reference keeps it)."""
    if mode not in {"train", "val", "test"}:
        raise ValueError(f"mode {mode!r}: 'train', 'val' or 'test'")
    known = {"MICCAIBraTSDataset", "NCCLungDataset", "CRCDataset", "SyntheticSliceDataset"}
    if dataset_name not in known:
        raise ValueError(f"dataset_name {dataset_name!r}: one of {sorted(known)}")
    augmentations = augmentations or []
    if mode != "train" and augmentations:
        raise ValueError("augmentations are train-only")

    needs_intensity_norm = dataset_name in {"MICCAIBraTSDataset", "CRCDataset"}
    steps = []
    if mode == "train":
        if "RandomAffineTransform" in augmentations:
            steps.append(lambda rng, im: random_affine_np(rng, im))
        if "RandomHorizontalFlipTransform" in augmentations:
            steps.append(lambda rng, im: random_hflip_np(rng, im))
    if needs_intensity_norm:
        steps.append(lambda rng, im: normalize_intensity_np(im))

    def transform(rng, image):
        for f in steps:
            image = f(rng, image)
        return image.astype(np.float32)

    # NormalizeIntensity as the only transform is elementwise: the native
    # reader fuses it; `transform` stays as the numpy path
    native_epilogue = None
    if needs_intensity_norm and len(steps) == 1:
        native_epilogue = (native_loader.EP_INTENSITY, 0.0, 255.0)

    if dataset_name == "MICCAIBraTSDataset":
        dataset = MICCAIBraTSDataset(root_dir_path, modality=modality)
    elif dataset_name == "NCCLungDataset":
        dataset = NCCLungDataset(root_dir_path, window_width=window_width,
                                 window_center=window_center, window_scale=window_scale,
                                 seed=seed)
    elif dataset_name == "CRCDataset":
        dataset = CRCDataset(root_dir_path, seed=seed)
    else:
        dataset = SyntheticSliceDataset(seed=seed)

    return DataLoader(dataset, batch_size=batch_size, shuffle=mode in {"train", "val"},
                      drop_last=drop_last, transform=transform if steps else None,
                      num_workers=num_workers, seed=seed, native_epilogue=native_epilogue)
