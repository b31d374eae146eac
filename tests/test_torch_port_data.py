"""The port's data path against the JAX package's, on fabricated lung and
CRC slice trees (as `tests/test_end_to_end.py` fabricates them), on the CPU.

Held: the same batches from `get_data_loader` — order, `patient_id`,
`slice_num` — with images bit-equal on the numpy path (the transforms
included: host RandomAffine/HFlip draw from the same per-batch seed
sequence); the native C++ reader (built from `native/medimg_io.cpp` into the
port's build directory) against numpy within the tolerance of
`tests/test_native_loader.py` (rtol 1e-5, atol 1e-6); `num_workers` 0/1/3 in
the same order; `epoch_iterator(skip_batches=)`, `drop_last`; the visible
numpy fallback; `prefetch_to_device` on the CPU.
"""

import warnings

import numpy as np
import pytest
import torch

from medical_image_editing_tpu.data import get_data_loader as j_get_data_loader
from medical_image_editing_tpu_torch.data import get_data_loader, native_loader
from medical_image_editing_tpu_torch.data.loader import prefetch_to_device

WINDOW = dict(window_width=4096, window_center=0.0, window_scale=2.0)


def _lung_tree(root, n_patients=3, n_slices=5, size=16, seed=0):
    rng = np.random.default_rng(seed)
    for p in range(n_patients):
        d = root / f"pat{p:02d}"
        d.mkdir(parents=True)
        for s in range(n_slices):
            np.save(d / f"ct_img_{s:04d}.npy",
                    rng.uniform(-2500, 2500, (size, size)).astype(np.float32))
        np.save(d / f"ct_msk_{0:04d}.npy", np.zeros((size, size), np.float32))  # not a slice
    return root


def _crc_tree(root, n_patients=2, n_slices=7, size=16, seed=1):
    rng = np.random.default_rng(seed)
    for p in range(n_patients):
        d = root / f"P{p:03d}_x"
        d.mkdir(parents=True)
        for s in range(n_slices):
            np.save(d / f"{s:04d}.npy", rng.uniform(-20, 280, (size, size)).astype(np.float32))
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    return {"NCCLungDataset": _lung_tree(base / "lung"), "CRCDataset": _crc_tree(base / "crc")}


def _kw(name, mode, augment=False, **extra):
    kw = dict(mode=mode, dataset_name=name, batch_size=4, drop_last=(mode == "train"), seed=3)
    if name == "NCCLungDataset":
        kw.update(WINDOW)
    if augment:
        kw["augmentations"] = ["RandomAffineTransform", "RandomHorizontalFlipTransform"]
    kw.update(extra)
    return kw


def _loaders(trees, name, mode, augment=False, **extra):
    """(JAX loader, port loader), both on the numpy path."""
    kw = _kw(name, mode, augment, **extra)
    j = j_get_data_loader(root_dir_path=str(trees[name]), **kw)
    t = get_data_loader(root_dir_path=str(trees[name]), **kw)
    j._native = False
    t.native = False
    return j, t


def _assert_same(jb, tb, exact=True):
    assert list(jb["patient_id"]) == list(tb["patient_id"])
    np.testing.assert_array_equal(jb["slice_num"], tb["slice_num"])
    assert tb["image"].dtype == np.float32 and tb["image"].shape == jb["image"].shape
    if exact:
        np.testing.assert_array_equal(tb["image"], jb["image"])
    else:
        np.testing.assert_allclose(tb["image"], jb["image"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["NCCLungDataset", "CRCDataset"])
@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_batches_match_jax_bit_for_bit(trees, name, mode):
    j, t = _loaders(trees, name, mode)
    assert len(t) == len(j) and len(t) > 1
    for epoch in (0, 1):
        jbs, tbs = list(j.epoch_iterator(epoch)), list(t.epoch_iterator(epoch))
        assert len(jbs) == len(tbs) == len(j)
        for jb, tb in zip(jbs, tbs):
            _assert_same(jb, tb)


@pytest.mark.parametrize("name", ["NCCLungDataset", "CRCDataset"])
def test_host_augmentations_match_jax_bit_for_bit(trees, name):
    j, t = _loaders(trees, name, "train", augment=True)
    assert t.transform is not None
    for jb, tb in zip(j.epoch_iterator(2), t.epoch_iterator(2)):
        _assert_same(jb, tb)


@pytest.mark.parametrize("name", ["NCCLungDataset", "CRCDataset"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_native_reader_matches_numpy(trees, name, mode):
    kw = _kw(name, mode)
    native = get_data_loader(root_dir_path=str(trees[name]), **kw)
    assert native.native, native_loader.unavailable_reason()
    j, _ = _loaders(trees, name, mode)
    for jb, tb in zip(j.epoch_iterator(1), native.epoch_iterator(1)):
        _assert_same(jb, tb, exact=False)


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("workers", [0, 1, 3])
def test_num_workers_keep_the_order(trees, augment, workers):
    j, t = _loaders(trees, "CRCDataset", "train", augment=augment, num_workers=workers)
    got = list(t.epoch_iterator(1))
    want = list(j.epoch_iterator(1))
    assert len(got) == len(want) == len(t)
    for jb, tb in zip(want, got):
        _assert_same(jb, tb)


@pytest.mark.parametrize("skip", [0, 1, 2, 3])
def test_epoch_iterator_skips_consumed_batches(trees, skip):
    j, t = _loaders(trees, "NCCLungDataset", "train")
    full = list(t.epoch_iterator(4))
    tail = list(t.epoch_iterator(4, skip_batches=skip))
    jtail = list(j.epoch_iterator(4, skip_batches=skip))
    assert len(tail) == len(jtail) == len(full) - skip
    for a, b, c in zip(full[skip:], tail, jtail):
        _assert_same(a, b)
        _assert_same(c, b)


@pytest.mark.parametrize("drop_last", [False, True])
def test_drop_last(trees, drop_last):
    # 15 lung slices at batch 4: 3 whole batches and a tail of 3
    j, t = _loaders(trees, "NCCLungDataset", "val", drop_last=drop_last)
    sizes = [b["image"].shape[0] for b in t]
    assert sizes == ([4, 4, 4] if drop_last else [4, 4, 4, 3])
    assert len(t) == len(j) == len(sizes)
    assert [b["image"].shape[0] for b in j] == sizes


def test_fallback_to_numpy_is_visible(trees, monkeypatch):
    j, _ = _loaders(trees, "NCCLungDataset", "train")
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(native_loader, "unavailable_reason", lambda: "no compiler")
    with pytest.warns(RuntimeWarning, match="no compiler"):
        t = get_data_loader(root_dir_path=str(trees["NCCLungDataset"]),
                            **_kw("NCCLungDataset", "train"))
    assert t.native is False
    for jb, tb in zip(j.epoch_iterator(0), t.epoch_iterator(0)):
        _assert_same(jb, tb)


def test_native_load_npy_batch_windowed(tmp_path):
    """The port's ctypes wrapper: fused HU windowing and the intensity
    epilogue against numpy, and a read error naming the file."""
    from medical_image_editing_tpu_torch.data.loader import normalize_intensity_np
    from medical_image_editing_tpu_torch.ops.windowing import normalize

    rng = np.random.default_rng(5)
    arrays = [rng.uniform(-2000, 2000, (8, 8)).astype(np.float32) for _ in range(3)]
    paths = []
    for i, a in enumerate(arrays):
        paths.append(str(tmp_path / f"s{i}.npy"))
        np.save(paths[-1], a)
    out = native_loader.load_npy_batch(paths, 8, 8, window=(1500, -550, 2.0))
    ep = native_loader.load_npy_batch(paths, 8, 8, n_threads=2,
                                      epilogue=(native_loader.EP_INTENSITY, 0.0, 255.0))
    for i, a in enumerate(arrays):
        np.testing.assert_allclose(out[i], normalize(a, 1500, -550, 2.0), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ep[i], normalize_intensity_np(a), rtol=1e-5, atol=1e-6)
    with pytest.raises(IOError, match="missing.npy"):
        native_loader.load_npy_batch(paths + [str(tmp_path / "missing.npy")], 8, 8)


def test_prefetch_to_device_on_cpu(trees):
    _, t = _loaders(trees, "NCCLungDataset", "train")
    want = list(t.epoch_iterator(0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = list(prefetch_to_device(t.epoch_iterator(0), size=2, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g["image"], torch.Tensor) and g["image"].device.type == "cpu"
        np.testing.assert_array_equal(g["image"].numpy(), w["image"])
        assert g["patient_id"] == w["patient_id"]
