"""The offline preprocessing, port vs JAX package: the same fabricated NIfTI
volumes through both packages' `data/preprocess.py`, the outputs (file
names, dtypes, shapes and bytes) identical. Small volumes and sizes: CRC
24 × 20 × 3 resized to 32², BraTS 20 × 18 × 3 resized to 16²."""

import os

import numpy as np
import pytest

from medical_image_editing_tpu.data import preprocess as jpre
from medical_image_editing_tpu_torch.data import preprocess as tpre
from medical_image_editing_tpu_torch.utils import nifti


def _tree(root):
    """{relative path: (dtype, shape, bytes)} of every .npy under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            a = np.load(os.path.join(d, f))
            out[os.path.relpath(os.path.join(d, f), root)] = (a.dtype, a.shape, a.tobytes())
    return out


def _same_outputs(jroot, troot, n_files):
    want, got = _tree(jroot), _tree(troot)
    assert len(want) == n_files
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


def _crc_volume(path, seed):
    rng = np.random.default_rng(seed)
    nifti.save((rng.normal(0, 300, (24, 20, 3)) - 200).astype(np.int16), str(path))


@pytest.mark.parametrize("name", ["CRC_001_image.nii.gz", "a_b_c_d.nii", "x.nii.gz"])
def test_parse_patient_id(name):
    assert tpre.parse_patient_id(f"/d/{name}") == jpre.parse_patient_id(f"/d/{name}")


@pytest.mark.parametrize("fn", ["minmax_normalize", "z_score_normalize"])
def test_normalizers_bit_identical(fn):
    x = np.random.default_rng(0).normal(50, 30, (7, 9, 4))
    x[:2] = 0
    got, want = getattr(tpre, fn)(x), getattr(jpre, fn)(x)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("nearest", [False, True], ids=["bilinear", "nearest"])
def test_resize_and_geometry_bit_identical(nearest):
    x = np.random.default_rng(1).uniform(0, 255, (24, 20)).astype(np.float64)
    for a, b in ((tpre._resize(x, 32, nearest), jpre._resize(x, 32, nearest)),
                 (tpre._crc_slice_geometry(x), jpre._crc_slice_geometry(x))):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_preprocess_crc_volume_and_cli(tmp_path):
    src = tmp_path / "raw"
    src.mkdir()
    for i in range(2):
        _crc_volume(src / f"CRC_{i:03d}_image.nii.gz", i)
    (src / "CRC_000_label.nii.gz").write_bytes(b"")  # not an *_image volume
    tpre.preprocess_crc_volume(str(src / "CRC_000_image.nii.gz"), str(tmp_path / "t1"), 32)
    jpre.preprocess_crc_volume(str(src / "CRC_000_image.nii.gz"), str(tmp_path / "j1"), 32)
    _same_outputs(tmp_path / "j1", tmp_path / "t1", 3)
    assert sorted(os.listdir(tmp_path / "t1" / "CRC_000")) == ["0000.npy", "0001.npy", "0002.npy"]
    # the CLI over the directory, and the JAX function over it
    tpre.main(["crc", "--src", str(src), "--dst", str(tmp_path / "t2"), "--image-size", "32"])
    jpre.preprocess_crc(str(src), str(tmp_path / "j2"), 32)
    _same_outputs(tmp_path / "j2", tmp_path / "t2", 6)


def test_make_crc_testing_dataset(tmp_path):
    cand = tmp_path / "cand"
    cand.mkdir()
    for i in range(3):
        _crc_volume(cand / f"CRC_{i:03d}_image.nii.gz", 10 + i)
    train = tmp_path / "train"
    (train / "CRC_001").mkdir(parents=True)
    for pkg, out in ((tpre, "t"), (jpre, "j")):
        pkg.make_crc_testing_dataset(str(train), str(cand), str(tmp_path / out), 32,
                                     expected_training_patients=1)
    _same_outputs(tmp_path / "j", tmp_path / "t", 6)
    assert sorted(os.listdir(tmp_path / "t")) == ["CRC_000", "CRC_002"]
    with pytest.raises(AssertionError):
        tpre.make_crc_testing_dataset(str(train), str(cand), str(tmp_path / "x"), 32,
                                      expected_training_patients=289)


def _brats_patient(root, pid, seed):
    rng = np.random.default_rng(seed)
    d = root / pid
    d.mkdir(parents=True)
    brain = rng.uniform(0, 1, (20, 18, 3)) > 0.3
    for m in ("t1", "t1ce", "t2", "flair"):
        nifti.save((rng.uniform(10, 900, (20, 18, 3)) * brain).astype(np.int16),
                   str(d / f"{pid}_{m}.nii.gz"))
    seg = rng.choice([0, 1, 2, 4], (20, 18, 3)).astype(np.uint8)
    nifti.save(seg, str(d / f"{pid}_seg.nii.gz"))


@pytest.mark.parametrize("remap", [True, False], ids=["remap", "no_remap"])
def test_preprocess_brats_patient(tmp_path, remap):
    _brats_patient(tmp_path / "src", "BraTS_001", 0)
    for pkg, out in ((tpre, "t"), (jpre, "j")):
        pkg.preprocess_brats_patient("BraTS_001", str(tmp_path / "src"), str(tmp_path / out),
                                     16, remap_seg_labels=remap)
    _same_outputs(tmp_path / "j", tmp_path / "t", 15)
    seg = np.load(tmp_path / "t" / "BraTS_001" / "BraTS_001_seg_0001.npy")
    assert seg.dtype == np.int32 and seg.shape == (16, 16)
    assert set(np.unique(seg)) <= ({0, 1, 2, 3} if remap else {0, 1, 2, 4})


def test_preprocess_brats_fan_out(tmp_path):
    src = tmp_path / "MICCAI_BraTS_2019_Data_Training" / "HGG"
    for i in range(3):
        _brats_patient(src, f"BraTS_{i:03d}", 20 + i)
    tpre.main(["brats", "--src", str(src), "--dst", str(tmp_path / "t"), "--image-size", "16"])
    jpre.preprocess_brats([str(src)], str(tmp_path / "j"), 16)
    _same_outputs(tmp_path / "j", tmp_path / "t", 45)
