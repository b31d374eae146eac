"""The port's test metrics against the JAX package's on seeded inputs, on
the CPU: NMSE, PSNR, SSIM (11-tap Gaussian, σ 1.5, no padding, the data
range rule) and the base-2 label entropy, rtol 1e-5; and `result.csv`
from `test_epoch_end`, read back with pandas, against the JAX package's
(which pandas writes).
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from medical_image_editing_tpu.ops import metrics as jm
from medical_image_editing_tpu.train import evaluate as jev
from medical_image_editing_tpu_torch.ops import metrics as tm
from medical_image_editing_tpu_torch.train import evaluate as tev


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    target = rng.uniform(-1, 1, shape).astype(np.float32)
    pred = np.clip(target + rng.normal(0, 0.2, shape), -1.2, 1.2).astype(np.float32)
    return pred, target


SHAPES = [(2, 32, 32, 1), (1, 11, 11, 1), (3, 24, 40, 2)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["nmse", "psnr", "ssim"])
def test_recon_metrics_match_jax(shape, name):
    pred, target = _pair(shape, seed=sum(shape))
    got = getattr(tm, name)(torch.from_numpy(pred), torch.from_numpy(target))
    want = getattr(jm, name)(jnp.asarray(pred), jnp.asarray(target))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_metrics_with_an_explicit_data_range_match_jax():
    pred, target = _pair((2, 16, 16, 1), seed=4)
    for name in ("psnr", "ssim"):
        got = getattr(tm, name)(torch.from_numpy(pred), torch.from_numpy(target),
                                data_range=2.0)
        want = getattr(jm, name)(jnp.asarray(pred), jnp.asarray(target), data_range=2.0)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("dict_size,lo,hi", [(10, 1, 11), (10, 0, 12), (5, 3, 4), (7, -2, 3)])
def test_label_entropy_matches_jax(dict_size, lo, hi):
    ids = np.random.default_rng(dict_size + lo).integers(lo, hi, (2, 16, 16)).astype(np.int32)
    got = tm.label_entropy(torch.from_numpy(ids), dict_size)
    want = jm.label_entropy(jnp.asarray(ids), dict_size)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)


def test_result_csv_reads_back_as_pandas_writes_it(tmp_path):
    rng = np.random.default_rng(0)
    outputs = [{"NMSE": float(rng.uniform()), "SSIM": float(rng.uniform()),
                "PSNR": float(rng.uniform(10, 30)), "Entropy": float(rng.uniform(0, 3))}
               for _ in range(5)]
    got = tev.test_epoch_end(outputs, str(tmp_path / "port"))
    want = jev.test_epoch_end(outputs, str(tmp_path / "jax"))
    assert got.endswith("result.csv") and want.endswith("result.csv")
    a, b = pd.read_csv(got), pd.read_csv(want)
    assert list(a.columns) == list(b.columns) == [
        "Unnamed: 0", "NMSE_avg", "NMSE_std", "SSIM_avg", "SSIM_std",
        "PSNR_avg", "PSNR_std", "Entropy_avg", "Entropy_std"]
    pd.testing.assert_frame_equal(a, b, check_exact=True)
    assert open(got).read() == open(want).read()
    assert tev.test_epoch_end([], str(tmp_path / "none")) is None
