"""Tests of the PyTorch port that need a CUDA card: each hand-written kernel
against its plain PyTorch version, and the encode path through the kernel.

They skip on a host without a card. This file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

from medical_image_editing_tpu_torch.ops import _build
from medical_image_editing_tpu_torch.ops import vq as tvq
from medical_image_editing_tpu_torch.ops import vq_fused as tvqf


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, c, k, seed, device):
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(device)
    embed = torch.from_numpy(rng.normal(size=(k, c)).astype(np.float32)).to(device)
    return flat, embed


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,k", [(512, 16, 10), (128, 96, 12), (100, 16, 10),
                                   (4096, 64, 512), (70000, 16, 10)])
def test_vq_kernel_matches_plain(cuda, n, c, k):
    x, e = _inputs(n, c, k, 2, cuda)
    before = _build.launches[tvqf.KERNEL]
    got = tvqf.vq_assign_fused(e, x)
    again = tvqf.vq_assign_fused(e, x)
    torch.cuda.synchronize()
    assert _build.launches[tvqf.KERNEL] == before + 2
    want = tvqf.vq_assign_fused_reference(e, x)
    # ids agree wherever the plain top-2 score gap is clear of f32 rounding
    top2 = tvq.vq_scores(e, x).topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5 * top2.abs().max()
    assert torch.equal(got[0][clear], want[0][clear])
    ids = got[0].long()
    assert torch.equal(got[1], e[ids])
    assert torch.equal(got[2], torch.bincount(ids, minlength=k).float())
    segment = torch.zeros(k, c, dtype=torch.float64, device=cuda).index_add_(
        0, ids, x.double())
    assert (got[3].double() - segment).abs().max() <= 1e-5 * x.abs().sum()
    for a, b in zip(got, again):  # no atomics: bit-identical reruns
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_vq_kernel_refuses_what_it_cannot_take(cuda):
    x, e = _inputs(64, 16, 10, 3, cuda)
    with pytest.raises(TypeError):
        tvqf._launch(e, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        tvqf._launch(e, x.t().contiguous().t())
    with pytest.raises(ValueError, match="shared memory"):
        tvqf._launch(*_inputs(64, 1024, 64, 3, cuda)[::-1])


@pytest.mark.gpu
@pytest.mark.parametrize("train", [True, False])
def test_fused_vq_apply_matches_plain_on_card(cuda, train):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 16, 16, 16)).astype(np.float32)).to(cuda)
    e = torch.from_numpy(rng.normal(size=(10, 16)).astype(np.float32)).to(cuda)
    state = tvq.VQState(e, torch.full((10,), 3.0, device=cuda), e.clone())
    fq, fc, fids, fs = tvq.vq_apply(state, x, momentum=0.9, train=train, backend="pallas")
    pq, pc, pids, ps = tvq.vq_apply(state, x, momentum=0.9, train=train, backend="xla")
    assert torch.equal(fids, pids)
    torch.testing.assert_close(fq, pq, rtol=0, atol=1e-6)
    torch.testing.assert_close(fc, pc, rtol=1e-5, atol=0)
    for a, b in zip(fs, ps):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_encode_goes_through_the_kernel(cuda):
    from medical_image_editing_tpu_torch.cli.run_recon import LungConfig, load_model
    from medical_image_editing_tpu_torch.train.evaluate import make_eval_forward

    cfg = LungConfig()
    cfg.resume_checkpoint = None
    cfg.enc_filters, cfg.dec_filters, cfg.dict_size = (4, 8, 8, 16, 16), (8, 8, 16, 16, 32), 6
    cfg.knn_backend = "pallas"
    enc, dec, _ = load_model(cfg, device=cuda)
    x = np.random.default_rng(5).uniform(-1, 1, size=(2, 32, 32, 1)).astype(np.float32)
    before = _build.launches[tvqf.KERNEL]
    recon, ids = make_eval_forward(enc, dec, device=cuda)(x)
    torch.cuda.synchronize()
    assert _build.launches[tvqf.KERNEL] == before + 1
    assert recon.shape == (2, 32, 32, 1) and torch.isfinite(recon).all()
    assert ids.dtype == torch.int32 and int(ids.min()) >= 1 and int(ids.max()) <= 6
