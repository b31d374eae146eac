"""Tests of the PyTorch port that need a CUDA card: each hand-written kernel
against its plain PyTorch version, the encode path through the VQ kernel,
and a training step through both kernels.

They skip on a host without a card. This file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py
"""

import contextlib
import copy
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from medical_image_editing_tpu_torch.ops import _build
from medical_image_editing_tpu_torch.ops import conv_pack as tcp
from medical_image_editing_tpu_torch.ops import quantized_conv as tqc
from medical_image_editing_tpu_torch.ops import vq as tvq
from medical_image_editing_tpu_torch.ops import vq_fused as tvqf
from medical_image_editing_tpu_torch.utils.witness import (
    first_moments,
    float64_step,
    recorded_vq_ids,
    to_float64,
    witness_gaps,
    witness_limits,
)


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
                                   (4096, 64, 512), (70000, 16, 10),
                                   # the <16, 10> instance: one row, tile - 1,
                                   # tile + 1, the training point
                                   (1, 16, 10), (255, 16, 10), (257, 16, 10),
                                   (524288, 16, 10),
                                   # the generic instance: K past 10, K = 1,
                                   # C not a multiple of 4, VQGAN's codebook
                                   (1000, 16, 17), (300, 16, 1), (333, 7, 5),
                                   (8192, 512, 64)])
def test_vq_kernel_matches_plain(cuda, n, c, k):
    x, e = _inputs(n, c, k, 2, cuda)
    assert tvqf.kernel_path(c, k) == ("c16k10" if (c, k) == (16, 10) else "generic")
    before = _build.launches[tvqf.KERNEL]
    got = tvqf.vq_assign_fused(e, x)
    again = tvqf.vq_assign_fused(e, x)
    torch.cuda.synchronize()
    assert _build.launches[tvqf.KERNEL] == before + 2
    want = tvqf.vq_assign_fused_reference(e, x)
    # ids agree wherever the plain top-2 score gap is clear of f32 rounding
    if k > 1:
        top2 = tvq.vq_scores(e, x).topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-5 * top2.abs().max()
    else:
        clear = torch.ones(n, dtype=torch.bool, device=cuda)
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
@pytest.mark.parametrize("c,k", [(16, 10), (64, 12)])
def test_vq_kernel_takes_an_unaligned_view(cuda, c, k):
    """A contiguous view of the features 4 bytes past a 16-byte boundary
    goes through the kernel (copied first for its 16-byte loads) and gives
    what the aligned tensor gives."""
    x, e = _inputs(1001, c, k, 12, cuda)
    store = torch.empty(x.numel() + 1, device=cuda)
    view = store[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    before = _build.launches[tvqf.KERNEL]
    got = tvqf.vq_assign_fused(e, view)
    want = tvqf.vq_assign_fused(e, x)
    torch.cuda.synchronize()
    assert _build.launches[tvqf.KERNEL] == before + 2
    for a, b in zip(got, want):
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
def test_fused_vq_gradients_match_plain_on_card(cuda):
    """The commit loss and the straight-through estimator carry the same
    gradient on the fused route as on the plain one."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 16, 16, 16)).astype(np.float32)).to(cuda)
    cot = torch.from_numpy(rng.normal(size=(2, 16, 16, 16)).astype(np.float32)).to(cuda)
    e = torch.from_numpy(rng.normal(size=(10, 16)).astype(np.float32)).to(cuda)
    state = tvq.VQState(e, torch.zeros(10, device=cuda), e.clone())
    grads = []
    for backend in ("pallas", "xla"):
        xx = x.clone().requires_grad_()
        q, commit, _, _ = tvq.vq_apply(state, xx, momentum=0.9, train=True, backend=backend)
        (commit + (q * cot).sum()).backward()
        grads.append(xx.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-6)
    assert (grads[0] - cot).abs().max() > 1e-3


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


@pytest.mark.gpu
def test_exported_bf16_packed_decode_on_card(cuda, monkeypatch, tmp_path):
    """The bf16 edit decode exported on the card under the packed route
    (`cli/export_model.py`), saved and loaded: 10 `medimg::conv3x3_packed`
    nodes (the decoder's 32-channel convolutions at 32² and 16²); at batch 1
    and 3 bit for bit the eager `make_batched_edit_fn`, with as many
    `conv3x3_packed:bf16` launches (10 a decode) and no other."""
    from medical_image_editing_tpu_torch.cli import export_model as tem
    from medical_image_editing_tpu_torch.cli.edit_batch import make_batched_edit_fn
    from medical_image_editing_tpu_torch.cli.run_recon import LungConfig, load_model

    monkeypatch.setenv("MEDIMG_CONV_IMPL", "packed")
    cfg = LungConfig()
    cfg.resume_checkpoint, cfg.compute_dtype = None, "bfloat16"
    cfg.enc_filters, cfg.dec_filters, cfg.dict_size = (4, 8, 8, 16, 16), (32, 8, 8, 16, 16), 6
    _, dec, vq = load_model(cfg, device=cuda)
    ids = np.random.default_rng(3).integers(-5, 7, (3, 32, 32)).astype(np.int32)
    ids[1] = 0
    edit = make_batched_edit_fn(dec, is_lung=True, device=cuda)
    artifact = tem.export_edit_artifact(dec, vq, image_size=32, is_lung=True, device=cuda)
    assert sum(1 for n in artifact.program.graph.nodes
               if str(n.target).startswith("medimg.conv3x3_packed")) == 10
    tem.save_edit_artifact(str(tmp_path / "edit.pt2"), artifact)
    call = tem.load_edit_artifact(str(tmp_path / "edit.pt2"), device=cuda)
    for b in (1, 3):
        counts = []
        for fn in (lambda: edit(vq, ids[:b]), lambda: call(ids[:b])):
            _build.launches.clear()
            out = fn()
            torch.cuda.synchronize()
            counts.append((out, dict(_build.launches)))
        (want, n_eager), (got, n_artifact) = counts
        assert n_eager == n_artifact == {tcp.KERNEL: 10, tcp.LAUNCH_KEYS["bf16"]: 10}
        assert got.device.type == "cuda" and torch.equal(got, want)


def _conv_inputs(b, cin, cout, h, w, dtype, device, seed=6):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, cin, h, w, generator=g, device=device).to(dtype)
    wt = ((torch.rand(cout, cin, 3, 3, generator=g, device=device) * 2 - 1)
          / (9 * cin) ** 0.5).to(dtype)
    dy = torch.randn(b, cout, h, w, generator=g, device=device).to(dtype)
    return x, wt, dy


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 32, 32, 64, 64), (2, 32, 64, 32, 32),
                                   (2, 64, 32, 16, 16), (3, 20, 40, 37, 45),
                                   (1, 1, 3, 5, 7), (1, 8, 72, 9, 33),
                                   (2, 48, 3, 12, 40)])
def test_conv_kernel_matches_plain(cuda, dtype, shape):
    """Forward and dx (through the autograd Function) against f32 autograd
    through `F.conv2d` on the same values: f32 to summation order (1e-4),
    bf16 to one rounding of the f32 sum (2^-8 relative). The shapes reach
    every edge of the bf16 kernel's tiles: Cin 1, 8 and 72 (a ragged 16-chunk)
    and 48 (three chunks); Cout 3 (a ragged n8 tile) and 72 (three channel
    tiles); W 33 and 45 (a column past a 32-wide tile), H 9 and 37 (a row
    past an 8-row tile); batch 1."""
    dt = getattr(torch, dtype)
    b, cin, cout, h, w = shape
    x, wt, dy = _conv_inputs(b, cin, cout, h, w, dt, cuda)
    before = _build.launches[tcp.KERNEL]
    xk = x.clone().requires_grad_()
    y = tcp.conv3x3_packed_trainable_nchw(xk, wt)
    y.backward(dy)
    again = tcp.conv3x3_packed_nchw(x, wt)
    torch.cuda.synchronize()
    assert _build.launches[tcp.KERNEL] == before + 3  # forward, dx, again
    assert y.dtype == dt and xk.grad.dtype == dt
    assert torch.equal(y, again)  # no atomics: bit-identical reruns
    xr = x.float().requires_grad_()
    ref = torch.nn.functional.conv2d(xr, wt.float(), padding=1)
    ref.backward(dy.float())
    rel = 2.0**-8 if dt == torch.bfloat16 else 0.0
    assert ((y.float() - ref).abs() <= rel * ref.abs() + 1e-4).all()
    assert ((xk.grad.float() - xr.grad).abs() <= rel * xr.grad.abs() + 1e-4).all()
    # the JAX layout's entry runs the same kernel on NHWC
    nhwc = tcp.conv3x3_packed(x.permute(0, 2, 3, 1), wt.permute(2, 3, 1, 0))
    assert torch.equal(nhwc.permute(0, 3, 1, 2), again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_kernel_reads_strided_input(cuda, dtype):
    """A channel slice x[:, 1:] (neither NCHW- nor NHWC-contiguous, with a
    storage offset) goes through the kernel by its strides."""
    dt = getattr(torch, dtype)
    x, wt, _ = _conv_inputs(2, 21, 24, 17, 35, dt, cuda, seed=11)
    xs, ws = x[:, 1:], wt[:, 1:]
    assert not xs.is_contiguous()
    y = tcp.conv3x3_packed_nchw(xs, ws)
    assert torch.equal(y, tcp.conv3x3_packed_nchw(xs.contiguous(), ws))
    ref = torch.nn.functional.conv2d(xs.float(), ws.float(), padding=1)
    rel = 2.0**-8 if dt == torch.bfloat16 else 0.0
    assert ((y.float() - ref).abs() <= rel * ref.abs() + 1e-4).all()


@pytest.mark.gpu
def test_conv_bf16_launch_counts_once(cuda):
    """A bf16 call launches the tensor-core kernel once and counts one
    launch; a refused dtype raises as before and counts none."""
    x, wt, _ = _conv_inputs(1, 16, 16, 8, 8, torch.bfloat16, cuda)
    before = _build.launches[tcp.KERNEL]
    tcp.conv3x3_packed_nchw(x, wt)
    torch.cuda.synchronize()
    assert _build.launches[tcp.KERNEL] == before + 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tcp.conv3x3_packed_nchw(x.half(), wt.half())
    assert _build.launches[tcp.KERNEL] == before + 1


@pytest.mark.gpu
def test_conv_kernel_refuses_what_it_cannot_take(cuda):
    x, wt, _ = _conv_inputs(1, 8, 8, 8, 8, torch.float32, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tcp.conv3x3_packed_nchw(x.half(), wt.half())
    with pytest.raises(TypeError):
        tcp.conv3x3_packed_nchw(x, wt.bfloat16())
    with pytest.raises(ValueError, match="channels"):
        tcp.conv3x3_packed_nchw(x[:, :4], wt)
    with pytest.raises(ValueError, match="3,3"):
        tcp.conv3x3_packed_nchw(x, wt[..., :2, :2])
    with pytest.raises(ValueError, match="no kernel"):
        tcp.conv3x3_packed_nchw(x, wt.cpu())


# The two f32 instances (`conv_pack.instance`): cuDNN's TF32 flag off runs
# conv3x3_f32_kernel (ieee), on runs conv3x3_tf32_kernel. Shapes: scaled-down
# copies of chip_smoke.py's CONV_POINTS (32→32 at two sizes, 32→64 at two;
# their dx 64→32 in the same call), the ragged shape, and Cout 64 and 96 (one
# wide channel tile and a ragged second one); batch 2 or 3, and every grid
# small enough that the half-height tiles are taken too (fewer blocks than
# SMs at 16² and the ragged shape's narrow tiles).
F32_SHAPES = [(2, 32, 32, 64, 64), (2, 32, 32, 32, 32), (2, 32, 64, 32, 32),
              (2, 32, 64, 16, 16), (3, 20, 40, 37, 45), (2, 24, 64, 20, 36),
              (2, 16, 96, 19, 40)]


@contextlib.contextmanager
def _cudnn_tf32(value):
    """cuDNN's TF32 flag set to `value` inside the block (the `allow_tf32`
    flag alone, as `utils/device.py` sets it), restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = value
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _tf32_tolerance(x, w):
    """|kernel - f32 conv| on unrounded x, w: each operand moves by 2^-11
    relative in the rounding, so a product by 2^-10 (+ 2^-22): 2^-10 × the
    convolution of |x| and |w| (f32, TF32 off), + 1e-4 for the f32 sums'
    order."""
    with _cudnn_tf32(False):
        mag = torch.nn.functional.conv2d(x.abs().float(), w.abs().float(), padding=1)
    return (2.0**-10 + 2.0**-22) * mag + 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("tf32", [False, True], ids=["ieee", "tf32"])
@pytest.mark.parametrize("shape", F32_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv_f32_instances_match_their_plain_versions(cuda, monkeypatch, tf32, shape):
    """cuDNN's TF32 flag as stated by the `tf32` parameter (the fixture sets it
    off). Forward and dx (through the autograd Function) of the instance the
    flag picks, against its plain version on the same inputs: ieee against
    `conv3x3_packed_reference_nchw` (f32 sums in another order: 1e-4
    absolute), tf32 against `conv3x3_tf32_reference_nchw` (the same TF32
    rounding, f32 sums in another order: 1e-4 absolute + 2^-18 relative) and
    against the f32 convolution of the unrounded values (`_tf32_tolerance`).
    Two runs bit for bit, the NHWC entry equal to NCHW, and only the picked
    instance counted."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
    inst = "tf32" if tf32 else "f32"
    assert tcp.instance(torch.float32) == inst
    b, cin, cout, h, w = shape
    x, wt, dy = _conv_inputs(b, cin, cout, h, w, torch.float32, cuda, seed=17)
    before = _build.launches.copy()
    xk = x.clone().requires_grad_()
    y = tcp.conv3x3_packed_trainable_nchw(xk, wt)
    y.backward(dy)
    again = tcp.conv3x3_packed_nchw(x, wt)
    nhwc = tcp.conv3x3_packed(x.permute(0, 2, 3, 1), wt.permute(2, 3, 1, 0))
    torch.cuda.synchronize()
    # forward, dx, again, NHWC
    assert _build.launches - before == {tcp.KERNEL: 4, tcp.LAUNCH_KEYS[inst]: 4}
    assert torch.equal(y, again)  # no atomics: bit-identical reruns
    assert torch.equal(nhwc.permute(0, 3, 1, 2), again)
    wdx = tcp.flip_transpose(wt)
    for got, (xx, ww) in ((y.detach(), (x, wt)), (xk.grad, (dy, wdx))):
        if tf32:
            want = tcp.conv3x3_tf32_reference_nchw(xx, ww)
            assert ((got - want).abs() <= 2.0**-18 * want.abs() + 1e-4).all()
            with _cudnn_tf32(False):
                exact = torch.nn.functional.conv2d(xx, ww, padding=1)
            assert ((got - exact).abs() <= _tf32_tolerance(xx, ww)).all()
            assert not torch.equal(got, exact)  # the rounding shows
        else:
            want = tcp.conv3x3_packed_reference_nchw(xx, ww)
            assert (got - want).abs().max() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("tf32", [False, True], ids=["ieee", "tf32"])
def test_conv_f32_instances_read_strided_input(cuda, monkeypatch, tf32):
    """cuDNN's TF32 flag as the parameter says. A channel slice x[:, 1:]
    (neither NCHW- nor NHWC-contiguous, with a storage offset: the element
    route) and a column slice (rows 16-byte aligned, a short last piece) go
    through each f32 instance by their strides, equal to their contiguous
    copies bit for bit."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
    x, wt, _ = _conv_inputs(2, 21, 40, 17, 40, torch.float32, cuda, seed=18)
    plain = tcp.conv3x3_tf32_reference_nchw if tf32 else tcp.conv3x3_packed_reference_nchw
    for xs, ws in ((x[:, 1:], wt[:, 1:]), (x[..., :37], wt)):
        assert not xs.is_contiguous()
        y = tcp.conv3x3_packed_nchw(xs, ws)
        assert torch.equal(y, tcp.conv3x3_packed_nchw(xs.contiguous(), ws))
        with _cudnn_tf32(False):
            want = plain(xs, ws)
        assert ((y - want).abs() <= 2.0**-18 * want.abs() + 1e-4).all()


@pytest.mark.gpu
def test_conv_tf32_flag_picks_the_instance(cuda, monkeypatch):
    """cuDNN's TF32 flag off, then on, then off: each f32 call launches the
    instance the flag names at the call (per-instance counts, the total
    beside them), bf16 its own whatever the flag, and the CPU route none."""
    x, wt, _ = _conv_inputs(1, 32, 32, 16, 32, torch.float32, cuda, seed=19)
    counts, ys = [], []
    for flag in (False, True, False):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", flag)
        before = _build.launches.copy()
        ys.append(tcp.conv3x3_packed_nchw(x, wt))
        tcp.conv3x3_packed_nchw(x.bfloat16(), wt.bfloat16())
        tcp.conv3x3_packed_nchw(x.cpu(), wt.cpu())
        torch.cuda.synchronize()
        counts.append(_build.launches - before)
    assert counts == [{tcp.KERNEL: 2, tcp.LAUNCH_KEYS[inst]: 1, tcp.LAUNCH_KEYS["bf16"]: 1}
                      for inst in ("f32", "tf32", "f32")]
    assert torch.equal(ys[0], ys[2]) and not torch.equal(ys[0], ys[1])


@pytest.mark.gpu
def test_train_step_goes_through_both_kernels(cuda, monkeypatch):
    from medical_image_editing_tpu_torch.models import UNetDecoder
    from medical_image_editing_tpu_torch.models.blocks import seeded_init
    from medical_image_editing_tpu_torch.models.unet_encoder import EncoderWithVQ
    from medical_image_editing_tpu_torch.train import first_stage as tfs
    from medical_image_editing_tpu_torch.train import state as tstate

    monkeypatch.setenv("MEDIMG_CONV_IMPL", "packed")
    enc = EncoderWithVQ(1, (4, 32, 8, 16, 16), 6, knn_backend="pallas",
                        dtype=torch.bfloat16)
    dec = UNetDecoder(4, 1, (32, 8, 8, 16, 16), dropped_skip_layers=(),
                      use_pixel_shuffle=False, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    enc, dec = seeded_init(enc, g).to(cuda), seeded_init(dec, g).to(cuda)
    state = tstate.create_train_state(enc, dec, tstate.make_optimizer(enc.parameters(), 1e-4),
                                      tstate.make_optimizer(dec.parameters(), 1e-4),
                                      device=cuda)
    aug = {"modules": ["RandomHorizontalFlip", "RandomAffine", "RandomGaussianNoise"],
           "RandomHorizontalFlip": {"p": 0.5},
           "RandomAffine": {"degrees": 10.0, "translate": [0.05, 0.05], "p": 0.8},
           "RandomGaussianNoise": {"std": 0.05, "p": 0.5}}
    step = tfs.make_first_stage_step(enc, dec, loss_cfg=tfs.FirstStageLossConfig(),
                                     aug_cfg=aug, dict_size=6, compute_dtype=torch.bfloat16,
                                     device=cuda)
    x = np.random.default_rng(7).uniform(-1, 1, size=(2, 32, 32, 1)).astype(np.float32)
    _build.launches.clear()
    tfs.init_codebook_step(enc)(state, x)
    torch.cuda.synchronize()
    # encoder: 32→32 at 16² twice and 32→8 at 8²; decoder: 10 convs
    assert dict(_build.launches) == {tcp.KERNEL: 3, tcp.LAUNCH_KEYS["bf16"]: 3}
    state, metrics = step(state, x)
    torch.cuda.synchronize()
    assert _build.launches[tvqf.KERNEL] == 2
    assert _build.launches[tcp.KERNEL] == 3 + 4 * (3 + 10)  # 2 views × (forward + dx)
    assert all(torch.isfinite(v) for v in metrics.values())


@pytest.mark.gpu
def test_conv_kernel_bf16_at_serving_size(cuda):
    """The bf16 packed conv at a single request's decoder shape (batch 1,
    32→32, 512²) against f32 `F.conv2d` on the same values, to one rounding
    of the f32 sum (2^-8 relative, 1e-4 absolute)."""
    x, wt, _ = _conv_inputs(1, 32, 32, 512, 512, torch.bfloat16, cuda, seed=13)
    before = _build.launches[tcp.KERNEL]
    y = tcp.conv3x3_packed_nchw(x, wt)
    torch.cuda.synchronize()
    assert _build.launches[tcp.KERNEL] == before + 1
    ref = torch.nn.functional.conv2d(x.float(), wt.float(), padding=1)
    assert ((y.float() - ref).abs() <= 2.0**-8 * ref.abs() + 1e-4).all()


@pytest.mark.gpu
def test_vq_kernel_walks_rows_past_the_limit(cuda):
    """N = 2^24 + 3 rows (past one launch's limit) go through the kernel in
    two chunks: ids where the plain top-2 gap is clear, rows, exact counts,
    sums within 1e-5·Σ|x|, bit-identical reruns."""
    n, c, k = tvqf.MAX_ROWS + 3, 16, 10
    g = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn(n, c, generator=g, device=cuda)
    e = torch.randn(k, c, generator=g, device=cuda)
    before = _build.launches[tvqf.KERNEL]
    got = tvqf.vq_assign_fused(e, x)
    again = tvqf.vq_assign_fused(e, x)
    torch.cuda.synchronize()
    assert _build.launches[tvqf.KERNEL] == before + 4
    want = tvqf.vq_assign_fused_reference(e, x)
    top2 = tvq.vq_scores(e, x).topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5 * top2.abs().max()
    assert torch.equal(got[0][clear], want[0][clear])
    ids = got[0].long()
    assert torch.equal(got[1], e[ids])
    assert torch.equal(got[2], torch.bincount(ids, minlength=k).float())
    segment = torch.zeros(k, c, dtype=torch.float64, device=cuda).index_add_(
        0, ids, x.double())
    assert (got[3].double() - segment).abs().max() <= 1e-5 * x.abs().sum()
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["xla", "packed"])
def test_bf16_serve_decode_on_card_matches_cpu(cuda, monkeypatch, route):
    """The decode at the lung widths on a 64² crop, card vs the port's CPU
    path on the same seeded weights. f32 (TF32 off): within 1e-3, as the
    serve phase holds its encode and decode. bf16: both devices round every
    operation to bf16, so at random init the two bf16 decodes scatter
    around the f32 one alike: the card's mean abs gap from the CPU's f32
    decode is at most 1.5× the CPU bf16 decode's own. Under the packed
    route the decoder's 32-channel convolutions launch the conv kernel, in
    f32 and in bf16."""
    from medical_image_editing_tpu_torch.cli.run_recon import LungConfig, load_model
    from medical_image_editing_tpu_torch.cli.edit_batch import make_batched_edit_fn

    monkeypatch.setenv("MEDIMG_CONV_IMPL", route)
    ids = np.random.default_rng(15).integers(0, 11, (2, 64, 64)).astype(np.int32)
    out, launched = {}, {}
    for device in ("cpu", cuda):
        for dtype in (None, "bfloat16"):
            cfg = LungConfig()
            cfg.resume_checkpoint, cfg.compute_dtype = None, dtype
            _, dec, vq = load_model(cfg, device=device, seed=3)
            before = _build.launches[tcp.KERNEL]
            recon = make_batched_edit_fn(dec, is_lung=True, device=device)(vq, ids)
            out[(torch.device(device).type, dtype)] = recon.float().cpu().numpy()
            launched[(torch.device(device).type, dtype)] = _build.launches[tcp.KERNEL] - before
    for dtype in (None, "bfloat16"):  # the packed route takes f32 and bf16 alike
        assert (launched[("cuda", dtype)] > 0) == (route == "packed")
    cpu32, cpu16 = out[("cpu", None)], out[("cpu", "bfloat16")]
    card32, card16 = out[("cuda", None)], out[("cuda", "bfloat16")]
    assert np.abs(card32 - cpu32).max() <= 1e-3
    assert np.isfinite(card16).all() and np.abs(card16).max() <= 1.0
    card_gap, cpu_gap = np.abs(card16 - cpu32).mean(), np.abs(cpu16 - cpu32).mean()
    assert card_gap <= 1.5 * cpu_gap, (card_gap, cpu_gap)


@pytest.mark.gpu
def test_prefetch_to_device_pinned_batches(cuda):
    """`prefetch_to_device` on the card: every batch arrives intact although
    each copy is `non_blocking` from pinned memory and the host builds the
    next batches meanwhile (a pinned buffer is never refilled), and a
    kernel reading the previous batch does not see it change."""
    from medical_image_editing_tpu_torch.data.loader import prefetch_to_device

    rng = np.random.default_rng(16)
    batches = [{"image": rng.normal(size=(8, 256, 256, 1)).astype(np.float32),
                "patient_id": [f"p{i}"] * 8, "slice_num": np.arange(8, dtype=np.int32)}
               for i in range(6)]
    got = []
    for b in prefetch_to_device(iter(batches), size=2, device=cuda):
        assert b["image"].device.type == "cuda"
        got.append((b["patient_id"][0], (b["image"] * 2).sum(dtype=torch.float64), b["image"]))
    torch.cuda.synchronize()
    assert [g[0] for g in got] == [f"p{i}" for i in range(6)]
    for (_, s, image), want in zip(got, batches):
        assert torch.equal(image.cpu(), torch.from_numpy(want["image"]))
        assert float(s) == pytest.approx(2 * float(want["image"].sum(dtype=np.float64)),
                                         rel=1e-9)


@pytest.mark.gpu
def test_cuda_generator_checkpoint_round_trip(cuda, tmp_path):
    """A train state on the card through `CheckpointManager`: parameters,
    Adam moments, codebook buffers and the CUDA generator's state come back
    bit for bit onto the card, Adam's step counters on the host, and the
    restored generator draws the stream the original draws next."""
    from medical_image_editing_tpu_torch.models import UNetDecoder
    from medical_image_editing_tpu_torch.models.blocks import seeded_init
    from medical_image_editing_tpu_torch.models.unet_encoder import EncoderWithVQ
    from medical_image_editing_tpu_torch.train import state as tstate
    from medical_image_editing_tpu_torch.utils.checkpoint import CheckpointManager

    def make(seed):
        gen = torch.Generator().manual_seed(seed)
        enc = seeded_init(EncoderWithVQ(1, (4, 8, 8, 16, 16), 6, knn_backend="pallas"), gen)
        dec = seeded_init(UNetDecoder(4, 1, (8, 8, 16, 16, 32), dropped_skip_layers=(),
                                      use_pixel_shuffle=False), gen)
        enc, dec = enc.to(cuda), dec.to(cuda)
        return tstate.create_train_state(enc, dec, tstate.make_optimizer(enc.parameters(), 1e-3),
                                         tstate.make_optimizer(dec.parameters(), 1e-3),
                                         seed=seed, device=cuda)

    state = make(1)
    for opt, module in ((state.enc_opt, state.encoder), (state.dec_opt, state.decoder)):
        for p in module.parameters():
            p.grad = torch.randn(p.shape, generator=state.generator, device=cuda)
        opt.step()
    state.step, state.epoch = 5, 2
    assert state.generator.device.type == "cuda"
    CheckpointManager(str(tmp_path)).save(state, epoch=2)
    fresh = make(9)
    CheckpointManager(str(tmp_path)).restore(fresh)
    for part in ("encoder", "decoder"):
        a, b = getattr(state, part).state_dict(), getattr(fresh, part).state_dict()
        assert all(b[k].device.type == "cuda" and torch.equal(a[k], b[k]) for k in a)
    for opt_a, opt_b in ((state.enc_opt, fresh.enc_opt), (state.dec_opt, fresh.dec_opt)):
        for pa, pb in zip(opt_a.param_groups[0]["params"], opt_b.param_groups[0]["params"]):
            sa, sb = opt_a.state[pa], opt_b.state[pb]
            assert torch.equal(sa["exp_avg"], sb["exp_avg"]) and sb["exp_avg"].is_cuda
            assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
            assert sb["step"].device.type == "cpu" and float(sa["step"]) == float(sb["step"])
    assert (fresh.step, fresh.epoch) == (5, 2)
    assert torch.equal(torch.rand(1000, generator=state.generator, device=cuda),
                       torch.rand(1000, generator=fresh.generator, device=cuda))


def _second_stage_state(device, seed=0, dtype=None, axis_name=None):
    """A small second-stage state: encoder (4, 32, 8, 16, 16) (3 routed
    convs at 32²), decoder (32, 8, 8, 16, 16) (10), f32 (or the compute
    `dtype`), the U-Net discriminator (f32) at D_ch 4 and resolution 128,
    the lung config's Adams; the encoder and decoder built with
    `axis_name`."""
    from medical_image_editing_tpu_torch.models import UNetDecoder, UNetDiscriminator
    from medical_image_editing_tpu_torch.models.blocks import seeded_init
    from medical_image_editing_tpu_torch.models.unet_encoder import EncoderWithVQ
    from medical_image_editing_tpu_torch.train import state as tstate

    gen = torch.Generator().manual_seed(seed)
    enc = seeded_init(EncoderWithVQ(1, (4, 32, 8, 16, 16), 6, knn_backend="pallas",
                                    dtype=dtype, axis_name=axis_name), gen)
    dec = seeded_init(UNetDecoder(4, 1, (32, 8, 8, 16, 16), dropped_skip_layers=(),
                                  use_pixel_shuffle=False, dtype=dtype,
                                  axis_name=axis_name), gen)
    dis = UNetDiscriminator(D_ch=4, D_attn="0", resolution=128).init_weights(gen)
    enc, dec, dis = enc.to(device), dec.to(device), dis.to(device)
    return tstate.create_train_state(
        enc, dec, tstate.make_optimizer(enc.parameters(), 1e-4),
        tstate.make_optimizer(dec.parameters(), 1e-4), seed=seed, device=device,
        discriminator=dis, dis_opt=tstate.make_optimizer(dis.parameters(), 4e-4, b1=0.5))


def _second_stage_step(state, device):
    from medical_image_editing_tpu_torch.train import second_stage as tss

    cfg = tss.SecondStageLossConfig(w_recon=10.0, w_unet_perceptual=1.0)
    return tss.make_second_stage_step(state.encoder, state.decoder, state.discriminator,
                                      loss_cfg=cfg, device=device)


# Fault C.8: the card's gradients in the step tests below are held to a
# float64 CPU witness of the same step on the card's own ids
# (`utils/witness.py`, as `chip_smoke.py`'s card-vs-CPU parts hold theirs):
# within 5× the larger of the two CPU float32 steps' distances from it
# (oneDNN's convolutions, PyTorch's native ones), or 1e-4 (the tests'
# former minimum), and never above a cap. Each cap is 10× the largest of
# those two CPU distances over seeds 0, 1 and 2 of the test's data
# (`tools/witness_caps.py`, which builds the data with the `_*_case`
# functions below; seed 0 is the test's own), rounded up to two digits:
# twice the largest limit any seed gives, a fixed number that nothing in a
# run moves. Largest readings (x86 CPU, PyTorch 2.13): second stage decoder
# 2.34e-3, discriminator 2.21e-6; joint encoder 9.70e-2, decoder 4.63e-3,
# discriminator 9.45e-5; VQGAN decoder 2.30e-6, discriminator 3.32e-6; first
# stage with the VGG encoder 0.128, decoder 3.69e-3. The encoders' gradients
# at random init are ill-conditioned: 6-13% between a float32 step and its
# witness on the same ids. The card's other conv route and the card without
# cuDNN stay, as readouts.
WITNESS_MINIMUM = 1e-4
WITNESS_CAP = {
    "second_stage": {"decoder": 2.4e-2, "discriminator": 2.3e-5},
    "joint": {"encoder": 0.97, "decoder": 4.7e-2, "discriminator": 9.5e-4},
    "vqgan": {"decoder": 2.3e-5, "discriminator": 3.4e-5},
    "first_stage": {"encoder": 1.3, "decoder": 3.7e-2},
}


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _recorded_step(state, parts, step):
    """Run `step()` → (metrics, grads) with the run's VQ ids: the record
    `_witness_failures` takes."""
    with recorded_vq_ids() as seen:
        _, metrics = step()
    return SimpleNamespace(m={k: float(v) for k, v in metrics.items()},
                           grads=first_moments(state, parts), vq_ids=seen)


def _case(parts, fresh):
    """A step test's case: `parts` ((module, optimizer) field names) and
    `fresh(device, witness=False)` → (state, run), a new state and the
    call that runs its step on the test's data (with `witness`, the
    state's modules in float64, for the witness's step), and
    `witness(ids_calls)`, the float64 CPU witness of that step on the
    given ids (`utils/witness.py`: the conv route xla, the step inside
    `float64_step`) → its first moments."""
    def witness(ids_calls):
        state, run = fresh("cpu", witness=True)
        with pytest.MonkeyPatch.context() as mp, float64_step(ids_calls):
            mp.setenv("MEDIMG_CONV_IMPL", "xla")
            run()
        return first_moments(state, parts)

    return SimpleNamespace(parts=parts, fresh=fresh, witness=witness)


def cpu_witness_gaps(case):
    """The CPU's two float32 steps of `case` (oneDNN's convolutions and
    PyTorch's native ones, the packed route, which the CPU takes as its
    plain version), each against the float64 witness of its own ids →
    {"cpu": {module: distance}, "cpu_native": {...}}: the floor of
    `witness_limits`."""
    out = {}
    for name, mkldnn in (("cpu", True), ("cpu_native", False)):
        with pytest.MonkeyPatch.context() as mp, torch.backends.mkldnn.flags(enabled=mkldnn):
            mp.setenv("MEDIMG_CONV_IMPL", "packed")
            state, run = case.fresh("cpu")
            out[name] = _recorded_step(state, case.parts, run)
    return witness_gaps(out, case.witness, case.parts)[0]


def _witness_failures(test, out, case):
    """The card's gradients against the float64 witness of its own ids
    (fault C.8): the modules past their limit, as (module, distance,
    limit). Prints the record: each run's distance from the witness, the
    floor and limits, and as readouts the perturbed runs' distances from
    the run they perturb (a `card_` run from the card's, `cpu_floor` from
    the CPU's)."""
    parts = case.parts
    gaps, n = witness_gaps({k: out[k] for k in ("cpu", "cpu_native", "card")}, case.witness,
                           parts)
    floor, limit = witness_limits(gaps, WITNESS_MINIMUM, WITNESS_CAP[test])
    readouts = {name: {m: _rel(o.grads[m], out["card" if name.startswith("card") else "cpu"]
                                .grads[m]) for m, _ in parts}
                for name, o in out.items() if name not in ("cpu", "cpu_native", "card")}
    print(json.dumps({"test": test, "grad_rel_err_vs_f64": gaps, "grad_floor": floor,
                      "grad_limit": limit, "witnesses": n, "readouts": readouts,
                      "card_vs_cpu": {m: _rel(out["card"].grads[m], out["cpu"].grads[m])
                                      for m, _ in parts}}))
    return [(m, gaps["card"][m], limit[m]) for m in limit if gaps["card"][m] > limit[m]]


def _second_stage_case(seed=0):
    """The second-stage step test's data (seed 0; other seeds for
    `tools/witness_caps.py`): 32², batch 2, the codebook from a CPU
    k-means, one CutMix draw."""
    from medical_image_editing_tpu_torch.train import first_stage as tfs
    from medical_image_editing_tpu_torch.train import second_stage as tss

    x = np.random.default_rng(8 + seed).uniform(-1, 1, size=(2, 32, 32, 1)).astype(np.float32)
    draws = tss.sample_cutmix_draws(torch.Generator().manual_seed(3 + seed), 1, 32, 32)
    cpu_state = _second_stage_state("cpu", seed=seed)
    tfs.init_codebook_step(cpu_state.encoder)(cpu_state, x)
    codebook = {k: v.clone() for k, v in cpu_state.encoder.state_dict().items()}

    def fresh(device, witness=False):
        state = _second_stage_state(device, seed=seed)
        state.encoder.load_state_dict(codebook)
        if witness:
            to_float64(state.encoder, state.decoder, state.discriminator)
        on = [(tuple(tuple(v.to(device) for v in p) for p in box), inv.to(device))
              for box, inv in draws]
        return state, lambda: _second_stage_step(state, device)(state, x, draws=on)

    return _case((("decoder", "dec_opt"), ("discriminator", "dis_opt")), fresh)


@pytest.mark.gpu
def test_second_stage_step_on_card_matches_cpu(cuda, monkeypatch):
    """One second-stage step (f32) on the CPU and on the card, from the
    same weights, codebook and CutMix draws, packed route: the launches
    derived from the model (the frozen encoder's 3 routed convs forward,
    the decoder's 10 forward and dx; one assignment), the losses (rtol
    1e-3), and the gradients read from Adam's first moment against the
    float64 witness of the card's own ids (fault C.8, `_witness_failures`).
    The card on the xla route is a readout."""
    case = _second_stage_case()
    out = {}
    for name, device, route, mkldnn in (("cpu", "cpu", "packed", True),
                                        ("cpu_native", "cpu", "packed", False),
                                        ("card", cuda, "packed", True),
                                        ("card_xla", cuda, "xla", True)):
        monkeypatch.setenv("MEDIMG_CONV_IMPL", route)
        state, run = case.fresh(device)
        _build.launches.clear()
        with torch.backends.mkldnn.flags(enabled=mkldnn):
            out[name] = _recorded_step(state, case.parts, run)
        if name == "card":
            torch.cuda.synchronize()
            assert dict(_build.launches) == {tcp.KERNEL: 3 + 2 * 10,
                                             tcp.LAUNCH_KEYS["f32"]: 3 + 2 * 10,
                                             tvqf.KERNEL: 1}
    m_cpu, m_card = out["cpu"].m, out["card"].m
    for k, v in m_cpu.items():
        assert abs(m_card[k] - v) <= 1e-3 * abs(v) + 1e-6, (k, m_card[k], v)
    bad = _witness_failures("second_stage", out, case)
    assert not bad, bad


@pytest.mark.gpu
def test_second_stage_resume_on_card(cuda, monkeypatch, tmp_path):
    """4 steps straight against 2 steps, a save, a restore into a fresh
    state and 2 more, on the card: the CutMix stream (the CUDA generator),
    the frozen encoder and codebook and the counters bit for bit; the
    decoder's and discriminator's parameters no further apart than two
    straight runs are (the card's f32 weight gradients may sum in any order)."""
    from medical_image_editing_tpu_torch.utils.checkpoint import CheckpointManager

    monkeypatch.setenv("MEDIMG_CONV_IMPL", "packed")
    x = np.random.default_rng(9).uniform(-1, 1, size=(2, 32, 32, 1)).astype(np.float32)

    def run(n, state=None):
        state = state or _second_stage_state(cuda)
        step = _second_stage_step(state, cuda)
        for _ in range(n):
            state, _ = step(state, x)
        return state

    a, a2 = run(4), run(4)
    b = run(2)
    CheckpointManager(str(tmp_path)).save(b, epoch=0, step=2)
    fresh = _second_stage_state(cuda, seed=5)
    CheckpointManager(str(tmp_path)).restore(fresh)
    b = run(2, fresh)
    assert b.step == a.step == 4
    assert torch.equal(b.generator.get_state(), a.generator.get_state())
    assert all(torch.equal(v, b.encoder.state_dict()[k]) for k, v in a.encoder.state_dict().items())

    def gap(x, y):
        return max(float((p - q).abs().max()) for m in ("decoder", "discriminator")
                   for p, q in zip(getattr(x, m).state_dict().values(),
                                   getattr(y, m).state_dict().values()))

    floor = gap(a, a2)
    assert gap(a, b) <= 5 * floor, (gap(a, b), floor)


# the first stage's terms that an id flipped at a near tie inside the step
# moves (through the other view's warped ids, or the reconstruction): held
# to rtol 1e-2, as `chip_smoke.py`'s card-vs-CPU steps hold them
ID_MOVED_LOSSES = ("cross", "dist", "recon", "freq", "total", "gen_total")


def _routed_convs(module, x):
    """How many convolutions a forward of `module` on x (B,H,W,C) sends to
    the packed kernel, counted on the meta device."""
    import copy

    from medical_image_editing_tpu_torch.models.blocks import Conv

    count = [0]
    meta = copy.deepcopy(module).to("meta")
    for m in meta.modules():
        if isinstance(m, Conv):
            m.register_forward_pre_hook(
                lambda m, args: count.__setitem__(0, count[0] + int(m.routes_to_kernel(args[0]))))
    with torch.no_grad():
        meta(torch.zeros(x.shape, device="meta").permute(0, 3, 1, 2))
    return count[0]


def _joint_step(state, device, dtype=torch.float32, use_remat=False):
    from medical_image_editing_tpu_torch.train import first_stage as tfs
    from medical_image_editing_tpu_torch.train import multi_window as tmw
    from medical_image_editing_tpu_torch.train import second_stage as tss

    aug = {"modules": ["RandomHorizontalFlip", "RandomAffine", "RandomGaussianNoise"],
           "RandomHorizontalFlip": {"p": 0.5},
           "RandomAffine": {"degrees": 10.0, "translate": [0.05, 0.05], "p": 0.8},
           "RandomGaussianNoise": {"std": 0.05, "p": 0.5}}
    return tmw.make_joint_step(state.encoder, state.decoder, state.discriminator,
                               first_cfg=tfs.FirstStageLossConfig(w_recon=10.0, w_reg=0.01),
                               second_cfg=tss.SecondStageLossConfig(use_unet_perceptual_loss=False),
                               aug_cfg=aug, dict_size=6, dataset_window=(4096.0, 0.0, 2.0),
                               compute_dtype=dtype, use_remat=use_remat, device=device), aug


def _joint_case(seed=0):
    """The joint step test's data (seed 0; other seeds for
    `tools/witness_caps.py`): 64², batch 2, the codebook from a CPU
    k-means, two views' draws and three CutMix draws."""
    from medical_image_editing_tpu_torch.ops.augment import sample_view_draws
    from medical_image_editing_tpu_torch.train import first_stage as tfs
    from medical_image_editing_tpu_torch.train import second_stage as tss

    size = 64
    x = np.random.default_rng(8 + seed).uniform(-1, 1, size=(2, size, size, 1)).astype(np.float32)
    cpu_state = _second_stage_state("cpu", seed=seed)
    tfs.init_codebook_step(cpu_state.encoder)(cpu_state, x)
    start = {m: {k: v.clone() for k, v in getattr(cpu_state, m).state_dict().items()}
             for m in ("encoder", "decoder", "discriminator")}
    _, aug = _joint_step(cpu_state, "cpu")
    gen = torch.Generator().manual_seed(3 + seed)
    views = [sample_view_draws(gen, aug, 2, size, size) for _ in range(2)]
    cut = tss.sample_cutmix_draws(gen, 3, size, size)

    def fresh(device, witness=False):
        state = _second_stage_state(device, seed=seed)
        for m, sd in start.items():
            getattr(state, m).load_state_dict(sd)
        on = [{part: [None if d is None else {k: None if v is None else v.to(device)
                                              for k, v in d.items()} for d in ds]
               for part, ds in view.items()} for view in views]
        on.append([(tuple(tuple(v.to(device) for v in p) for p in box), inv.to(device))
                   for box, inv in cut])
        if witness:
            to_float64(state.encoder, state.decoder, state.discriminator)
        step, _ = _joint_step(state, device, dtype=torch.float64 if witness else torch.float32)
        return state, lambda: step(state, x, draws=tuple(on))

    case = _case((("encoder", "enc_opt"), ("decoder", "dec_opt"),
                  ("discriminator", "dis_opt")), fresh)
    case.x = x
    return case


@pytest.mark.gpu
def test_joint_step_on_card_matches_cpu(cuda, monkeypatch):
    """One multi-window joint step (f32, 64², batch 2) on the CPU and on the
    card from the same weights, codebook and draws: the packed route's
    launches derived from the model (per view every routed conv of encoder
    and decoder, forward and dx; one assignment per view); the ids each
    view quantizes to, equal on both; the losses (rtol 1e-3; 1e-2 for
    `ID_MOVED_LOSSES`); the gradients of encoder, decoder and discriminator
    read from Adam's first moment against the float64 witness of the
    card's own ids (fault C.8, `_witness_failures`). Readouts: the card's other
    conv route, and the CPU step perturbed at the rounding level (native
    convolutions, one-ulp noise on the quantized features). An id that
    flips at a near tie inside the step moves the gradients far more than
    rounding: at 128² one of 32,768 flipped and moved the decoder's by 13%
    (measured), so the ids are held equal first and the size is one at
    which none flips."""
    from medical_image_editing_tpu_torch.train import first_stage as tfs

    case = _joint_case()
    x, real = case.x, tfs.encode_quantize
    out, ids = {}, {}
    for name, device, route in (("cpu", "cpu", "packed"), ("cpu_native", "cpu", "packed"),
                                ("cpu_floor", "cpu", "packed"), ("card", cuda, "packed"),
                                ("card_xla", cuda, "xla")):
        monkeypatch.setenv("MEDIMG_CONV_IMPL", route)
        ids[name], noise = [], torch.Generator().manual_seed(0)

        def recorded(*args, **kw):
            q, commit, idx, vq = real(*args, **kw)
            ids[name].append(idx.detach().cpu())
            if name == "cpu_floor":
                up = torch.randint(0, 2, q.shape, generator=noise).bool()
                moved = torch.where(up, torch.nextafter(q, q + 1), torch.nextafter(q, q - 1))
                q = q + (moved - q).detach()
            return q, commit, idx, vq

        monkeypatch.setattr(tfs, "encode_quantize", recorded)
        state, run = case.fresh(device)
        _build.launches.clear()
        with torch.backends.mkldnn.flags(enabled=name not in ("cpu_native", "cpu_floor")):
            out[name] = _recorded_step(state, case.parts, run)
        if name == "card":
            torch.cuda.synchronize()
            n = _routed_convs(state.encoder, x) + _routed_convs(
                state.decoder, np.zeros((*x.shape[:3], 4), np.float32))
            assert dict(_build.launches) == {tcp.KERNEL: 4 * n, tcp.LAUNCH_KEYS["f32"]: 4 * n,
                                             tvqf.KERNEL: 2}
    monkeypatch.setattr(tfs, "encode_quantize", real)
    assert [int((a != b).sum()) for a, b in zip(ids["card"], ids["cpu"])] == [0, 0]
    m_cpu, m_card = out["cpu"].m, out["card"].m
    bad = []
    for k, v in m_cpu.items():
        rtol = 1e-2 if k in ID_MOVED_LOSSES else 1e-3
        if abs(m_card[k] - v) > rtol * abs(v) + 1e-6:
            bad.append((k, m_card[k], v))
    bad += _witness_failures("joint", out, case)
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("use_remat", [False, True])
def test_joint_step_goes_through_both_kernels(cuda, monkeypatch, use_remat):
    """A bf16 joint step on the card: 4 × (3 + 10) conv launches (both views,
    forward and dx) and 2 VQ launches, the discriminator's convolutions on
    cuDNN; with `use_remat` the same launches and finite losses."""
    monkeypatch.setenv("MEDIMG_CONV_IMPL", "packed")
    state = _second_stage_state(cuda, dtype=torch.bfloat16)
    step, _ = _joint_step(state, cuda, dtype=torch.bfloat16, use_remat=use_remat)
    x = np.random.default_rng(7).uniform(-1, 1, size=(2, 32, 32, 1)).astype(np.float32)
    _build.launches.clear()
    state, metrics = step(state, x)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {tcp.KERNEL: 4 * (3 + 10),
                                     tcp.LAUNCH_KEYS["bf16"]: 4 * (3 + 10), tvqf.KERNEL: 2}
    assert all(torch.isfinite(v) for v in metrics.values())


def _vqgan_state(device, seed=0):
    """A small VQGAN state: `mid_channels` 8, multipliers (1, 2, 4), one res
    block a level, decoder attention at 16², a 12 × 32 codebook (the VQ
    kernel's generic instance), f32; the U-Net discriminator at D_ch 4 and
    resolution 128; the VQGAN config's Adams."""
    from medical_image_editing_tpu_torch.models import UNetDiscriminator, VQGAN
    from medical_image_editing_tpu_torch.models.blocks import seeded_init
    from medical_image_editing_tpu_torch.train import state as tstate

    gen = torch.Generator().manual_seed(seed)
    vqgan = seeded_init(VQGAN(mid_channels=8, emb_dim=32, dict_size=12,
                              enc_ch_multiplier=(1, 2, 4), dec_ch_multiplier=(1, 2, 4),
                              num_res_blocks=1, dec_attn_resolutions=(16,), resolution=64,
                              knn_backend="pallas"), gen).to(device)
    dis = UNetDiscriminator(D_ch=4, D_attn="0", resolution=128).init_weights(gen).to(device)
    return tstate.create_train_state(
        None, vqgan, None, tstate.make_optimizer(vqgan.parameters(), 1e-4), seed=seed,
        device=device, discriminator=dis,
        dis_opt=tstate.make_optimizer(dis.parameters(), 4e-4, b1=0.5))


def _vqgan_case(seed=0):
    """The VQGAN step test's data (seed 0; other seeds for
    `tools/witness_caps.py`): 64², batch 2, one CutMix draw."""
    from medical_image_editing_tpu_torch.train import second_stage as tss
    from medical_image_editing_tpu_torch.train import vqgan_stage as tvs

    x = np.random.default_rng(8 + seed).uniform(-1, 1, size=(2, 64, 64, 1)).astype(np.float32)
    draws = tss.sample_cutmix_draws(torch.Generator().manual_seed(3 + seed), 1, 64, 64)
    cfg = tss.SecondStageLossConfig(w_recon=10.0, w_unet_perceptual=1.0)

    def fresh(device, witness=False):
        state = _vqgan_state(device, seed=seed)
        on = [(tuple(tuple(v.to(device) for v in p) for p in box), inv.to(device))
              for box, inv in draws]
        step = tvs.make_vqgan_step(state.decoder, state.discriminator, loss_cfg=cfg,
                                   device=device)
        if witness:
            to_float64(state.decoder, state.discriminator)
        return state, lambda: step(state, x, draws=on)

    return _case((("decoder", "dec_opt"), ("discriminator", "dis_opt")), fresh)


@pytest.mark.gpu
def test_vqgan_step_on_card_matches_cpu(cuda, monkeypatch):
    """One VQGAN step (f32, 64², batch 2) on the CPU and on the card, from
    the same weights and CutMix draws, under `MEDIMG_CONV_IMPL=packed`: on
    the card the VQ kernel's generic instance launches once and the conv
    kernel never (the VQGAN's and the discriminator's convolutions are
    cuDNN's); the losses (rtol 1e-3) and the codebook after the step (rtol
    1e-3); the gradients read from Adam's first moment against the float64
    witness of the card's own ids (fault C.8, `_witness_failures`). The
    card without cuDNN is a readout."""
    monkeypatch.setenv("MEDIMG_CONV_IMPL", "packed")
    assert tvqf.kernel_path(32, 12) == "generic"
    case = _vqgan_case()
    out, vq = {}, {}
    for name, device, use_cudnn, mkldnn in (("cpu", "cpu", True, True),
                                            ("cpu_native", "cpu", True, False),
                                            ("card", cuda, True, True),
                                            ("card_no_cudnn", cuda, False, True)):
        state, run = case.fresh(device)
        _build.launches.clear()
        monkeypatch.setattr(torch.backends.cudnn, "enabled", use_cudnn)
        with torch.backends.mkldnn.flags(enabled=mkldnn):
            out[name] = _recorded_step(state, case.parts, run)
        if name == "card":
            torch.cuda.synchronize()
            assert dict(_build.launches) == {tvqf.KERNEL: 1}
        vq[name] = [t.cpu() for t in state.vq]
    monkeypatch.setattr(torch.backends.cudnn, "enabled", True)
    m_cpu, m_card = out["cpu"].m, out["card"].m
    for k, v in m_cpu.items():
        assert abs(m_card[k] - v) <= 1e-3 * abs(v) + 1e-6, (k, m_card[k], v)
    for a, b in zip(vq["card"], vq["cpu"]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()) + 1e-6
    bad = _witness_failures("vqgan", out, case)
    assert not bad, bad


@pytest.mark.gpu
def test_actnorm_on_card_matches_cpu(cuda):
    """The PatchGAN with ActNorm on the card against the CPU: two train-mode
    forwards that share one backward (the first initialises each ActNorm),
    an eval forward, the captured statistics and the weight gradients; and
    ActNorm's reverse and logdet."""
    from medical_image_editing_tpu_torch.models import ActNorm, NLayerDiscriminator

    gen = torch.Generator().manual_seed(4)
    x1, x2 = (torch.randn(2, 1, 64, 64, generator=gen) for _ in range(2))
    cpu = NLayerDiscriminator(n_filters=8, n_layers=2, normalization="actnorm",
                              apply_spectral_norm=True).init_weights(gen)
    card = copy.deepcopy(cpu).to(cuda)
    outs = {}
    for name, m, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        m.train()
        loss = m(x1.to(dev)).pow(2).mean() + m(x2.to(dev)).pow(2).mean()
        loss.backward()
        with torch.no_grad():
            ev = m.eval()(x1.to(dev))
        outs[name] = (ev.cpu(), {k: v.detach().cpu() for k, v in m.state_dict().items()},
                      {k: p.grad.cpu() for k, p in m.named_parameters()})
    (ev_cpu, sd_cpu, g_cpu), (ev_card, sd_card, g_card) = outs["cpu"], outs["card"]
    assert torch.allclose(ev_card, ev_cpu, rtol=1e-4, atol=1e-5)
    for k in sd_cpu:
        if k.endswith(("data_loc", "data_scale", "initialized")):
            assert torch.allclose(sd_card[k].float(), sd_cpu[k].float(), rtol=1e-4, atol=1e-5), k
    for k, g in g_cpu.items():
        assert float((g_card[k] - g).norm()) <= 1e-3 * float(g.norm()) + 1e-7, k
    an = ActNorm(8, logdet=True).to(cuda)
    y = torch.randn(3, 8, 5, 5, device=cuda) * 2 + 1
    h, ld = an(y)
    assert torch.allclose(an.eval()(h, reverse=True), y, rtol=1e-4, atol=1e-4)
    assert torch.allclose(ld, 25 * torch.log(an.data_scale.abs()).sum().expand(3))


def _moved(tree, device):
    """Draws (tensors in nested dicts, lists and tuples) on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_moved(v, device) for v in tree)
    return tree


def _switched_first_stage(device, perceptual=True, dropblock=True, seed=0, witness=False):
    """A small f32 first stage (encoder (4, 32, 8, 16, 16): 3 routed convs
    at 32²; decoder (32, 8, 8, 16, 16): 10) with DropBlock (block 7) and
    its step with the VGG loss (the seeded fallback, weight 1); with
    `witness`, the models and the VGG in float64 and the step computing in
    float64 (the float64 witness's step, run inside `float64_step`)."""
    import warnings

    from medical_image_editing_tpu_torch.models import UNetDecoder
    from medical_image_editing_tpu_torch.models.blocks import seeded_init
    from medical_image_editing_tpu_torch.models.unet_encoder import EncoderWithVQ
    from medical_image_editing_tpu_torch.ops.perceptual import make_vgg_loss
    from medical_image_editing_tpu_torch.train import first_stage as tfs
    from medical_image_editing_tpu_torch.train import state as tstate

    gen = torch.Generator().manual_seed(seed)
    enc = seeded_init(EncoderWithVQ(1, (4, 32, 8, 16, 16), 6, knn_backend="pallas"), gen)
    dec = seeded_init(UNetDecoder(4, 1, (32, 8, 8, 16, 16), use_dropblock=dropblock,
                                  block_size=7, dropped_skip_layers=(),
                                  use_pixel_shuffle=False), gen)
    enc, dec = enc.to(device), dec.to(device)
    state = tstate.create_train_state(enc, dec, tstate.make_optimizer(enc.parameters(), 1e-4),
                                      tstate.make_optimizer(dec.parameters(), 1e-4),
                                      seed=seed, device=device)
    vgg = None
    if perceptual:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            vgg = make_vgg_loss("22", device=device)
    if witness:
        to_float64(enc, dec, *([vgg] if vgg is not None else []))
    cfg = tfs.FirstStageLossConfig(w_recon=10.0, w_perceptual=1.0,
                                   use_perceptual_loss=perceptual)
    step = tfs.make_first_stage_step(enc, dec, loss_cfg=cfg, aug_cfg=_AUG, dict_size=6,
                                     compute_dtype=torch.float64 if witness else torch.float32,
                                     device=device, perceptual_fn=vgg)
    return state, step


_AUG = {"modules": ["RandomHorizontalFlip", "RandomAffine", "RandomGaussianNoise"],
        "RandomHorizontalFlip": {"p": 0.5},
        "RandomAffine": {"degrees": 10.0, "translate": [0.05, 0.05], "p": 0.8},
        "RandomGaussianNoise": {"std": 0.05, "p": 0.5}}


def _first_stage_case(seed=0):
    """The first-stage step test's data (seed 0; other seeds for
    `tools/witness_caps.py`): 32², batch 2, the codebook from a CPU
    k-means, two views' draws, DropBlock's draws and drop_prob 0.5."""
    from medical_image_editing_tpu_torch.ops.augment import sample_view_draws
    from medical_image_editing_tpu_torch.train import first_stage as tfs

    x = np.random.default_rng(9 + seed).uniform(-1, 1, size=(2, 32, 32, 1)).astype(np.float32)
    cpu_state, _ = _switched_first_stage("cpu", seed=seed)
    gen = torch.Generator().manual_seed(4 + seed)
    views = tuple(sample_view_draws(gen, _AUG, 2, 32, 32) for _ in range(2))
    db = tfs.view_dropblock_draws(gen, cpu_state.decoder, 2, 32, 32)
    tfs.init_codebook_step(cpu_state.encoder)(cpu_state, x)
    start = {m: {k: v.clone() for k, v in getattr(cpu_state, m).state_dict().items()}
             for m in ("encoder", "decoder")}

    def fresh(device, witness=False):
        state, step = _switched_first_stage(device, seed=seed, witness=witness)
        for m in start:
            getattr(state, m).load_state_dict(start[m])
        return state, lambda: step(state, x, _moved(views, device), 0.5, _moved(db, device))

    return _case((("encoder", "enc_opt"), ("decoder", "dec_opt")), fresh)


@pytest.mark.gpu
def test_first_stage_step_with_vgg_and_dropblock_on_card_matches_cpu(cuda, monkeypatch):
    """One first-stage step (f32, TF32 off) with the VGG loss and DropBlock
    on the CPU and on the card, from the same weights, codebook, view
    draws, DropBlock draws and drop_prob 0.5, packed route: the launches
    are those of the step without either part (3 + 10 routed convs forward
    and dx for both views, two assignments), the losses rtol 1e-3 (1e-2
    for cross, dist and total: an id at a near tie moves the cross loss by
    ~1/(pixels of its code)), and the gradients read from Adam's first
    moment against the float64 witness of the card's own ids (fault C.8,
    `_witness_failures`; the VGG in float64 too). Readouts: the card's
    other conv route and the card with cuDNN off (the VGG's f32
    convolutions are cuDNN's, FFT among them, on every route)."""
    case = _first_stage_case()
    out = {}
    for name, device, route, mkldnn in (("cpu", "cpu", "packed", True),
                                        ("cpu_native", "cpu", "packed", False),
                                        ("card", cuda, "packed", True),
                                        ("card_xla", cuda, "xla", True),
                                        ("card_native", cuda, "packed", True)):
        monkeypatch.setenv("MEDIMG_CONV_IMPL", route)
        state, run = case.fresh(device)
        _build.launches.clear()
        prev = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = name != "card_native"
        try:
            with torch.backends.mkldnn.flags(enabled=mkldnn):
                out[name] = _recorded_step(state, case.parts, run)
        finally:
            torch.backends.cudnn.enabled = prev
        if name == "card":
            torch.cuda.synchronize()
            assert dict(_build.launches) == {tcp.KERNEL: 4 * (3 + 10),
                                             tcp.LAUNCH_KEYS["f32"]: 4 * (3 + 10), tvqf.KERNEL: 2}
    m_cpu, m_card = out["cpu"].m, out["card"].m
    assert m_cpu["perceptual"] > 0
    for k, v in m_cpu.items():
        rtol = 1e-2 if k in ("cross", "dist", "total") else 1e-3
        assert abs(m_card[k] - v) <= rtol * abs(v) + 1e-6, (k, m_card[k], v)
    bad = _witness_failures("first_stage", out, case)
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("perceptual,dropblock", [(False, False), (True, False),
                                                  (False, True), (True, True)],
                         ids=["off", "vgg", "dropblock", "both"])
def test_switches_add_no_kernel_launch(cuda, monkeypatch, perceptual, dropblock):
    """The VGG loss's convolutions are cuDNN's (never the packed route) and
    DropBlock is a max-pool and two elementwise passes: a first-stage step
    launches the kernels as often with either on as with both off."""
    monkeypatch.setenv("MEDIMG_CONV_IMPL", "packed")
    state, step = _switched_first_stage(cuda, perceptual=perceptual, dropblock=dropblock)
    x = np.random.default_rng(10).uniform(-1, 1, size=(2, 32, 32, 1)).astype(np.float32)
    _build.launches.clear()
    _, metrics = step(state, x, drop_prob=0.5)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {tcp.KERNEL: 4 * (3 + 10),
                                     tcp.LAUNCH_KEYS["f32"]: 4 * (3 + 10), tvqf.KERNEL: 2}
    assert all(torch.isfinite(v) for v in metrics.values())
    assert (float(metrics["perceptual"]) > 0) == perceptual


@pytest.mark.gpu
def test_volumetric_step_on_card_matches_cpu(cuda):
    """One f32 volumetric step (filters 8,16,32,64, `dict_size` 10, 16³,
    batch 2) on the CPU and on the card from the same seeded weights, held
    as `chip_smoke.py`'s volumetric reference part holds it (its
    `volumetric_reference_part`, which raises on a fault): the ids where
    the top-2 score gap is clear, the losses and the codebook after the
    step (rtol 1e-3), the gradients against a float64 step on the CPU
    within 5× the CPU's own float32 distance from it, or 1e-5. No
    hand-written kernel launches: the path runs the plain VQ assignment and
    cuDNN's conv3d."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _build.launches.clear()
    smoke.volumetric_reference_part(size=16, batch=2, seed=4, card=cuda.type, norm_size=16)
    assert not any(_build.launches.values()), dict(_build.launches)


# (b, cin, cout, h, w, kernel, dilation, bias, compute dtype): the lung
# decoder's kinds of convolution at ragged sizes, through every instance
# (`conv_s8_instance`): conv_s8_kernel with BN 32 (Cout 32 and 1), 64 (Cout
# 40 and 64) and 128 (Cout 96 and 256), and conv_s8_kernel_rows (W a
# multiple of 64, 3×3, Cin past 32) with BN 32, 64 and 128. H, W not
# multiples of the 128-pixel tile, Cin 16 (the codebook embedding), 160
# (the ASPP concat) and 256 (a Cin >= 128 shape), dilation 18 on 32² (most
# taps past the image) and on 512-wide rows (the ASPP's; the row kernel's
# segments of 100), batch 33, and a bf16 compute dtype (bf16 out) on three
# instances.
S8_SHAPES = [
    (2, 32, 32, 37, 45, 3, 1, True, torch.float32),
    (2, 16, 32, 33, 31, 1, 1, False, torch.float32),
    (3, 32, 1, 29, 35, 1, 1, True, torch.float32),
    (2, 160, 40, 20, 21, 3, 1, True, torch.float32),
    (2, 32, 32, 32, 32, 3, 18, False, torch.float32),
    (2, 32, 32, 32, 32, 3, 6, False, torch.float32),
    (33, 32, 32, 16, 16, 3, 2, False, torch.float32),
    (2, 64, 96, 17, 19, 3, 1, True, torch.bfloat16),
    (2, 256, 256, 18, 18, 3, 1, True, torch.float32),
    (3, 128, 64, 20, 24, 3, 1, False, torch.bfloat16),
    (3, 160, 32, 7, 64, 3, 1, True, torch.float32),
    (1, 32, 32, 20, 512, 3, 18, False, torch.float32),
    (1, 64, 32, 6, 512, 3, 18, False, torch.float32),
    (1, 64, 64, 9, 128, 3, 2, False, torch.bfloat16),
    (2, 256, 256, 5, 64, 3, 1, True, torch.float32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", S8_SHAPES, ids=lambda s: "x".join(map(str, s[:7])) + (
    "-bias" if s[7] else "") + ("-bf16" if s[8] == torch.bfloat16 else ""))
def test_conv_s8_kernels_match_plain(cuda, shape):
    """Each of the four int8 kernels against its plain version on the
    card, bit for bit: the channel maxima, the weight fold (codes, k_scale
    and x_scale against the plain `weight_codes`), the s8 codes (NHWC,
    zero-padded to 32 channels), the raw int32 sums and the dequantized
    output (f32, or bf16 from a bf16 input under a bf16 compute dtype); the
    whole call against `int8_conv_reference`; each launch counted."""
    b, cin, cout, h, w, k, d, use_bias, dtype = shape
    inst = tqc.conv_s8_instance(cout, tqc.padded_channels(cin), k, k, d, w)
    assert inst[0] == (1 if k == 3 and w % 64 == 0 and cin > 32 else 0)
    rng = np.random.default_rng(cin * 7 + cout)
    x = torch.from_numpy(rng.normal(size=(b, cin, h, w)).astype(np.float32)).to(cuda, dtype)
    wt = torch.from_numpy(rng.normal(size=(cout, cin, k, k)).astype(np.float32)).to(cuda)
    bias = (torch.from_numpy(rng.normal(size=cout).astype(np.float32)).to(cuda)
            if use_bias else None)
    pad = d if k == 3 else 0
    geo = dict(kernel_size=(k, k), dilation=(d, d), padding=(pad, pad))
    _build.launches.clear()
    amax = tqc.channel_absmax(x)
    assert torch.equal(amax, tqc.channel_absmax_reference(x))
    wq, k_scale, scale = tqc.conv_s8_weights(wt, amax)
    plain_scale = tqc.symmetric_scale(amax)
    plain_wq, plain_k_scale = tqc.weight_codes(wt, plain_scale)
    assert torch.equal(scale, plain_scale) and torch.equal(wq, plain_wq)
    assert torch.equal(k_scale, plain_k_scale)
    xq = tqc.quantize_s8(x, scale)
    assert torch.equal(xq, tqc.quantize_s8_reference(x, scale))
    acc = tqc.conv_s8(xq, wq, None, None, out_dtype=torch.int32, **geo)
    assert torch.equal(acc, tqc.conv_s8_reference(xq, wq, None, None, out_dtype=torch.int32,
                                                  **geo))
    out = tqc.conv_s8(xq, wq, k_scale, bias, out_dtype=dtype, **geo)
    want = tqc.conv_s8_reference(xq, wq, k_scale, bias, out_dtype=dtype, **geo)
    assert out.dtype == dtype and torch.equal(out, want)
    whole = tqc.int8_conv(x, wt, bias, padding=pad, dilation=d, out_dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(whole, tqc.int8_conv_reference(x, wt, bias, padding=pad, dilation=d,
                                                      out_dtype=dtype))
    assert dict(_build.launches) == {tqc.ABSMAX: 2, tqc.WEIGHTS: 2, tqc.QUANTIZE: 2,
                                     tqc.KERNEL: 3}


@pytest.mark.gpu
def test_conv_s8_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(1, 4, 8, 8, device=cuda)
    with pytest.raises(TypeError):
        tqc.channel_absmax(x.half())
    with pytest.raises(ValueError):
        tqc.int8_conv(x, torch.zeros(2, 4, 3, 3, device=cuda), stride=2, padding=1)
    xq = torch.zeros(1, 8, 8, 32, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):  # weights padded to another width
        tqc.conv_s8(xq, torch.zeros(9, 2, 64, dtype=torch.int8, device=cuda),
                    torch.ones(2, device=cuda), None, kernel_size=(3, 3), dilation=(1, 1),
                    padding=(1, 1))


@pytest.mark.gpu
def test_int8_decode_goes_through_the_kernels(cuda, monkeypatch):
    """`make_batched_edit_fn(quantize="int8")` on the card launches each
    kernel once a `Conv` of the decoder per chunk (counted from the module)
    and decodes bit for bit what the same decode through the plain versions
    on the card decodes, with and without microbatching."""
    from medical_image_editing_tpu_torch.cli.edit_batch import make_batched_edit_fn
    from medical_image_editing_tpu_torch.models import blocks
    from medical_image_editing_tpu_torch.models.blocks import Conv, seeded_init
    from medical_image_editing_tpu_torch.models.unet_decoder import UNetDecoder
    from medical_image_editing_tpu_torch.ops.vq import VQState

    dec = seeded_init(UNetDecoder(in_channels=16, filters=(8, 16, 32, 64, 128),
                                  use_pixel_shuffle=False, dropped_skip_layers=()),
                      torch.Generator().manual_seed(0))
    n_convs = sum(isinstance(m, Conv) for m in dec.modules())
    rng = np.random.default_rng(3)
    embed = torch.from_numpy(rng.normal(size=(10, 16)).astype(np.float32))
    vq = VQState(embed, torch.ones(10), embed.clone())
    ids = rng.integers(0, 11, size=(4, 64, 64)).astype(np.int32)
    for micro in (None, 2):
        edit = make_batched_edit_fn(dec, is_lung=True, quantize="int8", microbatch=micro,
                                    device=cuda)
        _build.launches.clear()
        got = edit(vq, ids)
        torch.cuda.synchronize()
        chunks = 1 if micro is None else 2
        assert dict(_build.launches) == {k: n_convs * chunks for k in
                                         (tqc.KERNEL, tqc.ABSMAX, tqc.WEIGHTS, tqc.QUANTIZE)}
        with monkeypatch.context() as m:
            m.setattr(blocks, "int8_conv", tqc.int8_conv_reference)
            want = edit(vq, ids)
        assert torch.equal(got, want)
        assert torch.isfinite(got).all()


@pytest.mark.gpu
def test_one_rank_nccl_group_is_bit_identical_to_no_group(cuda, monkeypatch):
    """`initialize_distributed` from a one-rank torchrun environment makes
    an NCCL group; `pmean` and the synced batch norm (forward, running
    stats, input and parameter gradients) through it equal the same calls
    with no group, bit for bit."""
    import torch.distributed as dist

    from medical_image_editing_tpu_torch.models.blocks import FlaxBatchNorm
    from medical_image_editing_tpu_torch.parallel import mesh

    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
            for s in ((3, 4), (7,)))
    x = torch.from_numpy(rng.normal(size=(4, 6, 9, 9)).astype(np.float32)).to(cuda)

    def run():
        bn = FlaxBatchNorm(6, axis_name=mesh.DATA_AXIS).to(cuda)
        xx = x.clone().requires_grad_()
        y = bn(xx)
        (y * y).mean().backward()
        return [*mesh.pmean([a, b]), y.detach(), bn.running_mean, bn.running_var,
                xx.grad, bn.weight.grad, bn.bias.grad]

    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT="0").items():
        monkeypatch.setenv(k, v)
    assert mesh.initialize_distributed("cuda")
    try:
        assert dist.get_backend() == "nccl" and mesh.world() == (0, 1)
        mesh.collectives.clear()
        grouped = run()
        torch.cuda.synchronize()
        assert mesh.collectives["all_reduce"] == 3  # pmean, the norm forward and backward
    finally:
        mesh.destroy_distributed()
    alone = run()
    for got, want in zip(grouped, alone):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_one_rank_nccl_group_second_stage_step_is_bit_identical(cuda, monkeypatch):
    """The data-parallel second stage (ROADMAP 15(ii)): the k-means and one
    step (f32, the packed route; the SPADE BatchNorms synced, the decoder's
    and the discriminator's gradients, the discriminator's buffers and the
    metrics averaged) under a one-rank NCCL group equal the same with no
    group, bit for bit: state, Adam states, generator and metrics. cuDNN
    runs its deterministic algorithms, without which two runs of one f32
    step differ on the card at all."""
    import torch.distributed as dist

    from medical_image_editing_tpu_torch.parallel import mesh
    from medical_image_editing_tpu_torch.train import first_stage as tfs
    from medical_image_editing_tpu_torch.train import second_stage as tss

    monkeypatch.setenv("MEDIMG_CONV_IMPL", "packed")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    x = np.random.default_rng(8).uniform(-1, 1, size=(2, 32, 32, 1)).astype(np.float32)
    draws = [(tuple(tuple(v.to(cuda) for v in p) for p in box), inv.to(cuda))
             for box, inv in tss.sample_cutmix_draws(torch.Generator().manual_seed(3), 1,
                                                     32, 32)]

    def run():
        state = _second_stage_state(cuda, axis_name=mesh.DATA_AXIS)
        tfs.init_codebook_step(state.encoder)(state, x)
        step = tss.make_second_stage_step(
            state.encoder, state.decoder, state.discriminator,
            loss_cfg=tss.SecondStageLossConfig(w_recon=10.0, w_unet_perceptual=1.0),
            device=cuda, axis_name=mesh.DATA_AXIS)
        mesh.collectives.clear()
        state, metrics = step(state, x, draws=draws)
        torch.cuda.synchronize()
        return state.state_dict(), metrics, dict(mesh.collectives)

    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT="0").items():
        monkeypatch.setenv(k, v)
    assert mesh.initialize_distributed("cuda")
    try:
        assert dist.get_backend() == "nccl"
        grouped = run()
    finally:
        mesh.destroy_distributed()
    alone = run()
    # 8 SPADE BatchNorms forward and backward, the decoder's gradients, one
    # inner iteration's, the discriminator's buffers, the metrics
    assert grouped[2]["all_reduce"] == 2 * 8 + 4 and alone[2] == {}

    def equal(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                equal(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            for i, (u, v) in enumerate(zip(a, b)):
                equal(u, v, f"{path}/{i}")
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), path
        else:
            assert a == b, path

    equal(grouped[0], alone[0])
    equal(grouped[1], alone[1])
