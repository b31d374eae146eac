"""Tests of the PyTorch port that need a CUDA card: each hand-written kernel
against its plain PyTorch version, the encode path through the VQ kernel,
and a training step through both kernels.

They skip on a host without a card. This file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py
"""

import copy

import numpy as np
import pytest
import torch

from medical_image_editing_tpu_torch.ops import _build
from medical_image_editing_tpu_torch.ops import conv_pack as tcp
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
    assert dict(_build.launches) == {tcp.KERNEL: 3}
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


def _second_stage_state(device, seed=0, dtype=None):
    """A small second-stage state: encoder (4, 32, 8, 16, 16) (3 routed
    convs at 32²), decoder (32, 8, 8, 16, 16) (10), f32 (or the compute
    `dtype`), the U-Net discriminator (f32) at D_ch 4 and resolution 128,
    the lung config's Adams."""
    from medical_image_editing_tpu_torch.models import UNetDecoder, UNetDiscriminator
    from medical_image_editing_tpu_torch.models.blocks import seeded_init
    from medical_image_editing_tpu_torch.models.unet_encoder import EncoderWithVQ
    from medical_image_editing_tpu_torch.train import state as tstate

    gen = torch.Generator().manual_seed(seed)
    enc = seeded_init(EncoderWithVQ(1, (4, 32, 8, 16, 16), 6, knn_backend="pallas",
                                    dtype=dtype), gen)
    dec = seeded_init(UNetDecoder(4, 1, (32, 8, 8, 16, 16), dropped_skip_layers=(),
                                  use_pixel_shuffle=False, dtype=dtype), gen)
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


@pytest.mark.gpu
def test_second_stage_step_on_card_matches_cpu(cuda, monkeypatch):
    """One second-stage step (f32) on the CPU and on the card, on both
    conv routes, from the same weights, codebook and CutMix draws: the
    packed route's launches derived from the model (the frozen encoder's 3
    routed convs forward, the decoder's 10 forward and dx; one
    assignment), the losses (rtol 1e-3), and the gradients read from
    Adam's first moment within 5× the card's own floor (its two routes
    against each other) or 1e-4, as `chip_smoke.py`'s second-stage
    reference part holds them."""
    from medical_image_editing_tpu_torch.train import first_stage as tfs
    from medical_image_editing_tpu_torch.train import second_stage as tss

    x = np.random.default_rng(8).uniform(-1, 1, size=(2, 32, 32, 1)).astype(np.float32)
    draws = tss.sample_cutmix_draws(torch.Generator().manual_seed(3), 1, 32, 32)
    out = {}
    cpu_state = _second_stage_state("cpu")
    tfs.init_codebook_step(cpu_state.encoder)(cpu_state, x)
    codebook = {k: v.clone() for k, v in cpu_state.encoder.state_dict().items()}
    for name, device, route in (("cpu", "cpu", "packed"), ("card", cuda, "packed"),
                                ("card_xla", cuda, "xla")):
        monkeypatch.setenv("MEDIMG_CONV_IMPL", route)
        state = cpu_state if name == "cpu" else _second_stage_state(device)
        state.encoder.load_state_dict(codebook)
        on = [(tuple(tuple(v.to(device) for v in p) for p in box), inv.to(device))
              for box, inv in draws]
        _build.launches.clear()
        _, metrics = _second_stage_step(state, device)(state, x, draws=on)
        if name == "card":
            torch.cuda.synchronize()
            assert dict(_build.launches) == {tcp.KERNEL: 3 + 2 * 10, tvqf.KERNEL: 1}
        grads = {m: torch.cat([o.state[p]["exp_avg"].flatten().cpu()
                               for p in getattr(state, m).parameters()])
                 for m, o in (("decoder", state.dec_opt), ("discriminator", state.dis_opt))}
        out[name] = ({k: float(v) for k, v in metrics.items()}, grads)
    (m_cpu, g_cpu), (m_card, g_card), (_, g_xla) = out["cpu"], out["card"], out["card_xla"]
    for k, v in m_cpu.items():
        assert abs(m_card[k] - v) <= 1e-3 * abs(v) + 1e-6, (k, m_card[k], v)
    for m in g_cpu:
        floor = float((g_xla[m] - g_card[m]).norm() / g_card[m].norm())
        err = float((g_card[m] - g_cpu[m]).norm() / g_cpu[m].norm())
        assert err <= max(5 * floor, 1e-4), (m, err, floor)


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


@pytest.mark.gpu
def test_joint_step_on_card_matches_cpu(cuda, monkeypatch):
    """One multi-window joint step (f32, 64², batch 2) on the CPU and on the
    card from the same weights, codebook and draws: the packed route's
    launches derived from the model (per view every routed conv of encoder
    and decoder, forward and dx; one assignment per view); the ids each
    view quantizes to, equal on both; the losses (rtol 1e-3; 1e-2 for
    `ID_MOVED_LOSSES`); the gradients of encoder, decoder and discriminator
    read from Adam's first moment within 5× the floor or 1e-4, the floor
    the larger of the card's two conv routes against each other and the
    CPU step against itself perturbed at the rounding level (native
    convolutions, one-ulp noise on the quantized features, as the CPU tests
    perturb it). An id that flips at a near tie inside the step moves the
    gradients far more than rounding: at 128² one of 32,768 flipped and
    moved the decoder's by 13% (measured), so the ids are held equal first
    and the size is one at which none flips."""
    from medical_image_editing_tpu_torch.ops.augment import sample_view_draws
    from medical_image_editing_tpu_torch.train import first_stage as tfs
    from medical_image_editing_tpu_torch.train import second_stage as tss

    size = 64
    x = np.random.default_rng(8).uniform(-1, 1, size=(2, size, size, 1)).astype(np.float32)
    cpu_state = _second_stage_state("cpu")
    tfs.init_codebook_step(cpu_state.encoder)(cpu_state, x)
    start = {m: {k: v.clone() for k, v in getattr(cpu_state, m).state_dict().items()}
             for m in ("encoder", "decoder", "discriminator")}
    _, aug = _joint_step(cpu_state, "cpu")
    gen = torch.Generator().manual_seed(3)
    views = [sample_view_draws(gen, aug, 2, size, size) for _ in range(2)]
    cut = tss.sample_cutmix_draws(gen, 3, size, size)
    real = tfs.encode_quantize
    out = {}
    for name, device, route in (("cpu", "cpu", "packed"), ("cpu_floor", "cpu", "packed"),
                                ("card", cuda, "packed"), ("card_xla", cuda, "xla")):
        monkeypatch.setenv("MEDIMG_CONV_IMPL", route)
        ids, noise = [], torch.Generator().manual_seed(0)

        def recorded(*args, **kw):
            q, commit, idx, vq = real(*args, **kw)
            ids.append(idx.detach().cpu())
            if name == "cpu_floor":
                up = torch.randint(0, 2, q.shape, generator=noise).bool()
                moved = torch.where(up, torch.nextafter(q, q + 1), torch.nextafter(q, q - 1))
                q = q + (moved - q).detach()
            return q, commit, idx, vq

        monkeypatch.setattr(tfs, "encode_quantize", recorded)
        state = _second_stage_state(device)
        for m, sd in start.items():
            getattr(state, m).load_state_dict(sd)
        on = [{part: [None if d is None else {k: None if v is None else v.to(device)
                                              for k, v in d.items()} for d in ds]
               for part, ds in view.items()} for view in views]
        on.append([(tuple(tuple(v.to(device) for v in p) for p in box), inv.to(device))
                   for box, inv in cut])
        _build.launches.clear()
        step, _ = _joint_step(state, device)
        with torch.backends.mkldnn.flags(enabled=name != "cpu_floor"):
            _, metrics = step(state, x, draws=tuple(on))
        if name == "card":
            torch.cuda.synchronize()
            n = _routed_convs(state.encoder, x) + _routed_convs(
                state.decoder, np.zeros((2, size, size, 4), np.float32))
            assert dict(_build.launches) == {tcp.KERNEL: 4 * n, tvqf.KERNEL: 2}
        grads = {m: torch.cat([o.state[p]["exp_avg"].flatten().cpu()
                               for p in getattr(state, m).parameters()])
                 for m, o in (("encoder", state.enc_opt), ("decoder", state.dec_opt),
                              ("discriminator", state.dis_opt))}
        out[name] = ({k: float(v) for k, v in metrics.items()}, grads, ids)
    monkeypatch.setattr(tfs, "encode_quantize", real)
    (m_cpu, g_cpu, ids_cpu), (m_card, g_card, ids_card) = out["cpu"], out["card"]
    assert [int((a != b).sum()) for a, b in zip(ids_card, ids_cpu)] == [0, 0]

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    bad = []
    for k, v in m_cpu.items():
        rtol = 1e-2 if k in ID_MOVED_LOSSES else 1e-3
        if abs(m_card[k] - v) > rtol * abs(v) + 1e-6:
            bad.append((k, m_card[k], v))
    for m in g_cpu:
        floor = max(rel(out["card_xla"][1][m], g_card[m]), rel(out["cpu_floor"][1][m], g_cpu[m]))
        err = rel(g_card[m], g_cpu[m])
        if err > max(5 * floor, 1e-4):
            bad.append((m, err, floor))
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
    assert dict(_build.launches) == {tcp.KERNEL: 4 * (3 + 10), tvqf.KERNEL: 2}
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


@pytest.mark.gpu
def test_vqgan_step_on_card_matches_cpu(cuda, monkeypatch):
    """One VQGAN step (f32, 64², batch 2) on the CPU and on the card, from
    the same weights and CutMix draws, under `MEDIMG_CONV_IMPL=packed`: on
    the card the VQ kernel's generic instance launches once and the conv
    kernel never (the VQGAN's and the discriminator's convolutions are
    cuDNN's); the losses (rtol 1e-3) and the codebook after the step (rtol
    1e-3); the gradients read from Adam's first moment within 5× the
    card's own floor (the card again without cuDNN) or 1e-4, as
    `chip_smoke.py`'s VQGAN reference part holds them."""
    from medical_image_editing_tpu_torch.train import second_stage as tss
    from medical_image_editing_tpu_torch.train import vqgan_stage as tvs

    monkeypatch.setenv("MEDIMG_CONV_IMPL", "packed")
    assert tvqf.kernel_path(32, 12) == "generic"
    x = np.random.default_rng(8).uniform(-1, 1, size=(2, 64, 64, 1)).astype(np.float32)
    draws = tss.sample_cutmix_draws(torch.Generator().manual_seed(3), 1, 64, 64)
    cfg = tss.SecondStageLossConfig(w_recon=10.0, w_unet_perceptual=1.0)
    out = {}
    for name, device, use_cudnn in (("cpu", "cpu", True), ("card", cuda, True),
                                    ("card_no_cudnn", cuda, False)):
        state = _vqgan_state(device)
        on = [(tuple(tuple(v.to(device) for v in p) for p in box), inv.to(device))
              for box, inv in draws]
        step = tvs.make_vqgan_step(state.decoder, state.discriminator, loss_cfg=cfg,
                                   device=device)
        _build.launches.clear()
        monkeypatch.setattr(torch.backends.cudnn, "enabled", use_cudnn)
        _, metrics = step(state, x, draws=on)
        if name == "card":
            torch.cuda.synchronize()
            assert dict(_build.launches) == {tvqf.KERNEL: 1}
        grads = {m: torch.cat([o.state[p]["exp_avg"].flatten().cpu()
                               for p in getattr(state, m).parameters()])
                 for m, o in (("decoder", state.dec_opt), ("discriminator", state.dis_opt))}
        out[name] = ({k: float(v) for k, v in metrics.items()}, grads,
                     [t.cpu() for t in state.vq])
    (m_cpu, g_cpu, vq_cpu), (m_card, g_card, vq_card) = out["cpu"], out["card"]
    for k, v in m_cpu.items():
        assert abs(m_card[k] - v) <= 1e-3 * abs(v) + 1e-6, (k, m_card[k], v)
    for a, b in zip(vq_card, vq_cpu):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()) + 1e-6
    for m in g_cpu:
        floor = float((out["card_no_cudnn"][1][m] - g_card[m]).norm() / g_card[m].norm())
        err = float((g_card[m] - g_cpu[m]).norm() / g_cpu[m].norm())
        assert err <= max(5 * floor, 1e-4), (m, err, floor)


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


def _switched_first_stage(device, perceptual=True, dropblock=True, seed=0):
    """A small f32 first stage (encoder (4, 32, 8, 16, 16): 3 routed convs
    at 32²; decoder (32, 8, 8, 16, 16): 10) with DropBlock (block 7) and
    its step with the VGG loss (the seeded fallback, weight 1)."""
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
    cfg = tfs.FirstStageLossConfig(w_recon=10.0, w_perceptual=1.0,
                                   use_perceptual_loss=perceptual)
    step = tfs.make_first_stage_step(enc, dec, loss_cfg=cfg, aug_cfg=_AUG, dict_size=6,
                                     device=device, perceptual_fn=vgg)
    return state, step


_AUG = {"modules": ["RandomHorizontalFlip", "RandomAffine", "RandomGaussianNoise"],
        "RandomHorizontalFlip": {"p": 0.5},
        "RandomAffine": {"degrees": 10.0, "translate": [0.05, 0.05], "p": 0.8},
        "RandomGaussianNoise": {"std": 0.05, "p": 0.5}}


@pytest.mark.gpu
def test_first_stage_step_with_vgg_and_dropblock_on_card_matches_cpu(cuda, monkeypatch):
    """One first-stage step (f32, TF32 off) with the VGG loss and DropBlock
    on the CPU and on the card, on both conv routes, from the same weights,
    codebook, view draws, DropBlock draws and drop_prob 0.5: the packed
    route's launches are those of the step without either part (3 + 10
    routed convs forward and dx for both views, two assignments), the
    losses rtol 1e-3 (1e-2 for cross, dist and total: an id at a near tie
    moves the cross loss by ~1/(pixels of its code)), and the gradients
    read from Adam's first moment within 5× the card's own floor or 1e-4:
    the larger of its two routes against each other and of cuDNN against
    the card's native convolutions (the VGG's f32 convolutions are
    cuDNN's, FFT among them, on every route, and the decoder's own cuDNN
    convolutions change algorithm with the library off)."""
    from medical_image_editing_tpu_torch.ops.augment import sample_view_draws
    from medical_image_editing_tpu_torch.train import first_stage as tfs

    x = np.random.default_rng(9).uniform(-1, 1, size=(2, 32, 32, 1)).astype(np.float32)
    cpu_state, _ = _switched_first_stage("cpu")
    gen = torch.Generator().manual_seed(4)
    views = tuple(sample_view_draws(gen, _AUG, 2, 32, 32) for _ in range(2))
    db = tfs.view_dropblock_draws(gen, cpu_state.decoder, 2, 32, 32)
    tfs.init_codebook_step(cpu_state.encoder)(cpu_state, x)
    start = {m: {k: v.clone() for k, v in getattr(cpu_state, m).state_dict().items()}
             for m in ("encoder", "decoder")}
    out = {}
    for name, device, route in (("cpu", "cpu", "packed"), ("card", cuda, "packed"),
                                ("card_xla", cuda, "xla"), ("card_native", cuda, "packed")):
        monkeypatch.setenv("MEDIMG_CONV_IMPL", route)
        state, step = _switched_first_stage(device)
        for m in start:
            getattr(state, m).load_state_dict(start[m])
        _build.launches.clear()
        prev = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = name != "card_native"
        try:
            _, metrics = step(state, x, _moved(views, device), 0.5, _moved(db, device))
        finally:
            torch.backends.cudnn.enabled = prev
        if name == "card":
            torch.cuda.synchronize()
            assert dict(_build.launches) == {tcp.KERNEL: 4 * (3 + 10), tvqf.KERNEL: 2}
        grads = {m: torch.cat([o.state[p]["exp_avg"].flatten().cpu()
                               for p in getattr(state, m).parameters()])
                 for m, o in (("encoder", state.enc_opt), ("decoder", state.dec_opt))}
        out[name] = ({k: float(v) for k, v in metrics.items()}, grads)
    (m_cpu, g_cpu), (m_card, g_card) = out["cpu"], out["card"]
    assert m_cpu["perceptual"] > 0
    for k, v in m_cpu.items():
        rtol = 1e-2 if k in ("cross", "dist", "total") else 1e-3
        assert abs(m_card[k] - v) <= rtol * abs(v) + 1e-6, (k, m_card[k], v)
    for m in g_cpu:
        floor = max(float((out[other][1][m] - g_card[m]).norm() / g_card[m].norm())
                    for other in ("card_xla", "card_native"))
        err = float((g_card[m] - g_cpu[m]).norm() / g_cpu[m].norm())
        assert err <= max(5 * floor, 1e-4), (m, err, floor)


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
    assert dict(_build.launches) == {tcp.KERNEL: 4 * (3 + 10), tvqf.KERNEL: 2}
    assert all(torch.isfinite(v) for v in metrics.values())
    assert (float(metrics["perceptual"]) > 0) == perceptual
