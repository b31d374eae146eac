"""The int8 serving decode of the PyTorch port against the JAX package, on
the CPU: `ops/quantized_conv.py` per convolution against JAX's
`quantize_convs("int8")` on a flax `nn.Conv`, `make_batched_edit_fn(
quantize="int8")` against JAX's on its own test's toy decoder, JAX's 4×
bf16 accuracy contract held on the port's decode, the decode at the lung
decoder's full widths against JAX's, microbatching, the context manager,
`edit_batch.main --dtype int8`, and a numpy emulation of
`csrc/conv_s8.cu`'s index and fragment arithmetic (the kernel itself runs
only on the card: `tests/test_torch_port_gpu.py`).

Tolerances: per convolution the codes are equal (or every mismatch sits
within one ulp of a .5 tie) and the outputs within rtol 1e-6 and atol 1e-6:
both sides sum the same integer codes exactly and dequantize in two f32
roundings. A whole decode holds 1e-4 (×4096/1500 where lung-windowed): the
instance norms and the f32 convolutions around the int8 ones sum in other
orders on the two sides, and a code that sits on a tie may round apart.
"""

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.cli import edit_batch as jeb
from medical_image_editing_tpu.models import UNetDecoder as JUNetDecoder
from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ as JEncoderWithVQ
from medical_image_editing_tpu.ops.quantized_conv import quantize_convs as jquantize_convs
from medical_image_editing_tpu_torch.cli import edit_batch as teb
from medical_image_editing_tpu_torch.models.blocks import Conv
from medical_image_editing_tpu_torch.models.unet_decoder import UNetDecoder
from medical_image_editing_tpu_torch.ops import _build
from medical_image_editing_tpu_torch.ops import quantized_conv as tqc
from medical_image_editing_tpu_torch.ops.vq import VQState
from medical_image_editing_tpu_torch.utils import nifti as tnifti
from medical_image_editing_tpu_torch.utils.weights import from_jax_decoder

K, S, F = 5, 32, (4, 8, 16, 32, 64)  # tests/test_quantized_conv.py's toy decoder
ATOL = 1e-4
LUNG_ATOL = 1e-4 * 4096 / 1500

# (cin, cout, kernel, dilation, bias): 3×3 with bias, 1×1 without, the
# ASPP's dilations 6 and 18, Cin 16 (the embedding) and 160 (the ASPP
# concat), Cout 1 (conv1x1)
CONVS = [(8, 16, 3, 1, True), (16, 8, 1, 1, False), (8, 8, 3, 6, False),
         (8, 8, 3, 18, False), (160, 32, 3, 1, True), (32, 1, 1, 1, True),
         (16, 32, 3, 1, False)]


def _jax_conv(cin, cout, k, d, bias, x):
    pad = [(d, d)] * 2 if k == 3 else [(0, 0)] * 2
    conv = nn.Conv(cout, (k, k), padding=pad, use_bias=bias, kernel_dilation=(d, d))
    variables = conv.init(jax.random.key(cin + cout), jnp.asarray(x))
    return conv, variables


def _jax_codes(x_nhwc, kernel):
    """The JAX package's activation and weight codes (its `_quantize_sym`)."""
    from medical_image_editing_tpu.ops.quantized_conv import _quantize_sym

    xq, x_scale = _quantize_sym(jnp.asarray(x_nhwc), axes=(0, 1, 2))
    k_fold = jnp.asarray(kernel) * x_scale.reshape(1, 1, -1, 1)
    kq, k_scale = _quantize_sym(k_fold, axes=(0, 1, 2))
    return (np.asarray(xq), np.asarray(x_scale).reshape(-1), np.asarray(kq),
            np.asarray(k_fold), np.asarray(k_scale).reshape(-1))


def _near_tie(value, scale):
    """|value / scale| within one ulp of a .5 tie."""
    r = np.abs(value.astype(np.float64) / scale.astype(np.float64))
    return np.abs(r - np.floor(r) - 0.5) <= 2 * np.spacing(r.astype(np.float32))


@pytest.mark.parametrize("cin,cout,k,d,bias", CONVS,
                         ids=[f"{c[0]}-{c[1]}-k{c[2]}-d{c[3]}{'-bias' if c[4] else ''}"
                              for c in CONVS])
def test_int8_conv_matches_jax(cin, cout, k, d, bias):
    """Codes equal (or on a tie), output within rtol/atol 1e-6."""
    rng = np.random.default_rng(cin * 31 + cout + d)
    size = 32 if d == 18 else 16
    x = rng.normal(size=(2, size, size, cin)).astype(np.float32)
    conv, variables = _jax_conv(cin, cout, k, d, bias, x)
    with jquantize_convs("int8"):
        want = np.asarray(conv.apply(variables, jnp.asarray(x)))
    kernel = np.asarray(variables["params"]["kernel"])
    w = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    b = torch.from_numpy(np.asarray(variables["params"]["bias"])) if bias else None
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    jxq, jx_scale, jkq, jk_fold, jk_scale = _jax_codes(x, kernel)
    x_scale = tqc.symmetric_scale(tqc.channel_absmax(xt))
    np.testing.assert_array_equal(x_scale.numpy(), jx_scale)
    xq = tqc.quantize_s8(xt, x_scale)
    assert xq.shape == (2, size, size, tqc.padded_channels(cin))
    assert not xq[..., cin:].any()
    diff = xq[..., :cin].numpy() != jxq
    assert _near_tie(x[diff], np.broadcast_to(jx_scale, x.shape)[diff]).all()
    wq, k_scale = tqc.weight_codes(w, x_scale)
    np.testing.assert_array_equal(k_scale.numpy(), jk_scale)
    kq = wq[..., :cin].reshape(k, k, cout, cin).permute(0, 1, 3, 2).numpy()  # HWIO
    diff = kq != jkq
    assert _near_tie(jk_fold[diff], np.broadcast_to(jk_scale, jk_fold.shape)[diff]).all()

    got = tqc.int8_conv(xt, w, b, padding=d if k == 3 else 0, dilation=d)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)
    ref = tqc.int8_conv_reference(xt, w, b, padding=d if k == 3 else 0, dilation=d)
    assert torch.equal(got, ref)


def test_quantize_convs_none_is_noop_and_unknown_raises():
    """None runs the module's own convolution; "int4" raises; the mode is
    the calling thread's alone and restored on exit."""
    import threading

    conv = Conv(2, 4, 3, padding=1)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 2, 8, 8)).astype(np.float32))
    ref = conv(x)
    with tqc.quantize_convs(None):
        assert torch.equal(conv(x), ref)
    with pytest.raises(ValueError, match="int4"):
        with tqc.quantize_convs("int4"):
            pass
    with pytest.raises(ValueError, match="int4"):
        teb.make_batched_edit_fn(UNetDecoder(in_channels=4, filters=F), quantize="int4",
                                 device="cpu")
    seen = []
    with tqc.quantize_convs("int8"):
        assert tqc.quantize_mode() == "int8"
        q = conv(x)
        t = threading.Thread(target=lambda: seen.append(tqc.quantize_mode()))
        t.start()
        t.join()
    assert seen == [None] and tqc.quantize_mode() is None
    assert not torch.equal(q, ref)
    assert torch.equal(q, tqc.int8_conv_reference(x, conv.weight, conv.bias, padding=1))


@pytest.fixture(scope="module")
def toy():
    """The JAX test's toy decoder (K 5, 32², filters 4-64, ASPP head, no
    pixel shuffle), its f32 and bf16 JAX modules, and the port's copy of
    its weights."""
    enc = JEncoderWithVQ(filters=F, dict_size=K, momentum=0.99)
    kw = dict(out_channels=1, filters=F, dropped_skip_layers=(), use_pixel_shuffle=False)
    jdec, jdec16 = JUNetDecoder(**kw), JUNetDecoder(**kw, dtype=jnp.bfloat16)
    x0 = jnp.zeros((1, S, S, 1), jnp.float32)
    enc_vars, vq = enc.init(jax.random.key(0), x0)
    q0, *_ = enc(enc_vars, vq, x0, train=False)
    dec_vars = jax.jit(lambda q: jdec.init({"params": jax.random.key(1),
                                            "dropblock": jax.random.key(2)}, q,
                                           train=False))(q0)
    kw_t = dict(in_channels=F[0], out_channels=1, filters=F, dropped_skip_layers=(),
                use_pixel_shuffle=False)
    dec = UNetDecoder(**kw_t)
    dec.load_state_dict(from_jax_decoder(dec_vars), strict=True)
    dec16 = UNetDecoder(**kw_t, dtype=torch.bfloat16)
    dec16.load_state_dict(from_jax_decoder(dec_vars), strict=True)
    tvq = VQState(*(torch.from_numpy(np.asarray(a)) for a in vq))
    return dict(jdec=jdec, jdec16=jdec16, dec_vars=dec_vars, vq=vq, dec=dec, dec16=dec16,
                tvq=tvq)


def _ids(seed, b=2):
    return np.random.default_rng(seed).integers(0, K + 1, size=(b, S, S)).astype(np.int32)


def _jax_decode(toy, ids, quantize=None, microbatch=None, is_lung=False):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jeb.make_batched_edit_fn(
            toy["jdec"], quantize=quantize, microbatch=microbatch, is_lung=is_lung)(
                toy["dec_vars"], toy["vq"], jnp.asarray(ids)))


@pytest.mark.parametrize("is_lung", [False, True], ids=["raw", "lung"])
def test_int8_decode_matches_jax(toy, is_lung):
    """The port's int8 decode against JAX's on the same weights and ids,
    within ATOL (×4096/1500 lung-windowed); the plain kernels' stand-ins
    ran, so no kernel launched."""
    ids = _ids(1)
    want = _jax_decode(toy, ids, quantize="int8", is_lung=is_lung)
    _build.launches.clear()
    got = teb.make_batched_edit_fn(toy["dec"], quantize="int8", is_lung=is_lung,
                                   device="cpu")(toy["tvq"], ids).numpy()
    assert not _build.launches
    np.testing.assert_allclose(got, want, atol=LUNG_ATOL if is_lung else ATOL, rtol=0)


def test_int8_decode_microbatch_matches_jax(toy):
    """microbatch=2 on batch 4: the activation scales are taken per chunk,
    as JAX's `lax.scan` takes them."""
    ids = _ids(2, b=4)
    want = _jax_decode(toy, ids, quantize="int8", microbatch=2)
    got = teb.make_batched_edit_fn(toy["dec"], quantize="int8", microbatch=2,
                                   device="cpu")(toy["tvq"], ids).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    whole = teb.make_batched_edit_fn(toy["dec"], quantize="int8", device="cpu")(
        toy["tvq"], ids).numpy()
    np.testing.assert_allclose(got[:2], teb.make_batched_edit_fn(
        toy["dec"], quantize="int8", device="cpu")(toy["tvq"], ids[:2]).numpy(), atol=0,
        rtol=0)
    assert not np.array_equal(got, whole)


def test_int8_decode_error_vs_bf16_contract(toy):
    """JAX's contract (`tests/test_quantized_conv.py::
    test_int8_edit_decode_error_vs_bf16_default`) held on the port's own
    decodes: int8's mean and p99 error against f32 at most 4× bf16's, with
    its absolute backstops (mean < 0.08, p99 < 0.35). Seeded random weights
    are the worst case for both reduced precisions."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, K + 1, size=(2, S, S)).astype(np.int32)
    r32 = teb.make_batched_edit_fn(toy["dec"], device="cpu")(toy["tvq"], ids).numpy()
    r16 = teb.make_batched_edit_fn(toy["dec16"], device="cpu")(toy["tvq"], ids).float().numpy()
    r8 = teb.make_batched_edit_fn(toy["dec"], quantize="int8", device="cpu")(
        toy["tvq"], ids).numpy()
    e16, e8 = np.abs(r16 - r32), np.abs(r8 - r32)
    assert e8.mean() < 4.0 * max(e16.mean(), 1e-4), (e8.mean(), e16.mean())
    assert np.percentile(e8, 99) < 4.0 * max(np.percentile(e16, 99), 1e-3)
    assert e8.mean() < 0.08, e8.mean()
    assert np.percentile(e8, 99) < 0.35, np.percentile(e8, 99)
    assert e8.mean() > 0  # the int8 path ran


def test_int8_decode_at_full_widths_follows_jax():
    """The lung decoder at full widths (dec 32-512, ASPP head) on 64² maps,
    f32, bf16 and int8 on both sides from the same weights. f32 within
    1e-4. int8 and bf16 round, so an ulp of difference in an activation
    can flip a code or a bf16 value and the decoders' instance norms carry
    it on: the port's int8 decode is held to JAX's in the mean (2e-3,
    measured 7.5e-4; the port's bf16 decode sits 5.3e-4 from JAX's), and
    the int8-to-bf16 error ratio against f32, the quantity of JAX's 4×
    contract, to within a third of JAX's own ratio (measured 2.6 and 3.0)."""
    from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ

    f, size, k = (32, 64, 128, 256, 512), 64, 10
    _, vq = EncoderWithVQ(filters=(16, 32, 64, 128, 256), dict_size=k).init(
        jax.random.key(0), jnp.zeros((1, size, size, 1)))
    kw = dict(out_channels=1, filters=f, dropped_skip_layers=(), use_pixel_shuffle=False)
    jdec, jdec16 = JUNetDecoder(**kw), JUNetDecoder(**kw, dtype=jnp.bfloat16)
    dec_vars = jax.jit(lambda q: jdec.init({"params": jax.random.key(1),
                                            "dropblock": jax.random.key(2)}, q,
                                           train=False))(jnp.zeros((1, size, size, 16)))
    ids = np.random.default_rng(0).integers(0, k + 1, (2, size, size)).astype(np.int32)
    tvq = VQState(*(torch.from_numpy(np.array(a)) for a in vq))
    got, want = {}, {}
    for name, jd, dtype, quantize in (("f32", jdec, None, None), ("bf16", jdec16,
                                                                  torch.bfloat16, None),
                                      ("int8", jdec, None, "int8")):
        with jax.default_matmul_precision("highest"):
            want[name] = np.asarray(jeb.make_batched_edit_fn(jd, quantize=quantize, is_lung=True)(
                dec_vars, vq, jnp.asarray(ids))).astype(np.float32)
        dec = UNetDecoder(16, 1, f, dropped_skip_layers=(), use_pixel_shuffle=False,
                          dtype=dtype)
        dec.load_state_dict(from_jax_decoder(dec_vars), strict=True)
        got[name] = teb.make_batched_edit_fn(dec, quantize=quantize, is_lung=True,
                                             device="cpu")(tvq, ids).float().numpy()
    np.testing.assert_allclose(got["f32"], want["f32"], atol=1e-4, rtol=0)
    assert np.abs(got["int8"] - want["int8"]).mean() < 2e-3
    ratio = {side: np.abs(d["int8"] - d["f32"]).mean() / np.abs(d["bf16"] - d["f32"]).mean()
             for side, d in (("port", got), ("jax", want))}
    assert abs(ratio["port"] / ratio["jax"] - 1) < 1 / 3, ratio


def test_edit_batch_main_int8(tmp_path, monkeypatch):
    """`edit_batch.main --dtype int8 --device cpu` over two painted NIfTIs:
    two edited volumes, each what `make_batched_edit_fn(quantize="int8")`
    decodes from the same map, and not the f32 decode."""
    from medical_image_editing_tpu_torch.cli import run_recon as trr

    class Tiny(trr.LungConfig):
        enc_filters = F
        dec_filters = F
        dict_size = K

    monkeypatch.setattr(trr, "LungConfig", Tiny)
    monkeypatch.delenv("LUNG_CKPT", raising=False)
    enc, dec, _ = trr.load_model(Tiny(), device="cpu", seed=3)
    sd = {f"{name}.{k}": v for name, m in (("encoder", enc), ("decoder", dec))
          for k, v in m.state_dict().items()}
    torch.save({"state_dict": sd}, tmp_path / "toy.ckpt")
    monkeypatch.setenv("LUNG_CKPT", str(tmp_path / "toy.ckpt"))
    labels, out = tmp_path / "labels", tmp_path / "out"
    labels.mkdir()
    maps = _ids(3)
    for i, m in enumerate(maps):
        tnifti.save(np.transpose(m.astype(np.float64)[::-1, ::-1]),
                    str(labels / f"label_{i}.nii.gz"))
    assert teb.main(["--label-dir", str(labels), "--out-dir", str(out), "--dtype", "int8",
                     "--device", "cpu"]) == 0
    _, dec, vq = trr.load_model(Tiny(), device="cpu")
    want = teb.make_batched_edit_fn(dec, is_lung=True, quantize="int8", device="cpu")(
        vq, maps).numpy()
    f32 = teb.make_batched_edit_fn(dec, is_lung=True, device="cpu")(vq, maps).numpy()
    for i in range(2):
        got = tnifti.load(str(out / f"edited_{i}.nii.gz"))
        np.testing.assert_array_equal(got, tnifti.to_nifti_array(want[i]))
        assert not np.array_equal(got, tnifti.to_nifti_array(f32[i]))


# -- csrc/conv_s8.cu's index and fragment arithmetic, emulated ----------------

def _mma_s8(acc, a, b0, b1, g, t):
    """One m16n8k32 s8 mma of a warp, from its lanes' fragments, as the PTX
    ISA lays them out (the layout in `csrc/conv_s8.cu::mma_s8`)."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for i in range(4):
        A[g, 4 * t + i] = a[0][:, i]
        A[g + 8, 4 * t + i] = a[1][:, i]
        A[g, 16 + 4 * t + i] = a[2][:, i]
        A[g + 8, 16 + 4 * t + i] = a[3][:, i]
        B[4 * t + i, g] = b0[:, i]
        B[16 + 4 * t + i, g] = b1[:, i]
    C = A @ B
    acc[:, 0] += C[g, 2 * t]
    acc[:, 1] += C[g, 2 * t + 1]
    acc[:, 2] += C[g + 8, 2 * t]
    acc[:, 3] += C[g + 8, 2 * t + 1]


def _emulate_conv_s8(xq, wq, cout, kh, kw, dh, dw, ph, pw):
    """conv_s8_kernel's loads, mma and stores, lane by lane in numpy."""
    n, h, w, cp = xq.shape
    ho, wo = h + 2 * ph - dh * (kh - 1), w + 2 * pw - dw * (kw - 1)
    hwo, m_total = ho * wo, n * ho * wo
    xf, wf = xq.reshape(-1).astype(np.int64), wq.reshape(-1).astype(np.int64)
    y = np.full((n, cout, ho, wo), -(2**40), np.int64)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3

    def ld32(flat, off, valid):
        out = np.zeros((32, 4), np.int64)
        idx = off[valid][:, None] + np.arange(4)
        assert (off[valid] % 4 == 0).all()
        out[valid] = flat[idx]
        return out

    for bx in range(-(-m_total // 128)):
        for by in range(-(-cout // 32)):
            co0 = by * 32
            for warp in range(4):
                m_warp = bx * 128 + warp * 32
                oh, ow, base, live_m = {}, {}, {}, {}
                for mt in range(2):
                    for hf in range(2):
                        m = m_warp + 16 * mt + 8 * hf + g
                        ok = m < m_total
                        img, r = m // hwo, m % hwo
                        oh[mt, hf] = np.where(ok, r // wo, -(1 << 29))
                        ow[mt, hf] = np.where(ok, r % wo, 0)
                        base[mt, hf] = np.where(ok, img * h * w * cp, 0)
                        live_m[mt, hf] = ok
                n_live = sum(co0 + 8 * nt < cout for nt in range(4))
                co_b = co0 + g
                acc = np.zeros((2, 4, 32, 4), np.int64)
                for tap in range(kh * kw):
                    ky, kx = divmod(tap, kw)
                    xp, inside = {}, {}
                    for key in oh:
                        ih = oh[key] - ph + ky * dh
                        iw = ow[key] - pw + kx * dw
                        inside[key] = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
                        xp[key] = (base[key] + (np.where(inside[key], ih, 0) * w
                                                + np.where(inside[key], iw, 0)) * cp + 4 * t)
                    wp = (tap * cout + co_b) * cp + 4 * t
                    for kc in range(cp // 32):
                        k0 = kc * 32
                        a = {mt: [ld32(xf, xp[mt, 0] + k0, inside[mt, 0]),
                                  ld32(xf, xp[mt, 1] + k0, inside[mt, 1]),
                                  ld32(xf, xp[mt, 0] + k0 + 16, inside[mt, 0]),
                                  ld32(xf, xp[mt, 1] + k0 + 16, inside[mt, 1])]
                             for mt in range(2)}
                        for nt in range(n_live):
                            live = co_b + 8 * nt < cout
                            bp = wp + 8 * nt * cp + k0
                            b0, b1 = ld32(wf, bp, live), ld32(wf, bp + 16, live)
                            for mt in range(2):
                                _mma_s8(acc[mt, nt], a[mt], b0, b1, g, t)
                for mt in range(2):
                    for hf in range(2):
                        m = m_warp + 16 * mt + 8 * hf + g
                        for nt in range(4):
                            for e in range(2):
                                co = co0 + 8 * nt + 2 * t + e
                                ok = (m < m_total) & (co < cout)
                                img, r = m[ok] // hwo, m[ok] % hwo
                                y[img, co[ok], r // wo, r % wo] = acc[mt, nt][ok, 2 * hf + e]
    assert (y > -(2**40)).all()  # every output written
    return y


@pytest.mark.parametrize("n,cin,cout,h,w,k,d", [
    (1, 40, 9, 5, 7, 3, 1),    # ragged Cin (two K-steps), ragged Cout, M < one block
    (2, 16, 1, 9, 20, 1, 1),   # Cout 1, two blocks of pixels
    (1, 8, 33, 12, 12, 3, 5),  # dilation past the image, two blocks of channels
])
def test_conv_s8_kernel_index_arithmetic_matches_plain(n, cin, cout, h, w, k, d):
    """The kernel's pixel decomposition, tap offsets, masks, fragment loads
    (m16n8k32 s8 layout), skipped n8 tiles and stores, emulated lane by
    lane, give the plain version's int32 sums."""
    rng = np.random.default_rng(n * 100 + cin)
    x = torch.from_numpy(rng.normal(size=(n, cin, h, w)).astype(np.float32))
    wt = torch.from_numpy(rng.normal(size=(cout, cin, k, k)).astype(np.float32))
    scale = tqc.symmetric_scale(tqc.channel_absmax(x))
    xq = tqc.quantize_s8(x, scale)
    wq, _ = tqc.weight_codes(wt, scale)
    pad = d if k == 3 else 0
    want = tqc.conv_s8_reference(xq, wq, None, None, kernel_size=(k, k), dilation=(d, d),
                                 padding=(pad, pad), out_dtype=torch.int32)
    got = _emulate_conv_s8(xq.numpy(), wq.numpy(), cout, k, k, d, d, pad, pad)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))
