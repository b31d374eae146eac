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


# -- csrc/conv_s8.cu's tile walk, swizzle, fragments and stores, emulated --

BM, EPI_PAD, THREADS = 128, 4, 256  # csrc/conv_s8.cu's kBM, kEpiPad, kConvThreads


def _swizzle(off, kb):
    """`csrc/conv_s8.cu::swizzle<KB>`: 16-byte piece bits [4, 7) XOR row bits
    [7, 10), as many bits as a KB-byte row has pieces."""
    return off ^ (((off >> 7) & (kb // 16 - 1)) << 4)


def _desc_rows(ring, written, start, rows, kb, stamp):
    """The (rows, 32) bytes a K-major wgmma descriptor at `start` names: row
    r at (r // 8)·8·KB (the stride offset) + (r % 8)·KB (the swizzle's row
    pitch) + k, then swizzled on the address. Each byte read was written by
    the copies of k-block `stamp`."""
    r = np.arange(rows)[:, None]
    addr = _swizzle(start + (r // 8) * 8 * kb + (r % 8) * kb + np.arange(32)[None, :], kb)
    assert (written[addr] == stamp).all(), "a byte read that this k-block did not write"
    return ring[addr].astype(np.int64)


def _plain_desc_rows(ring, written, start, rows, lbo, stamp):
    """The (rows, 32) bytes of a K-major wgmma descriptor without swizzle:
    row r at r·16 (8-row groups 128 bytes apart), the k32 slice's second
    16 bytes `lbo` further. Each byte read was written by step `stamp`."""
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    addr = start + (r // 8) * 128 + (r % 8) * 16 + (k // 16) * lbo + k % 16
    assert (written[addr] == stamp).all(), "a byte read that this step did not write"
    return ring[addr].astype(np.int64)


def _ring_pipeline(iters, stages, prefetch, load, multiply):
    """The kernels' ring: PREFETCH steps loaded ahead, then each step k
    loads step k + PREFETCH into its slot and multiplies slot k % STAGES
    (a slot is refilled only after the batch that read it: PREFETCH plus
    the batches left running, STAGES - 1 - PREFETCH, is below STAGES)."""
    assert 0 <= stages - 1 - prefetch <= 1
    for st in range(prefetch):
        if st < iters:
            load(st, st)
    for k_block in range(iters):
        nk = k_block + prefetch
        if nk < iters:
            load(nk % stages, nk)
        multiply(k_block % stages, k_block)


def _store_tile(y, d, bn, m0, co0, m_total, hwo, cout, out_dtype, k_scale, bias):
    """`csrc/conv_s8.cu::store_tile`: warpgroup wg's D fragments (d[wg]:
    its 64 rows × BN) dequantized and staged [channel][pixel], then stored
    NCHW in 16-byte groups of pixels (when Ho·Wo is a multiple of the
    group) or element by element."""
    tid = np.arange(THREADS)
    lane, warp, wg = tid & 31, (tid >> 5) & 3, tid >> 7
    g, t = lane >> 2, lane & 3
    kld = BM + EPI_PAD
    group = 8 if out_dtype == torch.bfloat16 else 4  # 16 bytes of the output type
    stage = np.full(bn * kld, np.nan)
    for i in range(bn // 2):  # wgmma's D fragments → [channel][pixel]
        col = 8 * (i >> 2) + 2 * t + (i & 1)
        rr = 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1)
        acc = d[wg, 16 * warp + g + 8 * ((i >> 1) & 1), col]
        if out_dtype == torch.int32:
            v = acc.astype(np.float64)
        else:
            live = co0 + col < cout
            v = acc.astype(np.float32) * k_scale[np.minimum(co0 + col, cout - 1)]
            if bias is not None:
                v = v + bias[np.minimum(co0 + col, cout - 1)]
            v = np.where(live, v, 0).astype(np.float64)
        stage[col * kld + rr] = v
    for u in range(bn * (BM // group)):  # stores: `group` pixels of a channel
        col, gi = divmod(u, BM // group)
        co = co0 + col
        if co >= cout:
            continue
        mg = m0 + gi * group
        vals = stage[col * kld + gi * group:col * kld + (gi + 1) * group]
        if hwo % group == 0:
            if mg < m_total:
                im = mg // hwo
                dst = (im * cout + co) * hwo + mg - im * hwo
                y[dst:dst + group] = vals
        else:
            for e in range(group):
                if mg + e >= m_total:
                    break
                im = (mg + e) // hwo
                y[(im * cout + co) * hwo + mg + e - im * hwo] = vals[e]


def _emulate_conv_s8(xq, wq, cout, kh, kw, dh, dw, ph, pw, out_dtype=torch.int32,
                     k_scale=None, bias=None):
    """conv_s8's kernels block by block in numpy: the instance; the ring of
    cp.async stages (gather addresses, zero-fill, the writes: swizzled for
    conv_s8_kernel, plain row segments for conv_s8_kernel_rows); the wgmma
    descriptors' reads (a tap's shift along the row segment) and products;
    the accumulator fragments; the staged epilogue and its stores."""
    n, h, w, cp = xq.shape
    ho, wo = h + 2 * ph - dh * (kh - 1), w + 2 * pw - dw * (kw - 1)
    kernel, bn, kc, stages, prefetch = tqc.conv_s8_instance(cout, cp, kh, kw, dw, wo)
    hwo, m_total = ho * wo, n * ho * wo
    cpc = cp // 32
    xf, wf = xq.reshape(-1), wq.reshape(-1)
    y = np.full(n * cout * hwo, np.nan)
    rng = np.random.default_rng(0)

    def copy(ring, written, dst, src, valid, flat, stamp):
        """16-byte cp.async copies, zero-filled where not valid."""
        for b in range(16):
            ring[dst + b] = np.where(valid, flat[np.where(valid, src + b, 0)], 0)
            written[dst + b] = stamp

    tid = np.arange(THREADS)
    for bx in range(-(-m_total // BM)):
        m0 = bx * BM
        for by in range(-(-cout // bn)):
            co0 = by * bn
            d = np.zeros((2, 64, bn), np.int64)
            if kernel == 0:  # conv_s8_kernel: chunks q = (tap, 32 channels)
                kb = 32 * kc
                q_total = kh * kw * cpc
                a_bytes, stage_bytes = BM * kb, (BM + bn) * kb
                row, half = tid >> 1, tid & 1
                m = m0 + row
                m_ok = m < m_total
                img, r = m // hwo, m % hwo
                oh, ow = r // wo, r % wo
                ring = rng.integers(-128, 128, stages * stage_bytes).astype(np.int8)
                written = np.full(ring.shape, -1)

                def load(slot, k_block):
                    base = slot * stage_bytes
                    for j in range(kc):  # A: thread (row, half)
                        q = k_block * kc + j
                        tap, c32 = divmod(q, cpc)
                        ky, kx = divmod(tap, kw)
                        ih, iw = oh - ph + ky * dh, ow - pw + kx * dw
                        valid = (m_ok & (q < q_total) & (ih >= 0) & (ih < h) & (iw >= 0)
                                 & (iw < w))
                        src = (img * h * w + ih * w + iw) * cp + c32 * 32 + 16 * half
                        dst = base + _swizzle(row * kb + (2 * j + half) * 16, kb)
                        copy(ring, written, dst, src, valid, xf, k_block)
                    u = np.arange(bn * 2 * kc)  # B: 16-byte piece u, any thread
                    j, rr = u // (2 * bn), u % (2 * bn)
                    nn, hh = rr >> 1, rr & 1
                    q = k_block * kc + j
                    valid = (q < q_total) & (co0 + nn < cout)
                    src = ((q // cpc) * cout + co0 + nn) * cp + (q % cpc) * 32 + 16 * hh
                    dst = base + a_bytes + _swizzle(nn * kb + (2 * j + hh) * 16, kb)
                    assert len(np.unique(dst)) == len(dst)
                    copy(ring, written, dst, src, valid, wf, k_block)

                def multiply(slot, k_block):
                    base = slot * stage_bytes
                    for wg in range(2):
                        for j in range(kc):
                            a = _desc_rows(ring, written, base + wg * 64 * kb + 32 * j, 64, kb,
                                           k_block)
                            b = _desc_rows(ring, written, base + a_bytes + 32 * j, bn, kb,
                                           k_block)
                            d[wg] += a @ b.T

                _ring_pipeline(-(-q_total // kc), stages, prefetch, load, multiply)
            else:  # conv_s8_kernel_rows: steps (KYS kernel rows, 32 channels), row segments
                kys = kc
                steps = kh // kys * cpc
                seg = tqc.ROW_PIXELS + (kw - 1) * dw
                row_a = 2 * seg * 32
                a_bytes = kys * row_a
                stage_bytes = a_bytes + kys * kw * bn * 32
                slots = min(stages, steps)  # the ring has no more slots than steps
                assert tqc.row_kernel_smem(bn, kys, stages, cp, kh, dw) == max(
                    slots * stage_bytes, bn * (BM + EPI_PAD) * 4) + 128
                mg = m0 + 64 * np.arange(2)
                ok = mg < m_total
                img = np.where(ok, mg // hwo, 0)
                r = np.where(ok, mg - img * hwo, 0)
                oh, ow0 = r // wo, r % wo
                assert (ow0 % 64 == 0).all()
                ring = rng.integers(-128, 128, slots * stage_bytes).astype(np.int8)
                written = np.full(ring.shape, -1)

                def load(slot, step):
                    base = slot * stage_bytes
                    kyg, c32 = divmod(step, cpc)
                    for kyl in range(kys):
                        ky = kyg * kys + kyl
                        u = np.arange(4 * seg)  # A: (segment, row, half)
                        sg, rem = u // (2 * seg), u % (2 * seg)
                        rr, hh = rem >> 1, rem & 1
                        ih, iw = oh[sg] - ph + ky * dh, ow0[sg] - pw + rr
                        valid = ok[sg] & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
                        src = (img[sg] * h * w + ih * w + iw) * cp + c32 * 32 + 16 * hh
                        dst = base + kyl * row_a + sg * seg * 32 + hh * seg * 16 + rr * 16
                        assert len(np.unique(dst)) == len(dst)
                        copy(ring, written, dst, src, valid, xf, step)
                        u = np.arange(kw * 2 * bn)  # B: (tap, channel, half)
                        kx, rem = u // (2 * bn), u % (2 * bn)
                        nn, hh = rem >> 1, rem & 1
                        valid = co0 + nn < cout
                        src = ((ky * kw + kx) * cout + co0 + nn) * cp + c32 * 32 + 16 * hh
                        dst = (base + a_bytes + (kyl * kw + kx) * bn * 32 + hh * bn * 16
                               + nn * 16)
                        copy(ring, written, dst, src, valid, wf, step)

                def multiply(slot, step):
                    base = slot * stage_bytes
                    for wg in range(2):
                        for kyl in range(kys):
                            for kx in range(kw):
                                a = _plain_desc_rows(ring, written, base + kyl * row_a
                                                     + wg * seg * 32 + kx * dw * 16, 64,
                                                     seg * 16, step)
                                b = _plain_desc_rows(ring, written, base + a_bytes
                                                     + (kyl * kw + kx) * bn * 32, bn, bn * 16,
                                                     step)
                                d[wg] += a @ b.T

                _ring_pipeline(steps, stages, prefetch, load, multiply)
            _store_tile(y, d, bn, m0, co0, m_total, hwo, cout, out_dtype, k_scale, bias)
    assert not np.isnan(y).any()  # every output written
    y = torch.from_numpy(y.reshape(n, cout, ho, wo))
    if out_dtype == torch.int32:
        return y.to(torch.int32)
    return y.float().to(out_dtype)  # bf16 rounded once, at the store


# (n, cin, cout, h, w, kernel, dilation, out dtype)
EMULATED = [
    (1, 40, 9, 5, 7, 3, 1, torch.int32),       # ragged Cin (two chunks a tap), ragged Cout,
                                               # M < one tile, element stores
    (2, 16, 1, 9, 20, 1, 1, torch.float32),    # Cout 1, two tiles of pixels, bias
    (1, 8, 33, 12, 12, 3, 5, torch.int32),     # dilation past the image, Cout 33: BN 64
    (1, 32, 64, 8, 8, 3, 2, torch.bfloat16),   # a full Cout-64 tile, bf16 out
    (1, 136, 130, 5, 6, 3, 1, torch.float32),  # Cout 130: two BN-128 tiles, Cin 136 (five
                                               # chunks a tap, stages across taps)
    (3, 72, 32, 9, 11, 3, 1, torch.int32),     # M = 297: not a multiple of the tile, Cin 72
    (2, 32, 96, 8, 12, 3, 1, torch.float32),   # M = 192, 16-byte stores, a part tile
    # the row kernel (Wo a multiple of 64, 3×3, Cin past 32):
    (1, 40, 9, 3, 64, 3, 1, torch.int32),      # M = 192: a half tile, two chunks of Cin
    (1, 64, 64, 2, 128, 3, 5, torch.bfloat16),  # dilation 5 (segments of 74), BN 64, bf16 out
    (2, 72, 130, 2, 64, 3, 2, torch.float32),  # Cout 130: two BN-128 tiles, Cin 72, bias
    (1, 33, 32, 4, 64, 3, 18, torch.float32),  # dilation 18 (segments of 100), the ASPP's
]


@pytest.mark.parametrize("n,cin,cout,h,w,k,d,out_dtype", EMULATED,
                         ids=["x".join(map(str, c[:7])) + "-" + str(c[7]).split(".")[-1]
                              for c in EMULATED])
def test_conv_s8_kernel_index_arithmetic_matches_plain(n, cin, cout, h, w, k, d, out_dtype):
    """The kernels' tile walk, their cp.async gathers with zero-fill, the
    shared-memory layouts (each byte read back where its step wrote it),
    the wgmma descriptors and fragments and the staged epilogue, emulated
    block by block, give the plain version's int32 sums or its dequantized
    output bit for bit; the row shapes take the row kernel."""
    rng = np.random.default_rng(n * 100 + cin + cout)
    x = torch.from_numpy(rng.normal(size=(n, cin, h, w)).astype(np.float32))
    wt = torch.from_numpy(rng.normal(size=(cout, cin, k, k)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=cout).astype(np.float32))
    scale = tqc.symmetric_scale(tqc.channel_absmax(x))
    xq = tqc.quantize_s8(x, scale)
    wq, k_scale = tqc.weight_codes(wt, scale)
    pad = d if k == 3 else 0
    inst = tqc.conv_s8_instance(cout, tqc.padded_channels(cin), k, k, d, w)
    assert inst[0] == (1 if k == 3 and w % 64 == 0 and cin > 32 else 0)
    b = None if out_dtype == torch.int32 else bias
    want = tqc.conv_s8_reference(xq, wq, k_scale, b, kernel_size=(k, k), dilation=(d, d),
                                 padding=(pad, pad), out_dtype=out_dtype)
    got = _emulate_conv_s8(xq.numpy(), wq.numpy(), cout, k, k, d, d, pad, pad, out_dtype,
                           k_scale.numpy(), None if b is None else b.numpy())
    assert got.dtype == want.dtype and torch.equal(got, want)


def _emulate_conv_s8_weights(weight, amax, cp):
    """conv_s8_weights_kernel in numpy float32 steps, with its index maps:
    x_scale = max(amax, 1e-12) / 127, the block max of |W·x_scale|, k_scale,
    and codes [tap][o][c] by rint (half to even), zero past Cin."""
    cout, cin, kh, kw = weight.shape
    taps = kh * kw
    tiny, q = np.float32(1e-12), np.float32(127)
    xs = np.maximum(amax, tiny) / q
    codes = np.full((taps, cout, cp), 99, np.int8)
    k_scale = np.empty(cout, np.float32)
    for o in range(cout):
        wo = weight[o].reshape(-1)
        i = np.arange(cin * taps)
        ks = np.maximum(np.abs(wo[i] * xs[i // taps]).max(), tiny) / q
        k_scale[o] = ks
        i = np.arange(taps * cp)
        tap, c = i // cp, i % cp
        live = c < cin
        cc = np.minimum(c, cin - 1)
        kf = wo[cc * taps + tap] * xs[cc]
        codes[tap, o, c] = np.where(live, np.clip(np.rint(kf / ks), -127, 127), 0)
    return codes, k_scale, xs


@pytest.mark.parametrize("cin,cout,k", [(40, 9, 3), (16, 3, 1)])
def test_conv_s8_weights_kernel_arithmetic_matches_jax(cin, cout, k):
    """The weight kernel's float32 steps (emulated) and the plain
    `conv_s8_weights` / `weight_codes` give JAX's x_scale, k_fold scales and
    codes (`_quantize_sym`) bit for bit: Cin 40 padded to 64, an input
    channel whose maxima are 0 (the 1e-12 floor) and an output channel of
    zero weights."""
    rng = np.random.default_rng(cin + cout)
    x = rng.normal(size=(2, 6, 6, cin)).astype(np.float32)
    x[..., 3] = 0.0
    kernel = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    kernel[..., 1] = 0.0
    _, jx_scale, jkq, _, jk_scale = _jax_codes(x, kernel)
    w = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    amax = tqc.channel_absmax(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert amax[3] == 0
    codes, k_scale, x_scale = tqc.conv_s8_weights(w, amax)
    cp = tqc.padded_channels(cin)
    assert codes.shape == (k * k, cout, cp) and not codes[..., cin:].any()
    ecodes, ek_scale, ex_scale = _emulate_conv_s8_weights(w.numpy(), amax.numpy(), cp)
    np.testing.assert_array_equal(x_scale.numpy(), jx_scale)
    np.testing.assert_array_equal(ex_scale, jx_scale)
    np.testing.assert_array_equal(k_scale.numpy(), jk_scale)
    np.testing.assert_array_equal(ek_scale, jk_scale)
    assert k_scale[1] == np.float32(1e-12) / np.float32(127)
    jcodes = jkq.reshape(k * k, cin, cout).transpose(0, 2, 1)  # HWIO → (tap, O, I)
    np.testing.assert_array_equal(codes[..., :cin].numpy(), jcodes)
    np.testing.assert_array_equal(ecodes, codes.numpy())
    plain = tqc.weight_codes(w, x_scale)
    assert torch.equal(plain[0], codes) and torch.equal(plain[1], k_scale)
