"""Port 3×3 conv kernel function, its gradient and its dispatch vs the JAX
package, on the CPU.

On CPU tensors the port computes its kernel's function with the plain
version (`conv3x3_packed_reference`: the convolution summed in f32, output
in the input dtype); the JAX side runs the Pallas kernel in interpret mode
(`conv3x3_packed(..., interpret=True)`), at the shapes of
`tests/test_conv_pack.py` and at the Cin/Cout 32/64 of the lung model.
Tolerances: f32 atol 1e-4, rtol 1e-5 (as `test_conv_pack.py`: summation
order); gradients atol/rtol 1e-4; bf16 one bf16 ulp (both sums are f32 and
round once to bf16, so they differ only where the f32 sums straddle a
rounding boundary).

The CUDA kernels themselves run only on the card; their index arithmetic
is emulated here in numpy (`_emulate_mma_kernel` for bf16,
`_emulate_f32_kernel` for the f32 kernels, `ieee` and TF32; tolerance 1e-5
against f32 `F.conv2d` on the same, for TF32 rounded, values: f32 sums in
another order). The TF32 rounding helper is held to a field-wise numpy
emulation of `cvt.rna.tf32.f32` bit for bit, and the CPU route to give the
same f32 result whatever cuDNN's TF32 flag says.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.models import UNetDecoder as JDecoder
from medical_image_editing_tpu.models import blocks as jb
from medical_image_editing_tpu.models.unet_encoder import UNetEncoder as JUNetEncoder
from medical_image_editing_tpu.ops import conv_pack as jcp
from medical_image_editing_tpu_torch.models import UNetDecoder, UNetEncoder
from medical_image_editing_tpu_torch.models import blocks as tb
from medical_image_editing_tpu_torch.ops import _build
from medical_image_editing_tpu_torch.ops import conv_pack as tcp
from medical_image_editing_tpu_torch.utils import weights as bridge

# (B, H, W, Cin, Cout, row_tile): test_conv_pack.py's shapes, its multi-row
# tile, and the lung model's widths (forward 32→32, 32→64; dx 64→32)
SHAPES = [
    (1, 8, 8, 4, 4, 4),
    (2, 16, 12, 8, 16, 8),
    (1, 8, 16, 32, 32, 4),
    (1, 32, 8, 4, 8, 8),
    (2, 16, 16, 32, 32, 16),
    (2, 16, 16, 32, 64, 16),
    (2, 8, 8, 64, 32, 8),
]
LUNG_ENC = (16, 32, 64, 128, 256)
LUNG_DEC = (32, 64, 128, 256, 512)


def _xw(shape, seed, dtype=np.float32):
    b, h, w, cin, cout, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    return x, k


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_packed_matches_jax_kernel(shape):
    x, k = _xw(shape, 0)
    want = np.asarray(jcp.conv3x3_packed(jnp.asarray(x), jnp.asarray(k), row_tile=shape[-1],
                                         interpret=True))
    got = tcp.conv3x3_packed(torch.from_numpy(x), torch.from_numpy(k))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    # the modules' NCHW entry computes the same function
    nchw = tcp.conv3x3_packed_nchw(torch.from_numpy(x).permute(0, 3, 1, 2),
                                   torch.from_numpy(k).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), got.numpy())


@pytest.mark.parametrize("shape", [(1, 16, 8, 8, 8, 8), (2, 16, 16, 32, 32, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_packed_bf16_matches_jax_kernel(shape):
    x, k = _xw(shape, 1)
    xb, kb = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(k).astype(jnp.bfloat16)
    want = np.asarray(jcp.conv3x3_packed(xb, kb, row_tile=8, interpret=True), np.float32)
    got = tcp.conv3x3_packed(torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= 2.0**-7 * np.abs(want) + 1e-6)
    assert (got == want).mean() > 0.99


@pytest.mark.parametrize("shape", [(1, 8, 8, 4, 4, 8), (2, 16, 16, 32, 64, 16),
                                   (2, 8, 8, 64, 32, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_packed_trainable_grads_match_jax(shape):
    x, k = _xw(shape, 2)
    b, h, w, _, cout, _ = shape
    cot = np.random.default_rng(3).normal(size=(b, h, w, cout)).astype(np.float32)

    def loss(xx, kk):
        return jnp.sum(jcp.conv3x3_packed_trainable(xx, kk) * cot)

    gx_j, gk_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    (tcp.conv3x3_packed_trainable(xt, kt) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk_j), atol=1e-4, rtol=1e-4)


def test_packed_backward_needs_no_forward():
    """dw comes from x and dy alone (the JAX `_c3p_bwd` re-runs the forward
    through `jax.vjp`); dx is the kernel's function on dy with the kernel
    flipped and transposed."""
    x, k = _xw((2, 8, 8, 32, 16, 8), 4)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    wt = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous().requires_grad_()
    dy = torch.randn(2, 16, 8, 8, generator=torch.Generator().manual_seed(0))
    tcp.conv3x3_packed_trainable_nchw(xt, wt).backward(dy)
    np.testing.assert_allclose(
        xt.grad.numpy(), tcp.conv3x3_packed_nchw(dy, tcp.flip_transpose(wt.detach())).numpy(),
        rtol=0, atol=0)
    want_dw = torch.nn.grad.conv2d_weight(xt.detach(), wt.shape, dy, padding=1)
    np.testing.assert_allclose(wt.grad.numpy(), want_dw.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("args", [
    ((1, 64, 64, 32), (3, 3), (1, 1), "SAME", None, 1),
    ((1, 64, 64, 32), (3, 3), (1, 1), ((1, 1), (1, 1)), (1, 1), 1),
    ((1, 64, 64, 32), (3, 3), (2, 2), "SAME", None, 1),
    ((1, 64, 64, 32), (3, 3), (1, 1), "SAME", (2, 2), 1),
    ((1, 64, 64, 32), (3, 3), (1, 1), "SAME", None, 2),
    ((1, 64, 64, 32), (1, 1), (1, 1), "SAME", None, 1),
    ((1, 64, 62, 32), (3, 3), (1, 1), "SAME", None, 1),
    ((1, 4, 4, 32), (3, 3), (1, 1), "SAME", None, 1),
    ((1, 24, 24, 32), (3, 3), (1, 1), "SAME", None, 1),
    ((1, 64, 64, 16), (3, 3), (1, 1), "SAME", None, 1),
    ((1, 64, 64, 64), (3, 3), (1, 1), "SAME", None, 1),
    ((1, 64, 64, 32), (3, 3), (1, 1), [(2, 2), (2, 2)], None, 1),
])
def test_packed_eligible_matches_jax(args):
    assert tcp.packed_eligible(*args) == jcp.packed_eligible(*args)


def _jax_routed(monkeypatch, module, x, **kw):
    """Shapes (H, W, Cin, Cout) the JAX dispatch sends to the packed kernel
    while flax traces `module.init` abstractly."""
    calls = []

    def record(lhs, rhs):
        calls.append((lhs.shape[1], lhs.shape[2], rhs.shape[2], rhs.shape[3]))
        return jax.lax.conv_general_dilated(lhs, rhs, (1, 1), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    monkeypatch.setattr(jcp, "conv3x3_packed_trainable", record)
    jax.eval_shape(lambda: module.init({"params": jax.random.key(0),
                                        "dropblock": jax.random.key(1)}, x, **kw))
    return sorted(calls)


def _port_routed(monkeypatch, module, x):
    calls = []

    def record(x, w):
        calls.append((x.shape[2], x.shape[3], x.shape[1], w.shape[0]))
        return torch.nn.functional.conv2d(x, w, padding=1)

    monkeypatch.setattr(tb, "conv3x3_packed_trainable_nchw", record)
    module(x)
    return sorted(calls)


def test_dispatch_routes_the_convs_jax_routes_at_lung_widths(monkeypatch):
    """At the lung model's widths and 256²: the encoder routes 3 convs, the
    decoder 10 (the launch counts `chip_smoke.py` asserts)."""
    monkeypatch.setenv("MEDIMG_CONV_IMPL", "packed")
    j_enc = _jax_routed(monkeypatch, JUNetEncoder(filters=LUNG_ENC),
                        jnp.zeros((1, 256, 256, 1)), train=False)
    j_dec = _jax_routed(monkeypatch, JDecoder(filters=LUNG_DEC, dropped_skip_layers=(),
                                              use_pixel_shuffle=False),
                        jnp.zeros((1, 256, 256, LUNG_ENC[0])), train=False)
    with torch.device("meta"):
        enc = UNetEncoder(1, LUNG_ENC)
        dec = UNetDecoder(LUNG_ENC[0], 1, LUNG_DEC, dropped_skip_layers=(),
                          use_pixel_shuffle=False)
        t_enc = _port_routed(monkeypatch, enc, torch.zeros(1, 1, 256, 256))
        t_dec = _port_routed(monkeypatch, dec, torch.zeros(1, LUNG_ENC[0], 256, 256))
    assert t_enc == j_enc and len(t_enc) == 3
    assert t_dec == j_dec and len(t_dec) == 10
    monkeypatch.setenv("MEDIMG_CONV_IMPL", "xla")
    with torch.device("meta"):
        assert _port_routed(monkeypatch, dec, torch.zeros(1, LUNG_ENC[0], 256, 256)) == []


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_double_conv_matches_jax(monkeypatch, dtype):
    """A DoubleConv(32) with both convs eligible: the port's packed route,
    its plain route and JAX's packed route agree, in f32 and in a bf16
    compute dtype (params f32)."""
    monkeypatch.setenv("MEDIMG_CONV_IMPL", "packed")
    x = np.random.default_rng(5).normal(size=(2, 16, 16, 32)).astype(np.float32)
    jdt = {"float32": None, "bfloat16": jnp.bfloat16}[dtype]
    jm = jb.DoubleConv(32, dtype=jdt)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jnp.asarray(x)))
    want = np.asarray(jm.apply(v, jnp.asarray(x)), np.float32)
    sd = {}
    bridge._double_conv(sd, "m", v["params"])
    tm = tb.DoubleConv(32, 32)
    tm.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    tb.set_compute_dtype(tm, getattr(torch, dtype))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tm(xt)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().permute(0, 2, 3, 1).detach().numpy()
    monkeypatch.setenv("MEDIMG_CONV_IMPL", "xla")
    plain = tm(xt).float().permute(0, 2, 3, 1).detach().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        np.testing.assert_allclose(got, plain, atol=1e-5, rtol=0)
    else:
        # two bf16 roundings per conv and per norm, in other orders: a few
        # bf16 ulps of the unit-scale activations
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=0)
        assert np.abs(got - want).mean() < 5e-3


# -- the bf16 tensor-core kernel's index arithmetic, emulated in numpy --------
#
# `conv3x3_mma_kernel` (csrc/conv3x3_packed.cu) runs only on the card. This
# emulation follows its block origin, halo and weight staging map,
# shared-memory addressing, fragment loads and both epilogues (16-byte rows
# through shared memory, or fragment elements one by one) line by line, with
# the tile constants read from the source, and lets the mma.m16n8k16
# fragment layout of the PTX ISA decide which matrix element each lane's
# register holds. Shared memory starts as NaN, so a read of a slot the
# staging never wrote (the channel padding) poisons the output; so does an
# output the epilogue never writes.
# The sums stay f32 (no bf16 rounding at the store), so the result is held to
# f32 `F.conv2d` on the same bf16-valued inputs to 1e-5: f32 sums in another
# order.

_CU = Path(tcp.__file__).resolve().parent.parent / "csrc" / "conv3x3_packed.cu"


def _cu_constants():
    k = {name: int(v) for name, v in
         re.findall(r"constexpr int (k\w+) = (\d+);", _CU.read_text())}
    k["kHaloH"], k["kHaloW"] = k["kTileH"] + 2, k["kTileW"] + 2
    return k


def _ptx_a(g, t, reg, half):
    """(row, col) of A (m16 × k16) held by lane (g, t) in a[reg], element half."""
    return g + 8 * (reg & 1), 2 * t + half + 8 * (reg >> 1)


def _ptx_b(g, t, reg, half):
    """(k, n) of B (k16 × n8) held in b[reg], element half."""
    return 2 * t + half + 8 * reg, g


def _ptx_c(g, t, i):
    """(row, col) of C (m16 × n8) held in d[i]."""
    return g + 8 * (i >> 1), 2 * t + (i & 1)


def _emulate_mma_kernel(x_flat, xs, w_flat, b, h, wd, cin, cout, channels_last):
    """y (B, Cout, H, W) in f32 from the kernel's own index arithmetic; x is a
    flat buffer read through its (b, c, h, w) strides `xs`, w the flat HWIO
    weights, y written NHWC if `channels_last` else NCHW."""
    k = _cu_constants()
    tile_h, tile_w, tile_co, chunk = k["kTileH"], k["kTileW"], k["kTileCo"], k["kChunk"]
    halo_h, halo_w, pix = k["kHaloH"], k["kHaloW"], k["kPix"]
    m_tiles, n_tiles = tile_w // 16, tile_co // 8
    edge_items = halo_h * (halo_w - tile_w) * chunk // 2
    assert k["kThreads"] == 32 * tile_h == 256 and chunk == 16
    assert tile_w == tile_co == 32 and edge_items <= k["kThreads"]
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    warp = np.arange(k["kThreads"] // 32)
    regs, halves = np.arange(4), np.arange(2)
    a_row, a_col = _ptx_a(g[:, None, None], t[:, None, None], regs[:, None], halves)
    b_k, b_n = _ptx_b(g[:, None, None], t[:, None, None], regs[:2, None], halves)
    c_row, c_col = _ptx_c(g[:, None], t[:, None], regs)
    a_off = np.array([0, 8 * pix, 8, 8 * pix + 8])  # a[0..3] past xp
    b_off = np.array([0, 8])                        # b[n][0..1] past wp

    # y as the wrapper allocates it: contiguous NHWC (channels_last) or NCHW
    y = np.full(b * cout * h * wd, np.nan, np.float32)
    ys = (h * wd * cout, 1, wd * cout, cout) if channels_last else (cout * h * wd, h * wd, wd, 1)
    rows16 = ys[3] == 1 and wd % 8 == 0 and all(v % 8 == 0 for v in ys[:3])
    y_co = tile_h * tile_w + 8
    y_items = tile_co * tile_h * (tile_w // 8) // k["kThreads"]
    co_tiles = -(-cout // tile_co)
    grid = (-(-wd // tile_w) * co_tiles, -(-h // tile_h), b)
    for bz in range(grid[2]):
        for by in range(grid[1]):
            for bx in range(grid[0]):
                col_tile = bx // co_tiles
                co0 = (bx - col_tile * co_tiles) * tile_co
                w0, h0 = col_tile * tile_w, by * tile_h
                acc = np.zeros((len(warp), 32, m_tiles, n_tiles, 4), np.float32)
                for c0 in range(0, cin, chunk):
                    # halo: lane (g, t) of warp v, for each row r, the channel
                    # pair 2(4(v & 1) + t) of column 8(v >> 1) + g; threads
                    # 0..159 add columns 32, 33; weights: for each tap, output
                    # channel 8(v & 3) + g, channel pair 2(4(v >> 2) + t)
                    rows = np.arange(halo_h)[:, None, None]
                    cols = 8 * (warp[:, None] >> 1) + g
                    pair = 2 * (4 * (warp[:, None] & 1) + t)
                    tid = np.arange(edge_items)
                    items = [(rows, cols, pair),
                             (tid >> 4, tile_w + ((tid >> 3) & 1), 2 * (tid & 7))]
                    x_s = np.full(halo_h * halo_w * pix, np.nan, np.float32)
                    for r, c, ci in items:
                        r, c, ci = np.broadcast_arrays(r, c, ci)
                        gh, gw, gc = h0 - 1 + r, w0 - 1 + c, c0 + ci
                        inside = (gh >= 0) & (gh < h) & (gw >= 0) & (gw < wd)
                        src = bz * xs[0] + gc * xs[1] + gh * xs[2] + gw * xs[3]
                        for half in range(2):
                            on = inside & (gc + half < cin)
                            x_s[(r * halo_w + c) * pix + ci + half] = np.where(
                                on, x_flat[np.where(on, src + half * xs[1], 0)], 0)
                    tap = np.arange(9)[:, None, None]
                    co = np.broadcast_to(8 * (warp[:, None] & 3) + g, (9, len(warp), 32))
                    ci = np.broadcast_to(2 * (4 * (warp[:, None] >> 2) + t), co.shape)
                    gc, gco = c0 + ci, co0 + co
                    src = (tap * cin + gc) * cout + gco
                    w_s = np.full(9 * tile_co * pix, np.nan, np.float32)
                    for half in range(2):
                        on = (gco < cout) & (gc + half < cin)
                        w_s[(tap * tile_co + co) * pix + ci + half] = np.where(
                            on, w_flat[np.where(on, src + half * cout, 0)], 0)
                    for tap in range(9):
                        ky, kx = divmod(tap, 3)
                        n = np.arange(n_tiles)
                        wp = (tap * tile_co + 8 * n[None] + g[:, None]) * pix + 2 * t[:, None]
                        bv = w_s[wp[..., None, None] + b_off[:, None] + halves]  # lane,n,reg,half
                        bmat = np.full((n_tiles, 16, 8), np.nan, np.float32)
                        bmat[:, b_k, b_n] = bv.transpose(1, 0, 2, 3)
                        m = np.arange(m_tiles)
                        xp = (((warp[:, None, None] + ky) * halo_w + 16 * m[:, None]
                               + g + kx) * pix + 2 * t)               # warp, m, lane
                        av = x_s[xp[..., None, None] + a_off[:, None] + halves]
                        amat = np.full((len(warp), m_tiles, 16, 16), np.nan, np.float32)
                        amat[:, :, a_row, a_col] = av
                        cmat = amat[:, :, None] @ bmat[None, None]  # warp, m, n, 16, 8
                        acc += cmat[:, :, :, c_row, c_col].transpose(0, 3, 1, 2, 4)
                if rows16:  # the fragments → y_s[co][row][col] → 16-byte stores
                    y_s = np.full(tile_co * y_co, np.nan, np.float32)
                    for m in range(m_tiles):
                        for half in range(2):
                            for n in range(n_tiles):
                                for j in range(2):
                                    dst = ((8 * n + 2 * t + j) * y_co + warp[:, None] * tile_w
                                           + 16 * m + g + 8 * half)
                                    y_s[dst] = acc[:, :, m, n, 2 * half + j]
                    i = np.arange(k["kThreads"])[:, None] + k["kThreads"] * np.arange(y_items)
                    seg, row = i % (tile_w // 8), (i // (tile_w // 8)) % tile_h
                    co = i // (tile_w // 8 * tile_h)
                    gco, gh, gw = co0 + co, h0 + row, w0 + 8 * seg
                    ok = (gco < cout) & (gh < h) & (gw < wd)
                    for e in range(8):
                        dst = bz * ys[0] + gco * ys[1] + gh * ys[2] + gw + e
                        y[dst[ok]] = y_s[(co * y_co + row * tile_w + 8 * seg + e)[ok]]
                    continue
                gh = h0 + warp
                for m in range(m_tiles):
                    for half in range(2):
                        gw = w0 + 16 * m + g + 8 * half
                        for n in range(n_tiles):
                            for j in range(2):
                                gco = co0 + 8 * n + 2 * t + j
                                ok = (gh[:, None] < h) & (gw < wd) & (gco < cout)
                                dst = (bz * ys[0] + gco * ys[1] + gh[:, None] * ys[2]
                                       + gw * ys[3])
                                y[dst[ok]] = acc[:, :, m, n, 2 * half + j][ok]
    if channels_last:
        return y.reshape(b, h, wd, cout).transpose(0, 3, 1, 2)
    return y.reshape(b, cout, h, wd)


def test_ptx_fragment_layout_covers_each_element_once():
    g, t = np.arange(32) >> 2, np.arange(32) & 3
    for fn, regs, shape in ((_ptx_a, 4, (16, 16)), (_ptx_b, 2, (16, 8))):
        seen = np.zeros(shape, int)
        for reg in range(regs):
            for half in range(2):
                np.add.at(seen, fn(g, t, reg, half), 1)
        assert (seen == 1).all()
    seen = np.zeros((16, 8), int)
    for i in range(4):
        np.add.at(seen, _ptx_c(g, t, i), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("shape,layout", [
    ((1, 20, 40, 37, 45), "nchw"),
    ((1, 20, 40, 37, 45), "nhwc"),
    ((2, 32, 32, 16, 64), "nchw"),
    ((1, 8, 3, 9, 33), "nchw_channel_slice"),
    ((1, 48, 72, 12, 40), "nhwc"),
    ((1, 20, 40, 13, 40), "nchw"),
], ids=lambda v: v if isinstance(v, str) else "x".join(map(str, v)))
def test_mma_kernel_index_arithmetic_matches_conv2d(shape, layout):
    """The bf16 kernel's tiles, staging, fragments and stores, emulated at
    ragged shapes (Cin past a chunk, Cout past a tile, H and W past a tile),
    at 32→32 and through NCHW, NHWC and channel-sliced strides; W 64 and 40
    with NCHW output take the 16-byte stores, the others the element ones."""
    b, cin, cout, h, wd = shape
    rng = np.random.default_rng(9)
    bf16 = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa: E731
    x = bf16(rng.normal(size=(b, cin + 1, h, wd)).astype(np.float32))
    w = bf16((rng.normal(size=(cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32))
    if layout == "nchw_channel_slice":
        mem, view = x, x[:, 1:]
    else:
        x = np.ascontiguousarray(x[:, 1:])
        mem = x if layout == "nchw" else np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        view = mem if layout == "nchw" else mem.transpose(0, 3, 1, 2)
    xs = tuple(s // 4 for s in view.strides)
    start = (view.__array_interface__["data"][0] - mem.__array_interface__["data"][0]) // 4
    w_hwio = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    got = _emulate_mma_kernel(mem.ravel()[start:], xs, w_hwio.ravel(), b, h, wd, cin, cout,
                              channels_last=layout == "nhwc")
    assert np.isfinite(got).all()
    want = torch.nn.functional.conv2d(torch.from_numpy(np.ascontiguousarray(view)),
                                      torch.from_numpy(w), padding=1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- the f32 kernels: the TF32 rounding and the CPU route's precision ---------


def _cvt_rna_tf32(a):
    """numpy emulation of `cvt.rna.tf32.f32` on float32 `a`: the value with
    10 explicit mantissa bits nearest to a, ties away from zero, written out
    from the sign, exponent and mantissa fields: finite values past the
    largest TF32 value overflow to inf; inf and nan stay."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.int64)
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    special = (mag >> 23) == 0xFF
    keep, low = mag >> 13, mag & 0x1FFF
    up = low >= 0x1000  # at or past the half-way point: ties away from zero
    mag = np.where(special, mag, (keep + up) << 13)
    return (sign | mag).astype(np.uint32).view(np.float32)


def test_tf32_round_matches_cvt_rna():
    """`tf32_round` against the field-wise emulation: ties both ways and in
    both signs, just below and above a tie, subnormals (their ties too), the
    largest finite values (past TF32's largest: inf), ±inf, nan, ±0, and
    random values of every exponent."""
    u = np.uint32
    special = np.array([
        0x3F801000, 0x3F803000, 0xBF801000, 0xBF803000,  # ties, even and odd kept bit
        0x3F800FFF, 0x3F801001, 0xBF800FFF, 0xBF801001,  # just below and past a tie
        0x00001000, 0x00000FFF, 0x00003000, 0x80001000, 0x007FF000, 0x007FFFFF,  # subnormals
        0x7F7FFFFF, 0xFF7FFFFF, 0x7F7FE000, 0x7F7FEFFF, 0x7F7FF000,  # the largest
        0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001, 0x7F800001,  # inf, nan
        0x00000000, 0x80000000, 0x3F800000, 0x00800000,
    ], u).view(np.float32)
    rng = np.random.default_rng(12)
    randoms = rng.integers(0, 2**32, size=20000, dtype=np.uint64).astype(u).view(np.float32)
    for a in (special, randoms):
        got = tcp.tf32_round(torch.from_numpy(a.copy())).numpy()
        want = _cvt_rna_tf32(a)
        np.testing.assert_array_equal(got.view(u), want.view(u))
    got = tcp.tf32_round(torch.from_numpy(special.copy())).numpy()
    assert np.isposinf(got[14]) and np.isneginf(got[15]) and np.isnan(got[21:24]).all()
    # a tie rounds away from zero, also where the kept bit is even
    assert got[16] == special[16] and got[0] == np.float32(1 + 2.0**-10)
    assert (got.view(u)[np.isfinite(got)] & 0x1FFF == 0).all()


def test_tf32_reference_is_the_rounded_convolution():
    """The TF32 instance's plain version is the f32 convolution of the
    rounded operands, and the rounding moves values by 2^-11 relative at
    most."""
    x, k = _xw((2, 8, 8, 5, 6, 8), 14)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1)
    got = tcp.conv3x3_tf32_reference_nchw(xt, wt)
    want = torch.nn.functional.conv2d(torch.from_numpy(_cvt_rna_tf32(xt.numpy())),
                                      torch.from_numpy(_cvt_rna_tf32(wt.numpy())), padding=1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    r = tcp.tf32_round(xt)
    assert ((r - xt).abs() <= 2.0**-11 * xt.abs()).all() and not torch.equal(r, xt)


@pytest.mark.parametrize("shape", [(2, 16, 16, 32, 32, 16), (2, 8, 8, 64, 32, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cpu_route_ignores_the_tf32_flag(shape):
    """CPU tensors take the f32 plain version whatever cuDNN's TF32 flag
    says (the CPU's convolutions have no TF32): forward and gradients are
    bit for bit the same with the flag on and off, and still match the JAX
    kernel within the f32 tolerances above."""
    x, k = _xw(shape, 15)
    b, h, w, _, cout, _ = shape
    cot = np.random.default_rng(16).normal(size=(b, h, w, cout)).astype(np.float32)
    want = np.asarray(jcp.conv3x3_packed(jnp.asarray(x), jnp.asarray(k), row_tile=shape[-1],
                                         interpret=True))
    prev = torch.backends.cudnn.allow_tf32
    runs = []
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            before = dict(_build.launches)
            xt = torch.from_numpy(x).requires_grad_()
            kt = torch.from_numpy(k).requires_grad_()
            y = tcp.conv3x3_packed_trainable(xt, kt)
            (y * torch.from_numpy(cot)).sum().backward()
            runs.append((y.detach(), xt.grad, kt.grad))
            assert dict(_build.launches) == before  # the plain version, no kernel
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)
    np.testing.assert_allclose(runs[0][0].numpy(), want, atol=1e-4, rtol=1e-5)


def test_instance_follows_the_flag():
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        assert tcp.instance(torch.float32) == "tf32"
        torch.backends.cudnn.allow_tf32 = False
        assert tcp.instance(torch.float32) == "f32"
        assert tcp.instance(torch.bfloat16) == "bf16"
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tcp.instance(torch.float16)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert set(tcp.MODES) == {"f32", "tf32", "bf16"}


# -- the f32 kernels' index arithmetic, emulated in numpy ----------------------
#
# `conv3x3_f32_kernel` (ieee, CUDA cores) and `conv3x3_tf32_kernel` (TF32,
# mma.m16n8k8) run only on the card. This emulation follows `launch_f32`'s
# tile and flags, `for_stage`'s copies (16-byte pieces with their src-size,
# 4-byte edges and elements, zero-fill), the channel-planar stage layout,
# each kernel's shared-memory reads (the ieee kernel's register windows, the
# TF32 kernel's fragment loads under the PTX ISA's m16n8k8 .tf32 layout, and
# their banks) and both kernels' epilogues, with the ring's constants read
# from the source. Shared memory starts as NaN, so a read of a slot no copy
# wrote poisons the output, as does an output no store writes; a float
# written twice, a misaligned 16-byte copy or store, or a bank conflict of a
# fragment load fails. The sums are f32 in numpy's order, so the result is
# held to `F.conv2d` on the same values (TF32-rounded for the TF32 kernel)
# to 1e-5.


def _ptx_tf32_a(g, t, reg):
    """(row, col) of A (m16 × k8, .tf32) held by lane (g, t) in a[reg]."""
    return g + 8 * (reg & 1), t + 4 * (reg >> 1)


def _ptx_tf32_b(g, t, reg):
    """(k, n) of B (k8 × n8, .tf32) held in b[reg]."""
    return t + 4 * reg, g


def test_ptx_tf32_fragment_layout_covers_each_element_once():
    g, t = np.arange(32) >> 2, np.arange(32) & 3
    for fn, regs, shape in ((_ptx_tf32_a, 4, (16, 8)), (_ptx_tf32_b, 2, (8, 8))):
        seen = np.zeros(shape, int)
        for reg in range(regs):
            np.add.at(seen, fn(g, t, reg), 1)
        assert (seen == 1).all()


def _f32_instance(kind, wide, short):
    """(TileH, CoTile, params) of the instance `launch_f32` launches where
    the tall tiles would leave the SMs `short` of blocks (or not): R for
    conv3x3_f32_kernel<R, CoTile>, (MT, NT) for conv3x3_tf32_kernel (whose
    64-channel tile is always the tall one)."""
    if kind == "f32":
        r, co = (1 if short else 2), (64 if wide else 32)
        return (8 // (co // 8)) * 4 * r, co, r
    mt, nt = (2, 8) if wide else (2, 4) if short else (4, 4)
    return 4 * mt, 8 * nt, (mt, nt)


def _f32_stage_copies(k, tile_h, co_tile, f, xs, start, bz, c0, h0, w0, co0, h, wd, cin,
                      cout):
    """`for_stage`'s copies of one stage: (dst float, src index per float or
    -1 for a zero, floats a copy) groups; x sources index the x buffer (the
    view starts at `start`), weight sources the HWIO buffer (+ 2**40 to tell
    them apart)."""
    ch, cols, row = k["kFCh"], k["kFCols"], k["kFRow"]
    rows, plane, w_row = tile_h + 2, (tile_h + 2) * k["kFRow"] + 8, co_tile + 8
    out = []

    def add(dst, base, valid, width, wsrc=False):
        e = np.arange(width)
        src = np.where(e < valid[:, None], base[:, None] + e, -1)
        if width == 4:  # 16-byte cp.async: aligned destination and source
            assert (dst % 4 == 0).all() and (base[valid > 0] % 4 == 0).all()
        out.append((dst, np.where(src >= 0, src + (2**40 if wsrc else 0), -1), width))

    if f["x_pieces"]:
        i = np.arange(ch * rows * 8)
        s, r, ci = i & 7, (i >> 3) % rows, (i >> 3) // rows
        gh, gw, gc = h0 - 1 + r, w0 + 4 * s, c0 + ci
        inside = (gh >= 0) & (gh < h) & (gc < cin) & (gw < wd)
        add(ci * plane + r * row + 4 + 4 * s, start + bz * xs[0] + gc * xs[1] + gh * xs[2] + gw,
            np.where(inside, np.minimum(4, wd - gw), 0), 4)
        i = np.arange(ch * rows * 2)
        e, r, ci = i & 1, (i >> 1) % rows, (i >> 1) // rows
        gh, gw, gc = h0 - 1 + r, np.where(e == 1, w0 + cols, w0 - 1), c0 + ci
        inside = (gh >= 0) & (gh < h) & (gc < cin) & (gw >= 0) & (gw < wd)
        add(ci * plane + r * row + np.where(e == 1, 4 + cols, 3),
            start + bz * xs[0] + gc * xs[1] + gh * xs[2] + gw, inside.astype(int), 1)
    else:
        i = np.arange(ch * rows * (cols + 2))
        if f["x_cl"]:
            ci, c, r = i % ch, (i // ch) % (cols + 2), i // (ch * (cols + 2))
        else:
            c, r, ci = i % (cols + 2), (i // (cols + 2)) % rows, i // ((cols + 2) * rows)
        gh, gw, gc = h0 - 1 + r, w0 - 1 + c, c0 + ci
        inside = (gh >= 0) & (gh < h) & (gc < cin) & (gw >= 0) & (gw < wd)
        add(ci * plane + r * row + 3 + c,
            start + bz * xs[0] + gc * xs[1] + gh * xs[2] + gw * xs[3], inside.astype(int), 1)
    x_floats = ch * plane
    if f["w_pieces"]:
        q = co_tile // 4
        i = np.arange(9 * ch * q)
        s, ci, tap = i % q, (i // q) % ch, i // (q * ch)
        gc, gco = c0 + ci, co0 + 4 * s
        inside = (gc < cin) & (gco < cout)
        add(x_floats + (tap * ch + ci) * w_row + 4 * s, (tap * cin + gc) * cout + gco,
            np.where(inside, 4, 0), 4, wsrc=True)
    else:
        i = np.arange(9 * ch * co_tile)
        co, ci, tap = i % co_tile, (i // co_tile) % ch, i // (co_tile * ch)
        gc, gco = c0 + ci, co0 + co
        inside = (gc < cin) & (gco < cout)
        add(x_floats + (tap * ch + ci) * w_row + co, (tap * cin + gc) * cout + gco,
            inside.astype(int), 1, wsrc=True)
    return out


def _emulate_f32_kernel(kind, short, x_mem, start, xs, w_flat, b, h, wd, cin, cout,
                        channels_last):
    """y (B, Cout, H, W) from the kernel's own index arithmetic: x read from
    the flat buffer `x_mem` through its (b, c, h, w) strides `xs` from
    element `start`, w the flat HWIO weights, y written NHWC if
    `channels_last` else NCHW as the wrapper allocates it."""
    k = _cu_constants()
    nthreads, ch, cols, row = k["kThreads"], k["kFCh"], k["kFCols"], k["kFRow"]
    assert nthreads == 256 and ch == 8 and cols == 32 and k["kFStages"] == 2
    wide = cout > 32
    tile_h, co_tile, par = _f32_instance(kind, wide, short)
    plane, w_row = (tile_h + 2) * row + 8, co_tile + 8
    x_floats = ch * plane
    stage_floats = x_floats + 9 * ch * w_row
    y_co = tile_h * cols + 4
    assert plane % 32 == 24 and w_row % 32 == 8 and y_co % 16 == 4
    y = np.full(b * cout * h * wd, np.nan, np.float32)
    written = np.zeros(y.size, int)
    ys = (h * wd * cout, 1, wd * cout, cout) if channels_last else (cout * h * wd, h * wd, wd, 1)
    f = {"x_pieces": xs[3] == 1 and (xs[0] | xs[1] | xs[2]) % 4 == 0 and start % 4 == 0,
         "x_cl": xs[1] == 1, "w_pieces": cout % 4 == 0,
         "y_rows": ys[3] == 1 and wd % 4 == 0 and (ys[0] | ys[1] | ys[2]) % 4 == 0,
         "y_pix": ys[1] == 1 and (ys[0] | ys[2] | ys[3]) % 4 == 0}
    src_all = np.concatenate([x_mem.ravel(), w_flat.ravel()])
    co_tiles, col_tiles = -(-cout // co_tile), -(-wd // cols)
    tid = np.arange(nthreads)
    lane, warp = tid & 31, tid >> 5

    def store(idx, vals, ok, vec=False):
        if vec:  # a 16-byte store: 4 floats from a 16-byte-aligned address
            assert (idx[ok] % 4 == 0).all()
        np.add.at(written, idx[ok], 1)
        y[idx[ok]] = vals[ok]

    for bz in range(b):
        for by in range(-(-h // tile_h)):
            for bx in range(col_tiles * co_tiles):
                col_tile = bx // co_tiles
                co0, w0, h0 = (bx - col_tile * co_tiles) * co_tile, col_tile * cols, by * tile_h
                if kind == "f32":
                    acc = np.zeros((nthreads, par, 4, 8), np.float32)
                else:
                    acc = np.zeros((8, 32, *par, 4), np.float32)
                for c0 in range(0, cin, ch):
                    stage = np.full(stage_floats, np.nan, np.float32)
                    dsts = []
                    for dst, src, width in _f32_stage_copies(k, tile_h, co_tile, f, xs, start, bz,
                                                             c0, h0, w0, co0, h, wd, cin, cout):
                        src = np.where(src >= 2**40, src - 2**40 + x_mem.size, src)
                        d = dst[:, None] + np.arange(width)
                        vals = np.where(src >= 0, src_all[np.maximum(src, 0)], 0).astype(np.float32)
                        stage[d] = _cvt_rna_tf32(vals) if kind == "tf32" else vals
                        dsts.append(d.ravel())
                    dsts = np.concatenate(dsts)
                    assert len(np.unique(dsts)) == len(dsts)  # no float copied twice
                    if kind == "f32":
                        _f32_compute(stage, acc, par, co_tile, plane, w_row, x_floats, warp, lane,
                                     ch, row)
                    else:
                        _tf32_compute(stage, acc, par, plane, w_row, x_floats, ch, row)
                if kind == "f32":
                    r = par
                    wch = warp % (co_tile // 8)
                    cq = lane & 7
                    r0 = (warp // (co_tile // 8)) * 4 * r + (lane >> 3) * r
                    gw, cb = w0 + 4 * cq, co0 + 8 * wch
                    for i in range(r):
                        gh = h0 + r0 + i
                        for j in range(4):
                            for kk in range(8):
                                ok = (gh < h) & (gw + j < wd) & (cb + kk < cout)
                                idx = bz * ys[0] + (cb + kk) * ys[1] + gh * ys[2] + (gw + j) * ys[3]
                                if f["y_pix"]:
                                    vec = cb + 8 <= cout  # two 16-byte stores from channel cb
                                    assert ((bz * ys[0] + gh * ys[2] + (gw + j) * ys[3] + cb)
                                            [vec & ok] % 4 == 0).all()
                                    store(idx, acc[:, i, j, kk], ok)
                                else:
                                    vec = f["y_rows"] & (gw + 3 < wd)
                                    store(idx, acc[:, i, j, kk], ok,
                                          vec=False)
                                    if f["y_rows"]:
                                        base = bz * ys[0] + (cb + kk) * ys[1] + gh * ys[2] + gw
                                        assert (base[vec & ok] % 4 == 0).all()
                    continue
                mt_n, nt_n = par
                g, t = np.arange(32) >> 2, np.arange(32) & 3
                if f["y_rows"]:
                    y_s = np.full(co_tile * y_co, np.nan, np.float32)
                    for mt in range(mt_n):
                        m = np.arange(8) * mt_n + mt
                        for half in range(2):
                            for n in range(nt_n):
                                for j in range(2):
                                    dst = ((8 * n + 2 * t + j) * y_co + (m[:, None] >> 1) * cols
                                           + 16 * (m[:, None] & 1) + g + 8 * half)
                                    assert all(len(set(d % 32)) == 32 for d in dst)  # banks
                                    y_s[dst] = acc[:, :, mt, n, 2 * half + j]
                    items = co_tile * tile_h * (cols // 4)
                    assert items % nthreads == 0
                    i = np.arange(items)
                    q, rr, co = i & 7, (i >> 3) % tile_h, (i >> 3) // tile_h
                    gco, gh, gw = co0 + co, h0 + rr, w0 + 4 * q
                    ok = (gco < cout) & (gh < h) & (gw < wd)
                    base = bz * ys[0] + gco * ys[1] + gh * ys[2] + gw
                    src = co * y_co + rr * cols + 4 * q
                    assert (src % 4 == 0).all()
                    for e in range(4):
                        store(base + e, y_s[src + e], ok, vec=e == 0)
                    continue
                for mt in range(mt_n):
                    m = np.arange(8) * mt_n + mt
                    gh = h0 + (m[:, None] >> 1) + 0 * g
                    for half in range(2):
                        gw = w0 + 16 * (m[:, None] & 1) + g + 8 * half
                        for n in range(nt_n):
                            for j in range(2):
                                gco = co0 + 8 * n + 2 * t + j
                                ok = (gh < h) & (gw < wd) & (gco < cout)
                                idx = bz * ys[0] + gco * ys[1] + gh * ys[2] + gw * ys[3]
                                store(idx.ravel(), acc[:, :, mt, n, 2 * half + j].ravel(),
                                      ok.ravel())
    assert (written == 1).all()
    if channels_last:
        return y.reshape(b, h, wd, cout).transpose(0, 3, 1, 2)
    return y.reshape(b, cout, h, wd)


def _f32_compute(stage, acc, r, co_tile, plane, w_row, x_floats, warp, lane, ch, row):
    """One stage through conv3x3_f32_kernel<r, co_tile>'s loop: every
    thread's (r + 2) x 6 window of each channel (a scalar, a float4, a
    scalar a row) and its 8 weights a tap (two float4s)."""
    wch, cq = warp % (co_tile // 8), lane & 7
    r0 = (warp // (co_tile // 8)) * 4 * r + (lane >> 3) * r
    wbase = x_floats + 8 * wch
    for ci in range(ch):
        xp = ci * plane + r0 * row + 4 * cq + 3
        assert ((xp + 1) % 4 == 0).all() and (wbase % 4 == 0).all()
        xv = stage[xp[:, None, None] + np.arange(r + 2)[:, None] * row + np.arange(6)]
        for kx in range(3):  # the kernel's order: channel, then kx, then ky
            for ky in range(3):
                wv = stage[(wbase + ci * w_row + (ky * 3 + kx) * ch * w_row)[:, None]
                           + np.arange(8)]
                acc += xv[:, ky:ky + r, kx:kx + 4, None] * wv[:, None, None, :]


def _tf32_compute(stage, acc, par, plane, w_row, x_floats, ch, row):
    """One stage through conv3x3_tf32_kernel<MT, NT>'s loop: the B and A
    fragment loads of every lane (each warp's 32 loads on 32 banks), the
    m16n8k8 products as the PTX layout places each register."""
    mt_n, nt_n = par
    g, t = np.arange(32) >> 2, np.arange(32) & 3
    regs = np.arange(4)
    a_row, a_col = _ptx_tf32_a(g[:, None], t[:, None], regs)
    b_k, b_n = _ptx_tf32_b(g[:, None], t[:, None], regs[:2])
    c_row, c_col = _ptx_c(g[:, None], t[:, None], regs)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        wp = x_floats + (tap * ch + t) * w_row + g
        bmat = np.full((nt_n, 8, 8), np.nan, np.float32)
        for n in range(nt_n):
            addr = np.stack([wp + 8 * n, wp + 8 * n + 4 * w_row], 1)  # lane, reg
            assert all(len(set(addr[:, j] % 32)) == 32 for j in range(2))
            bmat[n][b_k, b_n] = stage[addr]
        for mt in range(mt_n):
            m = np.arange(8) * mt_n + mt
            xp = (t * plane + ((m[:, None] >> 1) + ky) * row + 16 * (m[:, None] & 1)
                  + g + kx + 3)  # warp, lane
            addr = xp[..., None] + np.array([0, 8, 4 * plane, 4 * plane + 8])  # warp, lane, reg
            assert all(len(set(addr[v, :, j] % 32)) == 32 for v in range(8) for j in range(4))
            amat = np.full((8, 16, 8), np.nan, np.float32)
            amat[:, a_row, a_col] = stage[addr]
            for n in range(nt_n):
                cmat = amat @ bmat[n]  # warp, 16, 8
                acc[:, :, mt, n] += cmat[:, c_row, c_col]


@pytest.mark.parametrize("short", [False, True], ids=["tall", "short"])
@pytest.mark.parametrize("kind", ["f32", "tf32"])
@pytest.mark.parametrize("shape,layout", [
    ((1, 20, 40, 13, 45), "nchw"),
    ((1, 20, 40, 13, 40), "nhwc"),
    ((2, 8, 32, 9, 64), "nchw"),
    ((1, 8, 3, 9, 33), "nchw_channel_slice"),
    ((1, 12, 72, 6, 37), "nchw_column_slice"),
    ((1, 16, 64, 5, 32), "nhwc"),
], ids=lambda v: v if isinstance(v, str) else "x".join(map(str, v)))
def test_f32_kernels_index_arithmetic_matches_conv2d(kind, short, shape, layout):
    """Both f32 kernels on each tile they take, tall and half-height (where
    the grid is `short` of blocks), at ragged shapes: Cin past a
    chunk (20, 12), Cout of one narrow tile (3, 32), one wide tile (40, 64)
    and two (72); W past a 32-column tile and not a multiple of 4; NCHW rows
    in 16-byte pieces (W 64, and W 37 read from rows of 40: a short piece),
    NCHW and channel-sliced x by elements, NHWC x walked channels first; y
    in 16-byte rows (NCHW, W % 4 == 0), 16-byte pixels (NHWC, Cout % 4 ==
    0) or elements."""
    b, cin, cout, h, wd = shape
    rng = np.random.default_rng(19)
    w = (rng.normal(size=(cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
    if layout == "nchw_channel_slice":
        mem = rng.normal(size=(b, cin + 1, h, wd)).astype(np.float32)
        view = mem[:, 1:]
    elif layout == "nchw_column_slice":
        mem = rng.normal(size=(b, cin, h, wd + 3)).astype(np.float32)
        view = mem[..., :wd]
    elif layout == "nhwc":
        mem = rng.normal(size=(b, h, wd, cin)).astype(np.float32)
        view = mem.transpose(0, 3, 1, 2)
    else:
        mem = rng.normal(size=(b, cin, h, wd)).astype(np.float32)
        view = mem
    xs = tuple(s // 4 for s in view.strides)
    start = (view.__array_interface__["data"][0] - mem.__array_interface__["data"][0]) // 4
    w_hwio = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    got = _emulate_f32_kernel(kind, short, mem, start, xs, w_hwio, b, h, wd, cin, cout,
                              channels_last=layout == "nhwc")
    assert np.isfinite(got).all()
    xv, wv = torch.from_numpy(np.ascontiguousarray(view)), torch.from_numpy(w)
    if kind == "tf32":
        want = tcp.conv3x3_tf32_reference_nchw(xv, wv).numpy()
    else:
        want = torch.nn.functional.conv2d(xv, wv, padding=1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
