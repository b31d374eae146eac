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

The CUDA kernel itself runs only on the card; its bf16 path's index
arithmetic is emulated here in numpy (`_emulate_mma_kernel`, tolerance
1e-5 against f32 `F.conv2d`: f32 sums in another order).
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
