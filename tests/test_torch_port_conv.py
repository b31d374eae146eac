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
"""

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
