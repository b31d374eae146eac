"""Port blocks vs the JAX package's flax blocks, on the same weights and inputs.

Inputs and weights are drawn with numpy and handed to both sides; the flax
variables go through the port's weight bridge. JAX runs under
`default_matmul_precision("highest")`. Tolerance atol 1e-4 (f32): the port's
InstanceNorm is the two-pass form and the JAX default is the single-pass
lane-packed form, and the two frameworks sum the convolutions in different
orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.models import blocks as jb
from medical_image_editing_tpu.ops import windowing as jw
from medical_image_editing_tpu_torch.models import blocks as tb
from medical_image_editing_tpu_torch.ops import windowing as tw
from medical_image_editing_tpu_torch.utils import weights as bridge

ATOL = 1e-4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _init(module, key, *args, **kw):
    variables = module.init(jax.random.key(key), *[jnp.asarray(a) for a in args], **kw)
    return jax.tree.map(np.asarray, variables)


def _perturb_stats(variables, rng):
    """Random running means and positive variances in every BatchNorm."""
    def walk(tree):
        if "mean" in tree and "var" in tree:
            c = tree["mean"].shape[0]
            return {"mean": rng.normal(size=c).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, size=c).astype(np.float32)}
        return {k: walk(v) for k, v in tree.items()}
    out = dict(variables)
    if "batch_stats" in out:
        out["batch_stats"] = walk(out["batch_stats"])
    return out


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _styled_up_sd(v):
    sd = {}
    bridge._styled_up(sd, "m", v["params"], v["batch_stats"])
    return {k[2:]: t for k, t in sd.items()}


def _case_double_conv(rng, act):
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    jm = jb.DoubleConv(8, use_output_act=act)
    v = _init(jm, 0, x)
    sd = {}
    bridge._double_conv(sd, "m", v["params"])
    tm = _load(tb.DoubleConv(3, 8, act), {k[2:]: t for k, t in sd.items()})
    return jm.apply(v, x), _nhwc(tm(_nchw(x)))


def _case_res_block(rng):
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    jm = jb.ResBlock(8)
    v = _init(jm, 1, x)
    sd = {}
    bridge._res_block(sd, "m", v["params"])
    tm = _load(tb.ResBlock(3, 8), {k[2:]: t for k, t in sd.items()})
    (jp, js), (tp, ts) = jm.apply(v, x), tm(_nchw(x))
    return np.concatenate([np.ravel(jp), np.ravel(js)]), np.concatenate(
        [np.ravel(_nhwc(tp)), np.ravel(_nhwc(ts))])


def _case_up_block(rng):
    down = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    skip = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    jm = jb.UpBlock(4)
    v = _init(jm, 2, down, skip)
    sd = {}
    bridge._double_conv(sd, "m.double_conv", v["params"]["DoubleConv_0"])
    tm = _load(tb.UpBlock(12, 4), {k[2:]: t for k, t in sd.items()})
    return jm.apply(v, down, skip), _nhwc(tm(_nchw(down), _nchw(skip)))


def _case_styled_denorm(rng):
    x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    style = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    jm = jb.StyledDenorm(8)
    v = _perturb_stats(_init(jm, 3, x, style, train=False), rng)
    sd = {}
    bridge._styled_denorm(sd, "m", v["params"], v["batch_stats"])
    tm = _load(tb.StyledDenorm(8, 4), {k[2:]: t for k, t in sd.items()})
    return jm.apply(v, x, style, False), _nhwc(tm(_nchw(x), _nchw(style)))


def _case_styled_up(rng, ps):
    down = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    skip = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    jm = jb.StyledResUpBlock(4, use_pixel_shuffle=ps)
    v = _perturb_stats(_init(jm, 4, down, skip, train=False), rng)
    tm = _load(tb.StyledResUpBlock(8, 4, 4, use_pixel_shuffle=ps), _styled_up_sd(v))
    return jm.apply(v, down, skip, False), _nhwc(tm(_nchw(down), _nchw(skip)))


def _case_aspp(rng):
    x = rng.normal(size=(2, 24, 24, 4)).astype(np.float32)
    jm = jb.ASPP(4)
    v = _init(jm, 5, x)
    sd = {f"stages.c{int(n.split('_')[1])}.conv.weight": bridge._k(cp["kernel"])
          for n, cp in v["params"].items()}
    tm = _load(tb.ASPP(4, 4), sd)
    return jm.apply(v, x), _nhwc(tm(_nchw(x)))


def _case_instance_norm(rng):
    # an offset mean, as post-conv activations carry
    x = (rng.normal(size=(2, 16, 16, 8)) * 0.7 + 0.3).astype(np.float32)
    return jb.instance_norm(jnp.asarray(x)), _nhwc(tb.instance_norm(_nchw(x)))


def _case_pixel_shuffle(rng):
    x = rng.normal(size=(2, 4, 4, 12)).astype(np.float32)
    return jb.pixel_shuffle(jnp.asarray(x), 2), _nhwc(tb.pixel_shuffle(_nchw(x), 2))


def _case_upsample_pool(rng):
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    j = np.concatenate([np.ravel(jb.nearest_upsample(jnp.asarray(x))),
                        np.ravel(jb.max_pool_2x2(jnp.asarray(x)))])
    t = np.concatenate([np.ravel(_nhwc(tb.nearest_upsample(_nchw(x)))),
                        np.ravel(_nhwc(tb.max_pool_2x2(_nchw(x))))])
    return j, t


CASES = {
    "double_conv": lambda rng: _case_double_conv(rng, True),
    "double_conv_no_act": lambda rng: _case_double_conv(rng, False),
    "res_block": _case_res_block,
    "up_block": _case_up_block,
    "styled_denorm": _case_styled_denorm,
    "styled_up_nearest": lambda rng: _case_styled_up(rng, False),
    "styled_up_pixel_shuffle": lambda rng: _case_styled_up(rng, True),
    "aspp": _case_aspp,
    "instance_norm": _case_instance_norm,
    "pixel_shuffle": _case_pixel_shuffle,
    "upsample_pool": _case_upsample_pool,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name):
    rng = np.random.default_rng(7)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        want, got = CASES[name](rng)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fn", ["normalize", "t_normalize", "denormalize",
                                "denorm", "norm", "normalize_intensity"])
def test_windowing_matches_jax(fn):
    rng = np.random.default_rng(3)
    x = rng.uniform(-3000, 3000, size=(2, 8, 8, 1)).astype(np.float32)
    args = {
        "normalize": (1500, -550, 2.0),
        "t_normalize": (400, 20, 2.0),
        "denormalize": (4096, 0.0, 2.0),
        "denorm": (-1000.0, 400.0),
        "norm": (),
        "normalize_intensity": (0.0, 255.0),
    }[fn]
    if fn in ("denormalize", "denorm", "norm"):
        x = x / 3000.0
    want = np.asarray(getattr(jw, fn)(jnp.asarray(x), *args))
    got = getattr(tw, fn)(torch.from_numpy(x), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    # numpy arrays take the same path
    np.testing.assert_allclose(getattr(tw, fn)(x, *args), want, rtol=1e-6, atol=1e-4)
