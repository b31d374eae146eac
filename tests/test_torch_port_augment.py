"""Port warp / augmentation / one-hot vs the JAX package, on the CPU.

The augmentation tests replay the JAX functions' key splits
(`augment.py:78` geometric, `:163` photometric, `:227` per view) with
`jax.random` into the port's draws (`ops/augment.py` docstring), so both
sides apply the same random numbers. Tolerances (float32): bilinear images
atol 5e-5 (matrices built with the same formulas and inverted by two LAPACK
calls agree to ~1e-7 relative, so source coordinates of up to ~30 px agree
to ~1e-5 px, a little more through a projective division, times image
slopes of up to ~2 per px); matrices atol 1e-5 (offsets of up to ~30 px);
nearest warps and one-hot exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.ops import augment as jaug
from medical_image_editing_tpu.ops import onehot as joh
from medical_image_editing_tpu.ops import warp as jwarp
from medical_image_editing_tpu.utils.config import to_config as jto_config
from medical_image_editing_tpu_torch.ops import augment as taug
from medical_image_editing_tpu_torch.ops import onehot as toh
from medical_image_editing_tpu_torch.ops import warp as twarp

AUG = {
    "modules": ["RandomHorizontalFlip", "RandomAffine", "ColorJitter", "RandomGaussianBlur",
                "RandomPosterize", "RandomGaussianNoise"],
    "RandomHorizontalFlip": {"p": 0.5},
    "RandomAffine": {"degrees": 10.0, "translate": [0.05, 0.05], "shear": 5.0,
                     "scale": [0.9, 1.1], "p": 0.8},
    "ColorJitter": {"brightness": 0.2, "contrast": 0.2, "saturation": 0.0, "hue": 0.0,
                    "p": 0.5},
    "RandomGaussianBlur": {"kernel": 3, "sigma": 1.0, "p": 0.5},
    "RandomPosterize": {"bits": 5, "p": 0.5},
    "RandomGaussianNoise": {"std": 0.05, "p": 0.5},
}


def jax_view_draws(key, cfg, b, h, w, c=1):
    """The draws `jaug.random_transform(key, image, cfg)` makes, by replaying
    its key splits, as numpy arrays in the port's draw layout."""
    def get(name, default=None):
        return jaug._get(cfg, name, default)

    def maybe(k, mcfg):
        return np.asarray(jax.random.uniform(k, (b,)) < float(jaug._get(mcfg, "p", 0.5)))

    def uniform(k, shape, lo, hi):
        return np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))

    modules = list(get("modules", []) or [])
    k_geo, k_phot = jax.random.split(key)
    geo, phot = [], []
    key = k_geo
    for module in modules:
        key, k_p, k_a, k_b, k_c, k_d = jax.random.split(key, 6)
        mcfg = get(module)
        d = None
        if module == "RandomHorizontalFlip":
            d = {"apply": maybe(k_p, mcfg)}
        elif module == "RandomAffine":
            lo, hi = jaug._as_range(jaug._get(mcfg, "degrees", 0.0))
            scale, shear = jaug._get(mcfg, "scale"), jaug._as_range(jaug._get(mcfg, "shear"))
            d = {"apply": maybe(k_p, mcfg), "angle": uniform(k_a, (b,), lo, hi),
                 "translate": (uniform(k_b, (b, 2), -1.0, 1.0)
                               if jaug._get(mcfg, "translate") is not None else None),
                 "scale": (uniform(k_c, (b,), float(scale[0]), float(scale[1]))
                           if scale is not None else None),
                 "shear": uniform(k_d, (b,), *shear) if shear is not None else None}
        geo.append(d)
    key = k_phot
    for module in modules:
        key, k_p, k_a, k_b = jax.random.split(key, 4)
        mcfg = get(module)
        d = None
        if module == "ColorJitter":
            bright = float(jaug._get(mcfg, "brightness", 0.0) or 0.0)
            contrast = float(jaug._get(mcfg, "contrast", 0.0) or 0.0)
            d = {"apply": maybe(k_p, mcfg),
                 "brightness": (uniform(k_a, (b, 1, 1, 1), -bright, bright)
                                if bright > 0 else None),
                 "contrast": (uniform(k_b, (b, 1, 1, 1), max(0.0, 1.0 - contrast),
                                      1.0 + contrast) if contrast > 0 else None)}
        elif module in ("RandomGaussianBlur", "RandomPosterize"):
            d = {"apply": maybe(k_p, mcfg)}
        elif module == "RandomGaussianNoise":
            d = {"apply": maybe(k_p, mcfg),
                 "noise": np.asarray(jax.random.normal(k_a, (b, h, w, c)))}
        phot.append(d)
    return {"geo": geo, "phot": phot}


def to_torch_draws(draws):
    def conv(d):
        return None if d is None else {
            k: None if v is None else torch.from_numpy(np.array(v)) for k, v in d.items()}
    return {part: [conv(d) for d in ds] for part, ds in draws.items()}


def _image(b=3, h=24, w=20, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, size=(b, h, w, 1)).astype(np.float32)


def _mats(b, h, w, seed):
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(b):
        m = np.asarray(jwarp.affine_matrix(
            rng.uniform(-20, 20), rng.normal(size=2) * 2, rng.uniform(0.8, 1.2, 2),
            rng.uniform(-8, 8, 2), h, w))
        if rng.uniform() < 0.5:
            m = np.asarray(jwarp.hflip_matrix(w)) @ m
        mats.append(m)
    return np.stack(mats).astype(np.float32)


def test_affine_and_flip_matrices_match_jax():
    rng = np.random.default_rng(1)
    b, h, w = 5, 24, 20
    angle = rng.uniform(-30, 30, b).astype(np.float32)
    trans = rng.normal(size=(b, 2)).astype(np.float32) * 3
    scale = rng.uniform(0.7, 1.3, (b, 2)).astype(np.float32)
    shear = rng.uniform(-10, 10, (b, 2)).astype(np.float32)
    want = np.stack([np.asarray(jwarp.affine_matrix(*a, h, w))
                     for a in zip(angle, trans, scale, shear)])
    got = twarp.affine_matrix(*map(torch.from_numpy, (angle, trans, scale, shear)), h, w)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(twarp.hflip_matrix(w).numpy(),
                                  np.asarray(jwarp.hflip_matrix(w)))
    np.testing.assert_array_equal(twarp.identity_matrix(2).numpy(),
                                  np.asarray(jwarp.identity_matrix(2)))


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_warp_perspective_matches_jax(method):
    x = _image(3, 24, 20)
    x = np.concatenate([x, 2 * x], axis=-1)
    mats = _mats(3, 24, 20, seed=2)
    mats[0, 2, :2] = [1e-3, -2e-3]  # one projective matrix
    want = np.asarray(jwarp.warp_perspective(jnp.asarray(x), jnp.asarray(mats), method=method))
    got = twarp.warp_perspective(torch.from_numpy(x), torch.from_numpy(mats), method=method)
    if method == "nearest":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)


def test_nearest_ties_round_half_away_from_zero():
    """Half-pixel shifts put every source coordinate on a .5 tie: JAX's
    lax.round goes away from zero, where grid_sample would go to even."""
    ids = np.arange(2 * 8 * 10, dtype=np.float32).reshape(2, 8, 10) + 1
    mats = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    mats[0, :2, 2] = [0.5, -1.5]
    mats[1, :2, 2] = [-0.5, 2.5]
    mats[1, 0, 0] = -1.0  # with a flip: x → 9.5 − x ties on the other side
    mats[1, 0, 2] = 9.5
    want = np.asarray(jwarp.warp_ids_forward(jnp.asarray(ids), [jnp.asarray(mats)]))
    got = twarp.warp_ids_forward(torch.from_numpy(ids), [torch.from_numpy(mats)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).any() and (want == 0).any()
    want = np.asarray(jwarp.warp_ids_reverse(jnp.asarray(ids), [jnp.asarray(mats)]))
    got = twarp.warp_ids_reverse(torch.from_numpy(ids), [torch.from_numpy(mats)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_cross_view_transform_matches_jax():
    b, h, w = 3, 24, 20
    ids = np.random.default_rng(3).integers(0, 7, size=(b, h, w)).astype(np.int32)
    m1, m2 = _mats(b, h, w, 4), _mats(b, h, w, 5)
    want = np.asarray(jaug.cross_view_transform(jnp.asarray(ids), jnp.asarray(m1),
                                                jnp.asarray(m2)))
    got = taug.cross_view_transform(torch.from_numpy(ids), torch.from_numpy(m1),
                                    torch.from_numpy(m2)).numpy()
    # a nearest resample of random matrices: a coordinate within ~1e-6 of a
    # .5 boundary may round apart after two frameworks' inversions
    assert (got == want).mean() > 0.999


@pytest.mark.parametrize("cfg", ["lung", "all_modules"])
def test_random_transform_with_replayed_draws_matches_jax(cfg):
    import json
    import os

    if cfg == "lung":
        path = os.path.join(os.path.dirname(__file__), "..", "configs", "lung_first_stage.json")
        with open(path) as f:
            aug = json.load(f)["augmentation"]
    else:
        aug = AUG
    jcfg = jto_config(aug)
    image = _image(6, 24, 20, seed=6)
    key = jax.random.key(7)
    jn, jc, jm = jaug.random_transform(key, jnp.asarray(image), jcfg)
    draws = to_torch_draws(jax_view_draws(key, jcfg, 6, 24, 20))
    tn, tc, tm = taug.random_transform(torch.from_numpy(image), aug, draws)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=5e-5, rtol=0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=5e-5, rtol=0)
    # the draws did something: some samples warped, some noised
    assert not np.allclose(np.asarray(jc), image)
    assert not np.allclose(np.asarray(jn), np.asarray(jc))


def test_sampled_draws_have_the_replayed_layout():
    gen = torch.Generator().manual_seed(0)
    got = taug.sample_view_draws(gen, AUG, 4, 8, 6)
    want = jax_view_draws(jax.random.key(0), jto_config(AUG), 4, 8, 6)
    for part in ("geo", "phot"):
        for g, w in zip(got[part], want[part]):
            assert (g is None) == (w is None)
            if g is not None:
                assert sorted(g) == sorted(w)
                for k in g:
                    assert (g[k] is None) == (w[k] is None), k
                    if g[k] is not None:
                        assert tuple(g[k].shape) == w[k].shape, k
                        assert g[k].dtype == torch.tensor(w[k]).dtype, k
    # and the same generator state gives the same draws
    again = taug.sample_view_draws(torch.Generator().manual_seed(0), AUG, 4, 8, 6)
    assert torch.equal(got["phot"][-1]["noise"], again["phot"][-1]["noise"])


def test_one_hot_matches_jax():
    ids = np.random.default_rng(8).integers(-1, 9, size=(2, 5, 7)).astype(np.float32)
    want = np.asarray(joh.one_hot(jnp.asarray(ids), 8))
    got = toh.one_hot(torch.from_numpy(ids), 8)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
