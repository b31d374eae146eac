"""Port encoder/decoder and weight bridge vs the JAX package.

The JAX models are initialised by flax at small widths, their variables (with
perturbed BatchNorm running stats, so the bridge's stats mapping is
exercised) go through the port's bridge, and both sides run the same numpy
inputs; JAX under `default_matmul_precision("highest")`. Tolerance atol
1e-4 in f32: two-pass vs lane-packed InstanceNorm and a different
convolution summation order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.models import UNetDecoder as JDecoder
from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ as JEncoder
from medical_image_editing_tpu.ops import vq as jvq
from medical_image_editing_tpu.utils import torch_export
from medical_image_editing_tpu_torch.models import UNetDecoder, UNetEncoder
from medical_image_editing_tpu_torch.models.unet_encoder import (
    EncoderWithVQ,
    encode_quantize,
)
from medical_image_editing_tpu_torch.utils import weights as bridge

ENC = (4, 8, 8, 16, 16)
DEC = (8, 8, 16, 16, 32)
DICT = 6
ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(variables, rng):
    def walk(tree):
        if "mean" in tree and "var" in tree:
            c = tree["mean"].shape[0]
            return {"mean": rng.normal(size=c).astype(np.float32) * 0.3,
                    "var": rng.uniform(0.5, 2.0, size=c).astype(np.float32)}
        return {k: walk(v) for k, v in tree.items()}
    out = dict(variables)
    if "batch_stats" in out:
        out["batch_stats"] = walk(out["batch_stats"])
    return out


@functools.cache
def jax_encoder(styled=False, seed=0):
    enc = JEncoder(filters=ENC, dict_size=DICT, use_styled_up_block=styled)
    enc_vars, vq = enc.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 1)))
    enc_vars = _perturb(_np_tree(enc_vars), np.random.default_rng(seed))
    return enc, enc_vars, jvq.VQState(*(np.asarray(a) for a in vq))


@functools.cache
def jax_decoder(use_pixel_shuffle=False, last_ps=False, seed=1):
    dec = JDecoder(out_channels=1, filters=DEC, dropped_skip_layers=(),
                   use_pixel_shuffle=use_pixel_shuffle,
                   use_last_pixel_shuffle=last_ps)
    dec_vars = dec.init({"params": jax.random.key(seed),
                         "dropblock": jax.random.key(seed + 1)},
                        jnp.zeros((1, 32, 32, ENC[0])), train=False)
    return dec, _perturb(_np_tree(dec_vars), np.random.default_rng(seed))


def port_encoder(enc_vars, vq, styled=False, backend="xla"):
    m = EncoderWithVQ(1, ENC, DICT, use_styled_up_block=styled, knn_backend=backend)
    m.load_state_dict(bridge.from_jax_encoder(enc_vars, vq), strict=True)
    return m.eval()


def port_decoder(dec_vars, use_pixel_shuffle=False, last_ps=False):
    m = UNetDecoder(ENC[0], 1, DEC, dropped_skip_layers=(),
                    use_pixel_shuffle=use_pixel_shuffle, use_last_pixel_shuffle=last_ps)
    m.load_state_dict(bridge.from_jax_decoder(dec_vars), strict=True)
    return m.eval()


def _same_state_dicts(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].numpy().dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("styled", [False, True])
def test_bridge_encoder_equals_jax_export(styled):
    _, enc_vars, vq = jax_encoder(styled)
    got = bridge.from_jax_encoder(enc_vars, vq)
    _same_state_dicts(got, torch_export.export_unet_encoder(enc_vars, vq))
    port_encoder(enc_vars, vq, styled)  # loads strictly
    # the plain UNetEncoder takes the same keys without the codebook
    UNetEncoder(1, ENC, styled).load_state_dict(bridge.from_jax_encoder(enc_vars),
                                                strict=True)


@pytest.mark.parametrize("ps,last_ps", [(False, False), (True, False), (False, True)])
def test_bridge_decoder_equals_jax_export(ps, last_ps):
    _, dec_vars = jax_decoder(ps, last_ps)
    got = bridge.from_jax_decoder(dec_vars)
    _same_state_dicts(got, torch_export.export_unet_decoder(dec_vars))
    port_decoder(dec_vars, ps, last_ps)


def test_bridge_reads_lightning_ckpt(tmp_path):
    _, enc_vars, vq = jax_encoder()
    _, dec_vars = jax_decoder()
    path = torch_export.save_lightning_ckpt(str(tmp_path / "m.ckpt"), {
        "encoder": torch_export.export_unet_encoder(enc_vars, vq),
        "decoder": torch_export.export_unet_decoder(dec_vars),
    }, epoch=3, step=7)
    groups = bridge.load_lightning_state(path)
    assert sorted(groups) == ["decoder", "encoder"]
    enc = EncoderWithVQ(1, ENC, DICT)
    enc.load_state_dict(groups["encoder"], strict=True)
    port_decoder(dec_vars).load_state_dict(groups["decoder"], strict=True)
    np.testing.assert_array_equal(enc.vq.state().embed_avg.numpy(), vq.embed_avg)


@pytest.mark.parametrize("styled", [False, True])
def test_encoder_features_match_jax(styled):
    enc, enc_vars, vq = jax_encoder(styled)
    x = np.random.default_rng(5).normal(size=(2, 32, 32, 1)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(enc.module.apply(enc_vars, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port_encoder(enc_vars, vq, styled)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_encode_quantize_ids_match_jax(backend):
    enc, enc_vars, vq = jax_encoder()
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 1)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        feats = enc.module.apply(enc_vars, jnp.asarray(x), train=False)
        jenc = JEncoder(filters=ENC, dict_size=DICT, knn_backend=backend)
        _, jcommit, jids, _, _ = jenc(enc_vars, jvq.VQState(*map(jnp.asarray, vq)),
                                      jnp.asarray(x), train=False)
    scores = np.asarray(2.0 * np.asarray(feats).reshape(-1, ENC[0]) @ vq.embed.T
                        - (vq.embed**2).sum(1))
    top2 = np.sort(scores, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0] > 1e-3).reshape(2, 32, 32)
    assert clear.mean() > 0.9

    port = port_encoder(enc_vars, vq, backend=backend)
    with torch.no_grad():
        q, commit, ids, state = encode_quantize(port, port.vq.state(), torch.from_numpy(x),
                                                backend=backend, train=False)
    ids = ids.numpy()
    assert ids.dtype == np.int32 and ids.min() >= 1 and ids.max() <= DICT
    np.testing.assert_array_equal(ids[clear], np.asarray(jids)[clear])
    # straight-through x + (q - x) rounds once
    np.testing.assert_allclose(q.numpy(), vq.embed[ids - 1], atol=1e-6, rtol=0)
    # the features agree to ~1e-4, not to f32 rounding
    np.testing.assert_allclose(float(commit), float(jcommit), rtol=1e-3)


@pytest.mark.parametrize("ps,last_ps", [(False, False), (True, False), (False, True)])
def test_decoder_matches_jax(ps, last_ps):
    dec, dec_vars = jax_decoder(ps, last_ps)
    emb = np.random.default_rng(8).normal(size=(2, 32, 32, ENC[0])).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(dec.apply(dec_vars, jnp.asarray(emb), False))
    with torch.no_grad():
        got = port_decoder(dec_vars, ps, last_ps)(torch.from_numpy(emb).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=0)
