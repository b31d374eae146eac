"""Volumetric checkpoints crossing between the JAX package and the port
(`tools/volumetric_ckpt.py`, `utils/weights.py::to_jax_volumetric`), on
the CPU at the JAX package's own test sizes: filters (4, 8, 16),
`dict_size` 5, 16³ volumes, batch 2.

An Orbax directory in the layout of the JAX package's `train_volumetric`
(its flax variables and codebook, saved with Orbax's StandardCheckpointer)
goes to the port's `state.pt`; the port's decoder on it matches JAX's
`make_volumetric_edit_fn` on the original variables within atol 1e-4, the
tolerance of `tests/test_torch_port_volumetric.py` (instance norm divides
the convolutions' rounding residue by the channel's standard deviation).
Both directions move float32 arrays without arithmetic, so the round trips
are held bit for bit, and JAX's `load_volumetric_checkpoint` restores what
`to-jax` writes.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from medical_image_editing_tpu.cli import edit_volume as jedit
from medical_image_editing_tpu.models import volumetric as jvol
from medical_image_editing_tpu.ops.vq import vq_init
from medical_image_editing_tpu_torch.cli import edit_volume as tedit
from medical_image_editing_tpu_torch.utils.checkpoint import load_state_file
from medical_image_editing_tpu_torch.utils.weights import from_jax_volumetric, to_jax_volumetric

ROOT = Path(__file__).resolve().parent.parent
FILTERS = (4, 8, 16)
K = 5
CUBE = (2, 16, 16, 16, 1)


def _tool():
    spec = importlib.util.spec_from_file_location("volumetric_ckpt",
                                                  ROOT / "tools" / "volumetric_ckpt.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """The JAX package's volumetric variables (its inits jitted) saved as its
    `train_volumetric` saves them: an Orbax directory of {"enc", "dec",
    "vq": {embed, cluster_size, embed_avg}}."""
    enc = jvol.VolumetricUNetEncoder(filters=FILTERS)
    dec = jvol.VolumetricUNetDecoder(out_channels=1, filters=FILTERS)

    @jax.jit
    def init(key):
        k0, k1, k2 = jax.random.split(key, 3)
        x0 = jnp.zeros(CUBE, jnp.float32)
        ev = enc.init(k0, x0, train=False)
        return ev, dec.init(k1, enc.apply(ev, x0, train=False), train=False), \
            vq_init(k2, K, FILTERS[0])

    ev, dv, vq = init(jax.random.key(0))
    # a trained codebook's statistics are not the init's constants
    vq = vq._replace(cluster_size=jnp.linspace(0.5, 3.0, K),
                     embed_avg=vq.embed * 1.5 + 0.25)
    tree = {"enc": ev, "dec": dv, "vq": {"embed": vq.embed, "cluster_size": vq.cluster_size,
                                         "embed_avg": vq.embed_avg}}
    path = tmp_path_factory.mktemp("jax") / "volumetric_ckpt"
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(path), tree, force=True)
    ckptr.wait_until_finished()
    return {"path": path, "tree": jax.tree.map(np.asarray, tree), "dec": dec, "dv": dv,
            "vq": vq}


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_to_port_decodes_as_jax(jax_ckpt, tmp_path):
    """to-port, then the port's `edit_volume` CLI on the converted directory:
    the decode of JAX's `make_volumetric_edit_fn` on the original
    variables, within atol 1e-4."""
    port = tmp_path / "port" / "volumetric_ckpt"
    _tool().main(["to-port", "--src", str(jax_ckpt["path"]), "--out", str(port)])
    ids = np.random.default_rng(3).integers(0, K + 1, CUBE[:4]).astype(np.int32)
    ids[1, :4] = 0
    labels = tmp_path / "labels"
    labels.mkdir()
    for i, vol in enumerate(ids):
        np.save(labels / f"vol{i}.npy", vol)
    tedit.main(["--ckpt", str(port), "--labels", str(labels), "--out", str(tmp_path / "out"),
                "--filters", ",".join(map(str, FILTERS)), "--dict-size", str(K),
                "--device", "cpu"])
    got = np.stack([np.load(tmp_path / "out" / f"edited_vol{i}.npy") for i in range(2)])
    want = np.asarray(jedit.make_volumetric_edit_fn(jax_ckpt["dec"])(
        jax_ckpt["dv"], jax_ckpt["vq"], jnp.asarray(ids)))
    assert got.shape == want.shape == CUBE[:4]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_to_port_is_the_bridge_bit_for_bit(jax_ckpt, tmp_path):
    """to-port writes exactly `from_jax_volumetric` of the saved variables."""
    port = tmp_path / "volumetric_ckpt"
    _tool().to_port(str(jax_ckpt["path"]), str(port))
    tree = jax_ckpt["tree"]

    class VQ:
        embed, cluster_size, embed_avg = (tree["vq"][k] for k in
                                          ("embed", "cluster_size", "embed_avg"))

    want = from_jax_volumetric(tree["enc"], tree["dec"], VQ)
    got = load_state_file(str(port))
    assert sorted(got) == sorted(want) == ["dec", "enc", "vq"]
    for part in want:
        assert sorted(got[part]) == sorted(want[part])
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)


def test_round_trip_reproduces_the_orbax_tree(jax_ckpt, tmp_path):
    """to-port then to-jax: every array of the Orbax tree bit for bit, and
    JAX's `load_volumetric_checkpoint` restores the result (its decoder
    variables and codebook equal the originals)."""
    tool = _tool()
    port, back = tmp_path / "port", tmp_path / "back"
    tool.to_port(str(jax_ckpt["path"]), str(port))
    tool.to_jax(str(port), str(back))
    restored = ocp.StandardCheckpointer().restore(str(back))
    _assert_trees_equal(jax.tree.map(np.asarray, restored), jax_ckpt["tree"])
    decoder, dec_vars, vq = jedit.load_volumetric_checkpoint(str(back), filters=FILTERS,
                                                             dict_size=K)
    assert isinstance(decoder, jvol.VolumetricUNetDecoder)
    _assert_trees_equal(jax.tree.map(np.asarray, dec_vars), jax_ckpt["tree"]["dec"])
    for name in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_array_equal(np.asarray(getattr(vq, name)),
                                      jax_ckpt["tree"]["vq"][name])


def test_port_round_trip_bit_for_bit(jax_ckpt, tmp_path):
    """A port checkpoint → to-jax → to-port: every tensor bit for bit; and
    `to_jax_volumetric` inverts `from_jax_volumetric` in memory."""
    tool = _tool()
    port = tmp_path / "port"
    tool.to_port(str(jax_ckpt["path"]), str(port))
    tool.to_jax(str(port), str(tmp_path / "jax"))
    tool.to_port(str(tmp_path / "jax"), str(tmp_path / "port2"))
    first, second = load_state_file(str(port)), load_state_file(str(tmp_path / "port2"))
    for part in first:
        assert sorted(first[part]) == sorted(second[part])
        for k, v in first[part].items():
            assert v.dtype == torch.float32 and torch.equal(second[part][k], v), (part, k)
    _assert_trees_equal(to_jax_volumetric(first), jax_ckpt["tree"])
