"""The exported edit program (`cli/export_model.py`), port vs its eager decode
and vs JAX, on the CPU at small widths: encoder (4, 8, 8, 16, 16), decoder
(32, 8, 8, 16, 16) (its 32-channel convolutions at 32² and 16² route to
the packed kernel: 10 of them), `dict_size` 10, 32² slices.

Both packages decode with the same weights: drawn as the JAX package's
`load_model` draws them, and loaded by the port from a Lightning `.ckpt`
written with `utils/weights.py::from_jax_train_state` (as
`tests/test_torch_port_serve.py`).

Held: the exported program equals the port's eager `make_batched_edit_fn`
bit for bit at batch 1 and 3 (the same operations in the same order), for
f32 and bf16, on the xla and the packed conv routes, and with a uint8
output; the packed graph holds one `medimg::conv3x3_packed` node a routed
convolution and the xla graph none; the saved and loaded artifact, in this
process and in a fresh one that imports no model module, equals the eager
decode bit for bit; against JAX's `make_batched_edit_fn` and JAX's own
exported artifact (`platforms=("cpu",)`) the f32 program sits within atol
1e-4·4096/1500 (the lung re-window multiplies decoder differences by
4096/1500), and the bf16 one is held to JAX's bf16 decode as
`tests/test_torch_port_serve.py` holds the eager bf16 decode (correlation
above 0.99, the JAX package's own bar, and a largest difference no larger
than JAX's own f32-to-bf16 gap on the same maps). A label outside
[1 − K, K] raises before the program runs; the int8 decode is refused.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_image_editing_tpu.cli import edit_batch as jeb
from medical_image_editing_tpu.cli import export_model as jem
from medical_image_editing_tpu.cli import run_recon as jrr
from medical_image_editing_tpu_torch.cli import edit_batch as teb
from medical_image_editing_tpu_torch.cli import export_model as tem
from medical_image_editing_tpu_torch.cli import run_recon as trr
from medical_image_editing_tpu_torch.models.blocks import Conv
from medical_image_editing_tpu_torch.ops.quantized_conv import quantize_convs
from medical_image_editing_tpu_torch.utils.weights import from_jax_train_state

ROOT = Path(__file__).resolve().parent.parent
ENC = (4, 8, 8, 16, 16)
DEC = (32, 8, 8, 16, 16)
DICT = 10
SIZE = 32
ROUTED = 10  # the decoder's convolutions the packed route takes at 32²
LUNG_ATOL = 1e-4 * 4096 / 1500
OP = "medimg.conv3x3_packed"


def _tiny(module, ckpt=None, dtype=None):
    """A LungConfig of `module` (JAX or port) at the test widths."""

    class TinyConfig(module.LungConfig):
        enc_filters = ENC
        dec_filters = DEC

        def __init__(self):
            super().__init__()
            self.resume_checkpoint = ckpt
            self.edited_file_path = "edited.nii.gz"
            self.compute_dtype = dtype

    return TinyConfig()


def _jax_models():
    """The JAX encoder, the decoder in f32 and in bf16, and their variables
    drawn as the JAX `load_model` draws them, its inits jitted (un-jitted
    they take ~40 s here)."""
    from medical_image_editing_tpu.models import UNetDecoder
    from medical_image_editing_tpu.models.unet_encoder import EncoderWithVQ

    cfg = _tiny(jrr)
    encoder = EncoderWithVQ(in_channels=cfg.in_channels, filters=ENC, dict_size=cfg.dict_size,
                            momentum=cfg.momentum, use_styled_up_block=False)
    decoders = {dtype: UNetDecoder(out_channels=cfg.in_channels, filters=DEC,
                                   use_dropblock=bool(cfg.use_dropblock),
                                   block_size=int(cfg.block_size),
                                   dropped_skip_layers=tuple(cfg.dropped_skip_layers),
                                   use_pixel_shuffle=bool(cfg.use_pixel_shuffle), dtype=dtype)
                for dtype in (None, jnp.bfloat16)}

    @jax.jit
    def init():
        x0 = jnp.zeros((1, SIZE, SIZE, cfg.in_channels), jnp.float32)
        enc_vars, vq = encoder.init(jax.random.key(0), x0)
        q, *_ = encoder(enc_vars, vq, x0, train=False)
        dec_vars = decoders[None].init({"params": jax.random.key(1),
                                        "dropblock": jax.random.key(2)}, q, train=False)
        return enc_vars, dec_vars, vq

    enc_vars, dec_vars, vq = init()
    return decoders, SimpleNamespace(enc_vars=enc_vars, dec_vars=dec_vars, vq=vq)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX decoders (f32 and bf16 modules, one set of weights), a
    Lightning `.ckpt` of those weights, the port's decoders on it, and
    painted maps at batch 3 (one all-background slice, negative labels
    that wrap)."""
    tmp = tmp_path_factory.mktemp("export")
    jdecs, state = _jax_models()
    groups = from_jax_train_state(state)
    ckpt = str(tmp / "tiny.ckpt")
    torch.save({"state_dict": {f"{g}.{k}": v for g, sd in groups.items()
                               for k, v in sd.items()}}, ckpt)
    ports = {dtype: trr.load_model(_tiny(trr, ckpt, dtype), device="cpu")[1:]
             for dtype in (None, "bfloat16")}
    ids = np.random.default_rng(4).integers(1 - DICT, DICT + 1, (3, SIZE, SIZE)).astype(np.int32)
    ids[1] = 0
    return dict(jdec=jdecs[None], jdec16=jdecs[jnp.bfloat16], state=state, ckpt=ckpt,
                ports=ports, ids=ids, tmp=tmp, artifacts={})


def _artifact(world, route, dtype=None, output_dtype=None):
    """The program exported on the CPU (cached for the module; the packed
    f32 one is the CLI's, saved and loaded back: `cli_artifact`)."""
    key = (route, dtype, output_dtype)
    if key not in world["artifacts"]:
        dec, vq = world["ports"][dtype]
        prev = os.environ.get("MEDIMG_CONV_IMPL")
        os.environ["MEDIMG_CONV_IMPL"] = route
        try:
            world["artifacts"][key] = tem.export_edit_artifact(
                dec, vq, image_size=SIZE, is_lung=True, output_dtype=output_dtype,
                device="cpu")
        finally:
            if prev is None:
                os.environ.pop("MEDIMG_CONV_IMPL")
            else:
                os.environ["MEDIMG_CONV_IMPL"] = prev
    return world["artifacts"][key]


def _eager(world, route, dtype=None, output_dtype=None, batch=3, monkeypatch=None):
    dec, vq = world["ports"][dtype]
    monkeypatch.setenv("MEDIMG_CONV_IMPL", route)
    return teb.make_batched_edit_fn(dec, is_lung=True, output_dtype=output_dtype,
                                    device="cpu")(vq, world["ids"][:batch])


def _op_nodes(program):
    return sum(1 for n in program.graph.nodes
               if n.op == "call_function" and str(n.target).startswith(OP))


@pytest.mark.parametrize("route,dtype,output_dtype", [
    ("xla", None, None), ("packed", None, None), ("xla", "bfloat16", None),
    ("packed", "bfloat16", None), ("packed", None, "uint8")],
    ids=["xla-f32", "packed-f32", "xla-bf16", "packed-bf16", "packed-f32-uint8"])
def test_program_equals_eager_bit_for_bit(world, cli_artifact, monkeypatch, route, dtype,
                                          output_dtype):
    module = _artifact(world, route, dtype, output_dtype).program.module()
    for batch in (1, 3):
        want = _eager(world, route, dtype, output_dtype, batch, monkeypatch)
        with torch.inference_mode():
            got = module(torch.from_numpy(world["ids"][:batch]))
        assert got.dtype == want.dtype == (torch.uint8 if output_dtype else torch.float32)
        assert torch.equal(got, want), (batch, float((got.float() - want.float()).abs().max()))


@pytest.mark.parametrize("route", ["xla", "packed"])
def test_graph_holds_one_op_per_routed_conv(world, cli_artifact, monkeypatch, route):
    """The packed graph calls `medimg::conv3x3_packed` once per convolution
    that `Conv.routes_to_kernel` sends to the kernel; the xla graph never."""
    dec, _ = world["ports"][None]
    monkeypatch.setenv("MEDIMG_CONV_IMPL", route)
    routed = [0]
    hooks = [m.register_forward_pre_hook(
        lambda m, args: routed.__setitem__(0, routed[0] + int(m.routes_to_kernel(args[0]))))
        for m in dec.modules() if isinstance(m, Conv)]
    try:
        _eager(world, route, monkeypatch=monkeypatch, batch=1)
    finally:
        for h in hooks:
            h.remove()
    assert routed[0] == (ROUTED if route == "packed" else 0)
    assert _op_nodes(_artifact(world, route).program) == routed[0]


@pytest.fixture(scope="module")
def cli_artifact(world, tmp_path_factory):
    """The CLI's artifact (packed route, f32, from the `.ckpt` through
    LUNG_CKPT, the config's widths shrunk to the test's) and the eager
    decode of the same weights, saved for a fresh process. The artifact,
    loaded back, is also the module's packed f32 program (`_artifact`): the
    same weights, route and dtype, exported once."""
    out = tmp_path_factory.mktemp("cli") / "edit.pt2"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trr.LungConfig, "enc_filters", ENC)
        mp.setattr(trr.LungConfig, "dec_filters", DEC)
        mp.setenv("LUNG_CKPT", world["ckpt"])
        mp.setenv("MEDIMG_CONV_IMPL", "packed")
        mp.delenv("MEDIMG_EDIT_DTYPE", raising=False)
        assert tem.main(["--config", "lung", "--out", str(out), "--image-size", str(SIZE),
                         "--device", "cpu"]) == 0
        eager = {b: _eager(world, "packed", batch=b, monkeypatch=mp).numpy() for b in (1, 3)}
    for b, arr in eager.items():
        np.save(out.parent / f"eager{b}.npy", arr)
    world["artifacts"][("packed", None, None)] = tem.load_edit_artifact(str(out), device="cpu")
    return out, eager


def test_cli_refuses_random_weights_unless_asked(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("LUNG_CKPT", raising=False)
    assert tem.main(["--out", str(tmp_path / "a.pt2"), "--device", "cpu"]) == 1
    assert "--allow-random-init" in capsys.readouterr().err
    assert not (tmp_path / "a.pt2").exists()


@pytest.fixture(scope="module")
def loaded(world, cli_artifact):
    return world["artifacts"][("packed", None, None)]


def test_loaded_artifact_serves_any_batch_bit_for_bit(cli_artifact, loaded):
    call, eager = loaded, cli_artifact[1]
    assert call.meta["conv_impl"] == "packed" and call.meta["dict_size"] == DICT
    assert _op_nodes(call.program) == ROUTED
    ids = np.random.default_rng(4).integers(1 - DICT, DICT + 1, (3, SIZE, SIZE))
    ids = ids.astype(np.int32)
    ids[1] = 0
    for b in (1, 3):
        np.testing.assert_array_equal(call(ids[:b]).numpy(), eager[b])
        np.testing.assert_array_equal(call(torch.from_numpy(ids[:b])).numpy(), eager[b])


def test_labels_checked_before_the_program_runs(loaded):
    runs = []
    hook = loaded.module.register_forward_pre_hook(lambda m, args: runs.append(1))
    try:
        ids = np.ones((2, SIZE, SIZE), np.int32)
        loaded(ids)
        assert runs == [1]
        for bad in (DICT + 1, -DICT):
            ids[1, 3, 4] = bad
            with pytest.raises(ValueError,
                               match=rf"\[{bad}\] outside \[{1 - DICT}, {DICT}\]"):
                loaded(ids)
        with pytest.raises(ValueError, match="the artifact takes"):
            loaded(np.ones((2, SIZE, SIZE + 4), np.int32))
        assert runs == [1]
    finally:
        hook.remove()


def test_fresh_process_loads_without_models(cli_artifact):
    """A process that imports torch and the loader only (the operator's
    registration, `ops/conv_pack.py`) serves the artifact bit for bit, and
    no `medical_image_editing_tpu_torch.models` module is imported."""
    path, _ = cli_artifact
    code = (
        "import sys, numpy as np\n"
        "from medical_image_editing_tpu_torch.cli.export_model import load_edit_artifact\n"
        f"call = load_edit_artifact({str(path)!r}, device='cpu')\n"
        f"ids = np.random.default_rng(4).integers({1 - DICT}, {DICT + 1}, (3, {SIZE}, {SIZE}))\n"
        "ids = ids.astype(np.int32)\n"
        "ids[1] = 0\n"
        "out = {b: bool(np.array_equal(call(ids[:b]).numpy(),\n"
        f"                              np.load({str(path.parent)!r} + f'/eager{{b}}.npy')))\n"
        "       for b in (1, 3)}\n"
        "mods = sorted(m for m in sys.modules if m.startswith('medical_image_editing_tpu'))\n"
        "print('result:' + __import__('json').dumps({'equal': out, 'modules': mods}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(next(line for line in r.stdout.splitlines()
                          if line.startswith("result:"))[len("result:"):])
    assert res["equal"] == {"1": True, "3": True}
    assert not [m for m in res["modules"] if m.startswith("medical_image_editing_tpu_torch.models")
                or m.split(".")[0] == "medical_image_editing_tpu"], res["modules"]
    assert "medical_image_editing_tpu_torch.ops.conv_pack" in res["modules"]


def test_program_near_jax_and_its_artifact(world, tmp_path):
    """The f32 program against JAX's `make_batched_edit_fn` and JAX's own
    exported artifact (CPU platform) within LUNG_ATOL; the bf16 program
    against JAX's bf16 decode as the module docstring says."""
    ids = world["ids"]
    state = world["state"]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jeb.make_batched_edit_fn(world["jdec"], is_lung=True)(
            state.dec_vars, state.vq, jnp.asarray(ids)))
        want16 = np.asarray(jeb.make_batched_edit_fn(world["jdec16"], is_lung=True)(
            state.dec_vars, state.vq, jnp.asarray(ids)))
        blob = jem.export_edit_artifact(world["jdec"], state.dec_vars, state.vq,
                                        image_size=SIZE, is_lung=True, platforms=("cpu",))
        jem.save_edit_artifact(str(tmp_path / "jax.bin"), blob)
        jax_artifact = np.asarray(jem.load_edit_artifact(str(tmp_path / "jax.bin"))(ids))
    with torch.inference_mode():
        got = _artifact(world, "xla").program.module()(torch.from_numpy(ids)).numpy()
        got16 = _artifact(world, "packed", "bfloat16").program.module()(
            torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=LUNG_ATOL, rtol=0)
    np.testing.assert_allclose(got, jax_artifact, atol=LUNG_ATOL, rtol=0)
    assert np.corrcoef(got16.ravel(), want16.ravel())[0, 1] > 0.99
    assert np.abs(got16 - want16).max() <= np.abs(want16 - want).max()


def test_int8_decode_is_refused(world):
    dec, vq = world["ports"][None]
    with quantize_convs("int8"), pytest.raises(ValueError, match="int8 decode is not exported"):
        tem.export_edit_artifact(dec, vq, image_size=SIZE, device="cpu")


def test_artifact_loads_only_on_its_device_type(cli_artifact):
    with pytest.raises(ValueError, match="exported on cpu"):
        tem.load_edit_artifact(str(cli_artifact[0]), device="meta")
