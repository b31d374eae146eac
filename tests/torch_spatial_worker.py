"""Rank processes of `tests/test_torch_port_volumetric_spatial.py`: each
imports torch and the port only, joins a gloo process group through a
`file://` rendezvous, runs its task on the inputs the test wrote
(`inputs.pt`: the flax-initialised weights through the port's weight
bridge, numpy volumes from seeds) and saves what it computed for the test
to hold against JAX and the port's unsharded runs.

Started with `torch.multiprocessing`'s spawn context:
`run(rank, world, init, task, workdir)`. The `halo_cuda` task is the card
test's (`tests/test_torch_port_gpu.py`): the halo exchange on CUDA
tensors, which gloo stages through host memory.
"""

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from medical_image_editing_tpu_torch.parallel import mesh as pmesh

FILTERS = (4, 8, 16)
K = 5
LR = 1e-4


def models(inputs, mesh=None, dtype=None, use_remat=False):
    """The port's encoder, decoder, codebook and Adams from the carried JAX
    weights, with the step built over `mesh`."""
    from medical_image_editing_tpu_torch.ops.vq import VQState
    from medical_image_editing_tpu_torch.train import volumetric as tvt

    enc, dec, _, eo, do = tvt.init_volumetric(
        torch.Generator().manual_seed(0), filters=FILTERS, dict_size=K,
        volume_shape=inputs["shape"], lr=LR, dtype=dtype, use_remat=use_remat, device="cpu")
    enc.load_state_dict(inputs["weights"]["enc"], strict=True)
    dec.load_state_dict(inputs["weights"]["dec"], strict=True)
    vq = VQState(*(t.clone() for t in inputs["vq"]))
    step = tvt.make_volumetric_train_step(enc, dec, eo, do, mesh=mesh)
    return enc, dec, vq, eo, do, step


def snapshot(enc, dec, eo, do, vq):
    """Parameters, Adam's moments and steps, gradients, codebook."""
    out = {"vq": [t.clone() for t in vq]}
    for part, module, opt in (("enc", enc, eo), ("dec", dec, do)):
        params = dict(module.named_parameters())
        out[part] = {k: v.detach().clone() for k, v in params.items()}
        out[part + "_grad"] = {k: v.grad.clone() for k, v in params.items()}
        for key in ("exp_avg", "exp_avg_sq", "step"):
            out[f"{part}_{key}"] = {k: opt.state[v][key].clone() for k, v in params.items()}
    return out


def run_steps(inputs, mesh, vols, dtype=None, use_remat=False, log=False):
    """Steps on this rank's blocks of `vols`; per step the metrics and the
    snapshot after it, and with `log` the collectives each step issued."""
    enc, dec, vq, eo, do, step = models(inputs, mesh, dtype, use_remat)
    out = []
    for v in vols:
        pmesh.collective_log = [] if log else None
        try:
            vq, m = step(vq, mesh.block(v))
            out.append({"m": {k: float(x) for k, x in m.items()},
                        "after": snapshot(enc, dec, eo, do, vq),
                        "log": pmesh.collective_log})
        finally:
            pmesh.collective_log = None
    return out


@contextlib.contextmanager
def averaged_vq_statistics():
    """Inside the block the VQ averages its counts and sums over the ranks
    (`pmean`, the data-parallel trainers' rule) where it should sum them."""
    from medical_image_editing_tpu_torch.ops import vq as tvq

    real = tvq.psum
    tvq.psum = pmesh.pmean
    try:
        yield
    finally:
        tvq.psum = real


def layer_parts(inputs, mesh):
    """The halo conv (a 3×3×3 `Conv3d`, f32) and the sharded instance norm
    on this rank's depth block of the test's input: the outputs, the input
    gradients of the test's cotangent, the conv's weight and bias gradients
    (this rank's part of them)."""
    from medical_image_editing_tpu_torch.models import volumetric as tvol

    x = mesh.block(inputs["layer_x"], depth_axis=2).clone().requires_grad_(True)
    g = mesh.block(inputs["layer_g"], depth_axis=2)
    conv = tvol.Conv3d(x.shape[1], g.shape[1], 3, padding=1)
    conv.load_state_dict(inputs["layer_conv"])
    conv.mesh = mesh
    y = conv(x)
    y.backward(g)
    out = {"conv": {"y": y.detach(), "dx": x.grad.clone(), "dw": conv.weight.grad.clone(),
                    "db": conv.bias.grad.clone()}}
    x.grad = None
    xn = mesh.block(inputs["norm_x"], depth_axis=2).clone().requires_grad_(True)
    yn = tvol.instance_norm_3d(xn, mesh)
    yn.backward(mesh.block(inputs["norm_g"], depth_axis=2))
    out["norm"] = {"y": yn.detach(), "dx": xn.grad.clone()}
    return out


def refusal(fn):
    try:
        fn()
    except (ValueError, SystemExit) as e:
        return f"{type(e).__name__}: {e}"
    return None


def decode_parts(inputs, mesh):
    """`make_volumetric_edit_fn(mesh=)` on this rank's depth block of the
    test's painted ids, in f32 and uint8; a painted label past the codebook
    on one rank's block only, which every rank must refuse."""
    from medical_image_editing_tpu_torch.cli import edit_volume as tedit
    from medical_image_editing_tpu_torch.ops.vq import VQState

    _, dec, vq, *_ = models(inputs)
    vq = VQState(*inputs["vq"])
    ids = inputs["ids"]
    out = {}
    for name, dtype in (("f32", None), ("uint8", "uint8")):
        edit = tedit.make_volumetric_edit_fn(dec, mesh=mesh, output_dtype=dtype, device="cpu")
        out[name] = edit(vq, mesh.block(ids))
    bad = ids.copy()
    bad[0, -1, 0, 0] = K + 1  # in the last rank's block only
    out["bad_label"] = refusal(lambda: edit(vq, mesh.block(bad)))
    return out


def cli_parts(rank, workdir, inputs):
    """`train_volumetric --mesh 1,2` and `edit_volume --partition spatial`
    (f32 and `--uint8`) on this group, as under torchrun."""
    import io
    from contextlib import redirect_stdout

    from medical_image_editing_tpu_torch.cli import edit_volume, train_volumetric

    out = {}
    buf = io.StringIO()
    with redirect_stdout(buf):
        out["train_rc"] = train_volumetric.main(inputs["train_argv"] + [
            "--mesh", "1,2", "--out", os.path.join(workdir, "train_mesh")])
    out["train_stdout"] = buf.getvalue()
    for name, extra in (("edit_mesh", []), ("edit_mesh_u8", ["--uint8"])):
        with redirect_stdout(io.StringIO()):
            out[name] = edit_volume.main(inputs["edit_argv"] + extra + [
                "--partition", "spatial", "--out", os.path.join(workdir, name)])
    return out


def task_two(rank, world, workdir):
    """The 1 × 2 mesh: the layers, two f32 steps, bf16 steps with and
    without remat (collectives logged), the decode, the refusals, the CLIs."""
    from medical_image_editing_tpu_torch.cli import train_volumetric
    from medical_image_editing_tpu_torch.models import volumetric as tvol

    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh = pmesh.create_volumetric_mesh(1, 2)
    out = {"layers": layer_parts(inputs, mesh),
           "f32": run_steps(inputs, mesh, inputs["vols"]),
           "bf16_remat": run_steps(inputs, mesh, inputs["vols"][:1], torch.bfloat16, True,
                                   log=True),
           "bf16": run_steps(inputs, mesh, inputs["vols"][:1], torch.bfloat16, log=True),
           "decode": decode_parts(inputs, mesh)}
    enc = tvol.VolumetricUNetEncoder(filters=FILTERS)
    enc.set_mesh(mesh)
    out["refused"] = {  # a depth of 12 on 2 ranks: 6 slabs a rank, 2 pooling levels
        "depth": refusal(lambda: enc(torch.zeros(1, 1, 6, 16, 16))),
        "mesh_size": refusal(lambda: pmesh.create_volumetric_mesh(2, 2)),
        "no_mesh": refusal(lambda: train_volumetric.main(
            ["--steps", "1", "--size", "8", "--device", "cpu"])),
    }
    out.update(cli_parts(rank, workdir, inputs))
    return out


def task_four(rank, world, workdir):
    """The 2 × 2 mesh: two f32 steps; one step with the VQ statistics
    averaged instead of summed (the planted fault)."""
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh = pmesh.create_volumetric_mesh(2, 2)
    out = {"coords": mesh.coords, "f32": run_steps(inputs, mesh, inputs["vols"])}
    with averaged_vq_statistics():
        out["averaged"] = run_steps(inputs, mesh, inputs["vols"][:1])
    return out


def task_halo_cuda(rank, world, workdir):
    """`halo` on CUDA tensors of a 1 × `world` mesh: this rank's
    block of a global (2, 3, 4·world, 5, 6) arange, forward, and the
    backward of a cotangent of the rank's number plus one in every slab."""
    from medical_image_editing_tpu_torch.parallel.spatial import halo

    torch.cuda.set_device(0)
    mesh = pmesh.create_volumetric_mesh(1, world)
    x = torch.arange(2 * 3 * 4 * world * 5 * 6, dtype=torch.float32, device="cuda")
    x = mesh.block(x.reshape(2, 3, 4 * world, 5, 6), depth_axis=2).clone().requires_grad_(True)
    y = halo(x, mesh)
    y.backward(torch.full_like(y, rank + 1.0))
    return {"y": y.detach().cpu(), "dx": x.grad.cpu(), "device": str(y.device),
            "sent": pmesh.collectives["send"]}


TASKS = {"two": task_two, "four": task_four, "halo_cuda": task_halo_cuda}


def run(rank, world, init, task, workdir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    try:
        out = TASKS[task](rank, world, workdir)
    finally:
        pmesh.destroy_distributed()
    torch.save(out, os.path.join(workdir, f"{task}-{rank}.pt"))
