"""Rank processes of `tests/test_torch_port_edit_partition.py`: each imports
torch and the port only, joins a gloo process group through a `file://`
rendezvous, runs its task on the inputs the test wrote (`inputs.pt`: the
flax-initialised decoder weights through the port's weight bridge, numpy
id maps from seeds) and saves what it computed for the test to hold
against JAX and the port's unpartitioned decodes.

Started with `torch.multiprocessing`'s spawn context:
`run(rank, world, init, task, workdir)`. The `packed_cuda` and
`row_halo_cuda` tasks are the card tests' (`tests/test_torch_port_gpu.py`):
the bf16 decode on the packed route, row-sharded on CUDA tensors, with its
kernel launches, and a row halo wider than a block on CUDA tensors.
"""

import collections
import contextlib
import io
import os

import torch
import torch.distributed as dist

from medical_image_editing_tpu_torch.parallel import mesh as pmesh

FILTERS = (4, 8, 16, 32, 64)
K = 6
CLI_DICT = 10  # LungConfig's dict_size


def decoder(inputs, dtype=None):
    """The port's decoder with the carried JAX weights."""
    from medical_image_editing_tpu_torch.models.unet_decoder import UNetDecoder

    dec = UNetDecoder(**inputs["decoder"], dtype=dtype)
    dec.load_state_dict(inputs["weights"], strict=True)
    return dec


def vq_state(inputs):
    from medical_image_editing_tpu_torch.ops.vq import VQState

    return VQState(*(t.clone() for t in inputs["vq"]))


@contextlib.contextmanager
def counted_packed():
    """Inside the block the packed route is on and each call of the packed
    convolution is counted (on the CPU it runs the plain version): yields
    the counter."""
    from medical_image_editing_tpu_torch.models import blocks

    real, calls = blocks.conv3x3_packed_trainable_nchw, collections.Counter()

    def counted(x, w):
        calls["packed"] += 1
        calls["rows"] += x.shape[2]
        return real(x, w)

    prev = os.environ.get("MEDIMG_CONV_IMPL")
    os.environ["MEDIMG_CONV_IMPL"] = "packed"
    blocks.conv3x3_packed_trainable_nchw = counted
    try:
        yield calls
    finally:
        blocks.conv3x3_packed_trainable_nchw = real
        if prev is None:
            del os.environ["MEDIMG_CONV_IMPL"]
        else:
            os.environ["MEDIMG_CONV_IMPL"] = prev


@contextlib.contextmanager
def zero_halos():
    """The planted fault: every halo exchange returns zeros."""
    from medical_image_editing_tpu_torch.parallel import spatial

    real = spatial._exchange
    spatial._exchange = lambda sends, group: {p: torch.zeros_like(t) for p, t in sends.items()}
    try:
        yield
    finally:
        spatial._exchange = real


def decode(inputs, mesh, partition, ids, dtype=None, record=None, **kw):
    """This rank's block of the decode of `ids` (global), with the
    collectives it issued (counts and log); with `record` a list, each
    convolution's (input block, output block) appended to it in call order."""
    from medical_image_editing_tpu_torch.cli import edit_batch as teb
    from medical_image_editing_tpu_torch.models.blocks import Conv

    dec = decoder(inputs, dtype)
    if record is not None:
        for m in dec.modules():
            if isinstance(m, Conv):
                m.register_forward_hook(lambda m, a, y: record.append((a[0].clone(), y.clone())))
    edit = teb.make_batched_edit_fn(dec, mesh=mesh, partition=partition, device="cpu", **kw)
    before = collections.Counter(pmesh.collectives)
    pmesh.collective_log = []
    try:
        out = edit(vq_state(inputs), mesh.block(ids))
        log = pmesh.collective_log
    finally:
        pmesh.collective_log = None
    return {"out": out, "collectives": dict(collections.Counter(pmesh.collectives) - before),
            "log": log}


def int8_convs(inputs, mesh):
    """Each of the test's convolutions (`inputs["convs"]`: a 3×3 and a
    dilated 3×3 with 18-row reach, row blocks of 16) in int8 on this rank's
    rows of the test's input: its block of the output."""
    from medical_image_editing_tpu_torch.models.blocks import Conv
    from medical_image_editing_tpu_torch.ops.quantized_conv import quantize_convs

    out = []
    for kw, sd in inputs["convs"]:
        conv = Conv(**kw)
        conv.load_state_dict(sd)
        conv.mesh = mesh
        with quantize_convs("int8"), torch.no_grad():
            out.append(conv(mesh.block(inputs["conv_x"], depth_axis=2)))
    return out


def refusal(fn):
    try:
        fn()
    except ValueError as e:
        return f"{type(e).__name__}: {e}"
    return None


def cli(workdir, argv):
    """`edit_batch.main` at the test widths (LungConfig's seeded weights)."""
    from medical_image_editing_tpu_torch.cli import edit_batch as teb
    from medical_image_editing_tpu_torch.cli import run_recon as trr

    trr.LungConfig.enc_filters = FILTERS
    trr.LungConfig.dec_filters = FILTERS
    os.environ.pop("LUNG_CKPT", None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = teb.main(argv)
    return {"rc": rc, "stdout": buf.getvalue()}


def task_two(rank, world, workdir):
    """Two ranks: the 1 × 2 spatial decodes (f32, uint8, int8; the planted
    zero halos; a bad label; a plain forward of a decoder after its
    partitioned decode), the 2 × 1 data decode and its refusals,
    `edit_study` with a padded tail under "data", and the CLI under both
    partitions."""
    from medical_image_editing_tpu_torch.cli import edit_batch as teb

    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    ids, lung = inputs["ids32"][:2], dict(is_lung=True)
    rows = pmesh.create_volumetric_mesh(1, 2)
    int8_calls = []
    out = {"spatial": {"f32": decode(inputs, rows, "spatial", ids, **lung),
                       "uint8": decode(inputs, rows, "spatial", ids, output_dtype="uint8",
                                       **lung),
                       "int8": decode(inputs, rows, "spatial", ids, quantize="int8",
                                      record=int8_calls, **lung)},
           "int8_calls": int8_calls, "int8_convs": int8_convs(inputs, rows)}
    with zero_halos():
        out["fault"] = decode(inputs, rows, "spatial", ids, **lung)["out"]
    dec = decoder(inputs)
    teb.make_batched_edit_fn(dec, mesh=rows, partition="spatial", device="cpu")(
        vq_state(inputs), rows.block(ids))
    before = collections.Counter(pmesh.collectives)
    with torch.no_grad():
        plain = dec(torch.zeros(1, FILTERS[0], 32, 32))
    out["after_partitioned"] = {
        "meshes_left": [n for n, m in dec.named_modules() if getattr(m, "mesh", None)],
        "collectives": dict(collections.Counter(pmesh.collectives) - before),
        "shape": tuple(plain.shape)}
    bad = ids.copy()
    bad[1, -1, 0] = K + 1  # in the last rank's rows only
    edit = teb.make_batched_edit_fn(decoder(inputs), mesh=rows, partition="spatial",
                                    device="cpu")
    out["bad_label"] = refusal(lambda: edit(vq_state(inputs), rows.block(bad)))

    batch = pmesh.create_volumetric_mesh(2, 1)
    out["data"] = decode(inputs, batch, "data", inputs["ids32"])
    out["refused"] = {
        "odd_batch": refusal(lambda: decode(inputs, batch, "data", inputs["ids32"][:3])),
        "data_on_rows": refusal(lambda: teb.make_batched_edit_fn(
            decoder(inputs), mesh=rows, partition="data", device="cpu")),
    }
    teb.edit_study(decoder(inputs), vq_state(inputs), inputs["label_dir"],
                   os.path.join(workdir, "study_data"), batch_size=2, is_lung=True,
                   mesh=batch, partition="data", device="cpu")
    base = ["--label-dir", inputs["cli_labels"], "--batch-size", "2", "--device", "cpu"]
    for name in ("spatial", "data"):
        out["cli_" + name] = cli(workdir, base + [
            "--partition", name, "--out-dir", os.path.join(workdir, f"cli_{name}")])
    return out


def task_four(rank, world, workdir):
    """Four ranks: the 2 × 2 spatial decode at 32², and the 1 × 4 one at
    64² (16 rows a rank: the ASPP's 18-row halo reaches two ranks), plain
    and on the packed route."""
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    lung = dict(is_lung=True)
    grid = pmesh.create_volumetric_mesh(2, 2)
    out = {"coords": grid.coords,
           "spatial22": decode(inputs, grid, "spatial", inputs["ids32"], **lung)}
    rows = pmesh.create_volumetric_mesh(1, 4)
    out["spatial14"] = decode(inputs, rows, "spatial", inputs["ids64"], **lung)
    with counted_packed() as calls:
        out["packed14"] = decode(inputs, rows, "spatial", inputs["ids64"], **lung)
    out["packed14"]["calls"] = dict(calls)
    return out


def task_packed_cuda(rank, world, workdir):
    """The bf16 decode on the packed route on CUDA tensors, rows over a
    1 × `world` mesh: this rank's block and the packed kernel's launches."""
    from medical_image_editing_tpu_torch.cli import edit_batch as teb
    from medical_image_editing_tpu_torch.ops import _build

    torch.cuda.set_device(0)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    rows = pmesh.create_volumetric_mesh(1, world)
    os.environ["MEDIMG_CONV_IMPL"] = "packed"
    edit = teb.make_batched_edit_fn(decoder(inputs, torch.bfloat16), mesh=rows,
                                    partition="spatial", is_lung=True, device="cuda")
    _build.launches.clear()
    out = edit(vq_state(inputs), rows.block(inputs["ids"])).cpu()
    return {"out": out, "launches": dict(_build.launches)}


def task_row_halo_cuda(rank, world, workdir):
    """`halo` of 6 rows on CUDA tensors of a 1 × `world` mesh, blocks of 4
    rows (the halo reaches two ranks each way): this rank's block of a
    global (2, 3, 4·world, 6) arange, forward, and the backward of a
    cotangent of the rank's number plus one in every row."""
    from medical_image_editing_tpu_torch.parallel.spatial import halo

    torch.cuda.set_device(0)
    mesh = pmesh.create_volumetric_mesh(1, world)
    x = torch.arange(2 * 3 * 4 * world * 6, dtype=torch.float32, device="cuda")
    x = mesh.block(x.reshape(2, 3, 4 * world, 6), depth_axis=2).clone().requires_grad_(True)
    y = halo(x, mesh, 6)
    y.backward(torch.full_like(y, rank + 1.0))
    return {"y": y.detach().cpu(), "dx": x.grad.cpu(), "device": str(y.device),
            "sent": pmesh.collectives["send"]}


TASKS = {"two": task_two, "four": task_four, "packed_cuda": task_packed_cuda,
         "row_halo_cuda": task_row_halo_cuda}


def run(rank, world, init, task, workdir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    try:
        out = TASKS[task](rank, world, workdir)
    finally:
        pmesh.destroy_distributed()
    torch.save(out, os.path.join(workdir, f"{task}-{rank}.pt"))
