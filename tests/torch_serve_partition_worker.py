"""Rank processes of `tests/test_torch_port_serve_partition.py`: each imports
torch and the port only, joins a gloo process group through a `file://`
rendezvous, waits for the test's inputs (`inputs.pt`: a Lightning `.ckpt`
of the JAX package's weights, numpy id maps), runs the partitioned
services on them and saves what it saw for the test to hold against JAX
and the port's unpartitioned service.

Started with `torch.multiprocessing`'s spawn context:
`run(rank, world, init, task, workdir, timeout_s)`; `timeout_s` is the
process group's timeout (None: PyTorch's default), the groups made with
`parallel/mesh.py::init_process_group`, which records it.
"""

import contextlib
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch

from medical_image_editing_tpu_torch.parallel import mesh as pmesh

FILTERS = (4, 8, 16, 32, 64)
SIZE = 64
INPUTS_WAIT_S = 120
IDLE_TIMEOUT_S = 3.0  # the process group's timeout in the idle task
IDLE_S = 2.5 * IDLE_TIMEOUT_S  # how long rank 0 leaves its follower waiting there


def tiny_config(ckpt, partition=None, edited=None, save_dir="inference"):
    """The port's LungConfig at the test widths, its weights from `ckpt`."""
    from medical_image_editing_tpu_torch.cli import run_recon as trr

    class TinyConfig(trr.LungConfig):
        enc_filters = FILTERS
        dec_filters = FILTERS

        def __init__(self):
            self.resume_checkpoint = ckpt
            self.edited_file_path = edited
            self.save_dir_path = save_dir
            self.compute_dtype = None
            if partition is not None:
                self.partition = partition

    return TinyConfig()


def npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def post(url, body):
    """(status, body) of a POST."""
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def service_edits(inputs, partition, mesh=None):
    """One map, a batch of three and the uint8 decode of the map through
    `EditService(partition=)`: rank 0's results and the collectives of its
    one-map request; the other ranks' ops followed."""
    from medical_image_editing_tpu_torch.cli.serve_http import EditService

    service = EditService(tiny_config(inputs["ckpt"]), partition=partition, device="cpu",
                          mesh=mesh)
    out = {"batch_multiple": service._batch_multiple, "mesh": (service.mesh.data,
                                                               service.mesh.spatial)}
    try:
        if service.rank > 0:
            out["followed"] = dict(service.follow())
            return out
        before = dict(pmesh.collectives)
        out["one"] = service.edit(inputs["one"])[0]
        out["one_collectives"] = {k: v - before.get(k, 0) for k, v in pmesh.collectives.items()
                                  if v != before.get(k, 0)}
        out["three"] = service.edit(inputs["three"])[0]
        out["one_u8"] = service.edit(inputs["one"], uint8=True)[0]
    finally:
        service.close()
    return out


def http_round_trip(inputs, partition="spatial"):
    """Rank 0 serves a 1 × 2 "spatial" (or a 2 × 1 "data") service on a
    local port and a client thread of its own posts to it: under "spatial"
    /healthz, an .npy, a PNG and a label past the codebook (400); under both
    a map the decoder's four poolings do not divide on every rank (400),
    then a good request; rank 1 follows."""
    from medical_image_editing_tpu_torch.cli.serve_http import EditService, make_handler

    service = EditService(tiny_config(inputs["ckpt"]), partition=partition, device="cpu")
    if service.rank > 0:
        try:
            return {"followed": dict(service.follow())}
        finally:
            service.close()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    out = {}
    try:
        if partition == "spatial":
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                out["healthz"] = json.loads(r.read())
            out["npy"] = post(url + "/edit", npy(inputs["one"]))
            out["png"] = post(url + "/edit?format=png", npy(inputs["one"]))
            bad = inputs["one"].copy()
            bad[5, 7] = 10 + 1  # past LungConfig's 10 codes
            out["bad"] = post(url + "/edit", npy(bad))
            # 40 columns; rows 32 a rank
            out["bad_shape"] = post(url + "/edit", npy(inputs["one"][:, :40]))
        else:  # 3 maps of 40 rows
            out["bad_shape"] = post(url + "/edit", npy(inputs["three"][:, :40]))
        out["after_bad"] = post(url + "/edit", npy(inputs["three"]))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        service.close()
    return out


def recon_edit_fn(inputs):
    """`run_recon.make_edit_fn` with `config.partition = "spatial"` on every
    rank with the whole map: the gathered (recon, mask)."""
    from medical_image_editing_tpu_torch.cli import run_recon as trr

    cfg = tiny_config(inputs["ckpt"], partition="spatial")
    _, dec, vq = trr.load_model(cfg, device="cpu")
    recon, mask = trr.make_edit_fn(dec, vq, cfg, device="cpu")(inputs["recon_map"][None])
    return {"recon": recon, "mask": mask}


def recon_serve(inputs, rank, workdir):
    """`run_recon.main --partition spatial` on every rank, two passes over
    the map rank 0 watches (one decode, one skip), each rank in a directory
    of its own: its stdout and the files it wrote."""
    from medical_image_editing_tpu_torch.cli import run_recon as trr

    here = os.path.join(workdir, f"recon-serve-{rank}")
    os.makedirs(here)
    saved = {k: getattr(trr.LungConfig, k) for k in ("enc_filters", "dec_filters")}
    env = {k: os.environ.get(k) for k in ("LUNG_CKPT", "LUNG_EDITED_FILE")}
    cwd = os.getcwd()
    trr.LungConfig.enc_filters = trr.LungConfig.dec_filters = FILTERS
    os.environ["LUNG_CKPT"] = inputs["ckpt"]
    # only rank 0 reads it: the others' path does not exist
    os.environ["LUNG_EDITED_FILE"] = (inputs["edited"] if rank == 0
                                      else os.path.join(here, "absent.nii.gz"))
    os.chdir(here)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = trr.main(["--partition", "spatial", "--device", "cpu", "--max-iters", "2",
                           "--poll-seconds", "0.05", "--watch", "poll"])
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            setattr(trr.LungConfig, k, v)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    written = sorted(os.path.relpath(os.path.join(d, f), here)
                     for d, _, files in os.walk(here) for f in files)
    return {"rc": rc, "stdout": buf.getvalue(), "written": written}


def wait_inputs(workdir):
    path = os.path.join(workdir, "inputs.pt")
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > INPUTS_WAIT_S:
            raise RuntimeError(f"no {path} after {INPUTS_WAIT_S} s")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def task_two(rank, world, workdir):
    """Two ranks: the 1 × 2 "spatial" and 2 × 1 "data" services, the HTTP
    round trip, `run_recon`'s partitioned edit function and loop; then, in
    a new process group whose timeout is IDLE_TIMEOUT_S, a follower left
    idle for IDLE_S before the next request."""
    inputs = wait_inputs(workdir)
    out = {"spatial": service_edits(inputs, "spatial"),
           "data": service_edits(inputs, "data"),
           "http": http_round_trip(inputs),
           "http_data": http_round_trip(inputs, "data"),
           "recon_edit_fn": recon_edit_fn(inputs),
           "recon_serve": recon_serve(inputs, rank, workdir)}
    pmesh.destroy_distributed()
    pmesh.init_process_group("gloo", f"file://{workdir}/idle.init", rank, world, IDLE_TIMEOUT_S)
    out["idle"] = idle_follower(inputs)
    return out


def idle_follower(inputs):
    from medical_image_editing_tpu_torch.cli.serve_http import EditService

    service = EditService(tiny_config(inputs["ckpt"]), partition="spatial", device="cpu")
    out = {"group_timeout_s": pmesh.group_timeout(), "tick_s": None}
    try:
        if service.rank > 0:
            out["followed"] = dict(service.follow())
            return out
        out["tick_s"] = service.leader.tick_seconds
        out["before"] = service.edit(inputs["one"])[0]
        time.sleep(IDLE_S)
        out["after"] = service.edit(inputs["one"])[0]
    finally:
        service.close()
    return out


def task_four(rank, world, workdir):
    """Four ranks: the 1 × 4 "spatial" service (16 rows a rank at 64²)."""
    return {"spatial": service_edits(wait_inputs(workdir), "spatial")}


def planted_failure(rank, world, workdir, failing):
    """`serve_http.serve` on 1 × 2 "spatial", rank `failing`'s decoder
    raising on its second forward: rank 0's client posts two maps, and
    every rank must end with an error (the test reads the exit codes)."""
    from medical_image_editing_tpu_torch.cli import serve_http as tsh
    from medical_image_editing_tpu_torch.models.unet_decoder import UNetDecoder

    inputs = wait_inputs(workdir)
    real, calls = UNetDecoder.forward, [0]

    def planted(self, *args, **kw):
        calls[0] += 1
        if rank == failing and calls[0] == 2:
            raise RuntimeError(f"planted failure on rank {rank}")
        return real(self, *args, **kw)

    UNetDecoder.forward = planted
    port = inputs["ports"][failing]
    stem = os.path.join(workdir, f"fail{failing}-{rank}")
    replies = []

    def client():
        url = f"http://127.0.0.1:{port}"
        for _ in range(600):  # until the server is up
            try:
                urllib.request.urlopen(url + "/healthz", timeout=5).close()
                break
            except OSError:
                time.sleep(0.05)
        for _ in range(2):
            replies.append((time.time(), post(url + "/edit", npy(inputs["one"]))[0]))
        with open(stem + ".json", "w") as f:
            json.dump(replies, f)

    if rank == 0:
        threading.Thread(target=client, daemon=True).start()
    try:
        tsh.serve(tiny_config(inputs["ckpt"]), port=port, warm_shapes=(),
                  partition="spatial", device="cpu")
    except BaseException as e:
        with open(stem + ".err", "w") as f:
            f.write(f"{time.time()} {type(e).__name__}: {e}")
        raise
    return {"ended": "normally"}


TASKS = {"two": task_two, "four": task_four,
         "fail0": lambda r, w, d: planted_failure(r, w, d, 0),
         "fail1": lambda r, w, d: planted_failure(r, w, d, 1)}


def run(rank, world, init, task, workdir, timeout_s=None):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    pmesh.init_process_group("gloo", f"file://{init}", rank, world, timeout_s)
    try:
        out = TASKS[task](rank, world, workdir)
    finally:
        pmesh.destroy_distributed()
    torch.save(out, os.path.join(workdir, f"{task}-{rank}.pt"))
