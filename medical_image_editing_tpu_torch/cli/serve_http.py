"""HTTP editing service: POST an id map, get the decoded image back.

Counterpart of `medical_image_editing_tpu/cli/serve_http.py`: the serving
counterpart of the file-watching `run_recon` loop, on the standard library's
`http.server` with a threading server. The work per request is the batched
codebook lookup and decode of `edit_batch.make_batched_edit_fn`, with the
models resident on the device between requests.

API (`serve_http.py:10-16`):
  GET  /healthz          → JSON {status, config, dict_size, device, ...}
  POST /edit             → body: .npy bytes, int id map (H,W) or (B,H,W);
                           0 = background. Response: .npy float32 recon of
                           the same leading shape, or with ?format=png an
                           8-bit grayscale PNG of the first slice. Header
                           X-Edit-Ms: dispatch plus copy to the host, in ms.
                           400 on a malformed body, an empty batch or a
                           label outside the codebook; 500 when the decode
                           fails.

Batch sizes are bucketed to the next power of two by default (`--bucket
pow2`), as the JAX service does to bound its compiled shapes; here it bounds
the shapes cuDNN builds execution plans for. The PNG is written with the
standard library (`utils/imaging.py::encode_png`), not PIL.

Every decode runs on one long-lived dispatch thread, which serializes device
work as the JAX service's lock does. PyTorch keeps cuDNN's execution plans
per thread, and `ThreadingHTTPServer` answers each request on a new thread:
decoding there would rebuild every convolution's plan on every request.

Partitions (`partition=`, `--partition data|spatial`; JAX: one mesh over
all devices): one process a rank under `torchrun`, every rank on the
partition's axis (`parallel/mesh.py::VolumetricMesh`), the decode
`edit_batch.make_batched_edit_fn(mesh=, partition=)`. "data" splits each
request's maps over the ranks, padded up to a multiple of them
(`_batch_multiple`) and sliced back; "spatial" splits each map's rows, the
convolutions halo-exchanged and the instance norms' statistics summed over
the ranks. Rank 0 owns the HTTP server, checks each request on its host
(labels, and maps whose rows and columns the decoder's pooling levels
divide on every rank) and, on its dispatch thread,
sends it to the others (`parallel/mesh.py::Leader`), decodes its block
and joins the gather; the other ranks follow (`follow`) until rank 0's
`close` sends "stop". While no request comes rank 0 sends a "tick" now
and then, so that no follower's wait outlasts the group's timeout. A
decode that fails on any rank ends the service on every rank: rank 0
answers that request 500, stops serving and raises `RankFailure`, and a
follower raises with the failed collective. Without a process group a
partitioned service raises: it never serves unpartitioned.

Not ported: the JAX CLI's `cli_setup` (item 13).
"""

import argparse
import contextlib
import io
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..parallel import mesh as pmesh
from ..utils.device import resolve_device

PARTITIONS = ("none", "data", "spatial")


def build_service(config, *, device="cuda", seed: int = 0):
    """(decoder, vq_state) on `device` from a run_recon-style config."""
    from .run_recon import load_model

    _, decoder, vq_state = load_model(config, device=device, seed=seed)
    return decoder, vq_state


def bucket_batch(b: int, bucketing: str, multiple: int = 1) -> int:
    """Dispatch batch size for a b-slice request (`serve_http.py:41-56`).

    'pow2' pads b up to the next power of two, so a server sees at most
    log2(Bmax) batch sizes per (H, W); 'exact' dispatches b as is. Either
    way the result is rounded up to `multiple`. Padded slices are replicas of
    the last id map and are sliced off before the response."""
    if bucketing == "pow2":
        b = 1 << (b - 1).bit_length()
    return b + (-b % multiple)


class EditService:
    """The models on one device and the two edit functions (f32 and uint8
    output), called on one dispatch thread. Partitioned, one rank's share
    of the service: rank 0 serves (`edit`), the others `follow`. `close()`
    stops the dispatch thread (rank 0 of a partitioned service first sends
    "stop" to the others)."""

    def __init__(self, config, partition: str = "none",
                 batch_bucketing: str = "pow2", device="cuda", mesh=None, seed: int = 0):
        from .edit_batch import make_batched_edit_fn
        from .run_recon import compute_dtype

        if partition not in PARTITIONS:
            raise ValueError(f"partition {partition!r}: one of {PARTITIONS}")
        if batch_bucketing not in ("pow2", "exact"):
            raise ValueError(f"batch_bucketing {batch_bucketing!r}: 'pow2' or 'exact'")
        if partition != "none":
            if not pmesh.is_active():
                raise RuntimeError(f"partition={partition!r} serves over the ranks of a "
                                   "process group (torchrun); there is none")
            if mesh is None:  # every rank on the partition's axis, as JAX's one-axis mesh
                size = pmesh.world()[1]
                mesh = pmesh.create_volumetric_mesh(*((size, 1) if partition == "data"
                                                      else (1, size)))
        elif mesh is not None:
            raise ValueError("a mesh is for partition 'data' or 'spatial'")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # pinned: the dispatch thread starts on device 0
            dev = torch.device("cuda", torch.cuda.current_device())
        self.dev = dev
        self.config = config
        self.partition = partition
        self.mesh = mesh
        self.rank = mesh.rank if mesh is not None else 0
        self.batch_bucketing = batch_bucketing
        # 'data' splits the batch evenly: requests are padded up to a multiple
        # of the ranks and sliced back (`serve_http.py:94-96`)
        self._batch_multiple = mesh.data if partition == "data" else 1
        self.compute_dtype = str(compute_dtype(config) or torch.float32).split(".")[-1]
        self.decoder, self.vq_state = build_service(config, device=dev, seed=seed)
        kw = dict(
            is_lung=config.config_name == "LungConfig",
            dataset_window=(config.window_width, config.window_center,
                            config.window_scale),
            mesh=mesh,
            partition="data" if partition == "none" else partition,
            device=dev,
        )
        self.edit_fn = make_batched_edit_fn(self.decoder, **kw)
        # PNG responses decode straight to uint8 on the device: a 4× smaller
        # copy to the host
        self.edit_fn_u8 = make_batched_edit_fn(self.decoder, output_dtype="uint8", **kw)
        self.device = (f"{dev} ({torch.cuda.get_device_name(dev)})"
                       if dev.type == "cuda" else str(dev))
        # one thread for all device work: serializes dispatch per request and
        # keeps cuDNN's per-thread execution plans from request to request;
        # partitioned, its requests and the leader's ticks take one lock, so
        # that they reach every rank in one order
        self._dispatch = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="edit-dispatch")
        # partitioned, rank 0's side of the requests, and the HTTP server a
        # failed request shuts down (set by `serve`)
        self.leader = pmesh.Leader(dev) if mesh is not None and self.rank == 0 else None
        self.server = None

    @property
    def failed(self):
        """The error that ended a partitioned service, else None."""
        return None if self.leader is None else self.leader.failed

    def edit(self, ids, uint8: bool = False):
        """id map (H,W) or (B,H,W) → (recon of the same leading shape, ms of
        dispatch plus copy to the host). A label outside the codebook, or
        partitioned a map the decoder cannot take on every rank
        (`check_request`), raises `ValueError` before anything reaches the
        device or another rank; partitioned, a failed decode raises
        `RankFailure`."""
        from .edit_batch import check_request

        ids = np.asarray(ids)
        squeeze = ids.ndim == 2
        if squeeze:
            ids = ids[None]
        if self.mesh is not None:
            if self.rank != 0:
                raise RuntimeError("rank 0 serves a partitioned service; the others follow()")
            check_request(ids, self.vq_state.embed.shape[0], self.decoder, self.mesh,
                          self.partition)
        b = ids.shape[0]
        pad = bucket_batch(b, self.batch_bucketing, self._batch_multiple) - b
        if pad:
            ids = np.concatenate([ids, np.repeat(ids[-1:], pad, axis=0)])
        fn = self.edit_fn_u8 if uint8 else self.edit_fn
        t0 = time.perf_counter()
        recon = self._dispatch.submit(self._decode, fn, ids, uint8).result()
        ms = (time.perf_counter() - t0) * 1000.0
        recon = recon[:b]
        return (recon[0] if squeeze else recon), ms

    def _scope(self):
        return (torch.cuda.device(self.dev) if self.dev.type == "cuda"
                else contextlib.nullcontext())

    def _decode(self, fn, ids, uint8):
        with self._scope():
            if self.mesh is None:
                return fn(self.vq_state, ids).cpu().numpy()
            try:
                return self.leader.send("edit", ids, int(uint8), lambda maps: self._decode_block(
                    fn, maps).cpu().numpy())
            except pmesh.RankFailure:
                if self.server is not None:  # ends serve_forever, from another thread
                    threading.Thread(target=self.server.shutdown, daemon=True).start()
                raise

    def _decode_block(self, fn, maps):
        """This rank's block of the request's maps decoded, then every
        rank's gathered."""
        return self.mesh.gather(fn(self.vq_state, self.mesh.block(maps)))

    def follow(self):
        """A follower (rank > 0): decode its block of each request rank 0
        sends and join the gather, until rank 0 sends "stop" → the count of
        each op received. A failed decode or collective raises."""
        if self.mesh is None or self.rank == 0:
            raise RuntimeError("follow() is for the ranks > 0 of a partitioned service")
        with self._scope():
            return pmesh.follow_requests(lambda uint8, maps: self._decode_block(
                self.edit_fn_u8 if uint8 else self.edit_fn, maps))

    def close(self):
        """Stop the dispatch thread (after the decodes already submitted);
        then rank 0 of a partitioned service sends "stop" to the others,
        unless it failed (`Leader.close`)."""
        self._dispatch.shutdown(wait=True)
        if self.leader is not None:
            self.leader.close()


def make_handler(service: EditService):
    from ..utils.imaging import encode_png

    class Handler(BaseHTTPRequestHandler):
        # TCP_NODELAY: the headers and the body go out in two writes, and
        # Nagle's algorithm would hold a short body until the client's
        # delayed ACK
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code, body, ctype, extra=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.split("?")[0] != "/healthz":
                self._send(404, b"not found", "text/plain")
                return
            info = {
                "status": "ok",
                "config": service.config.config_name,
                "dict_size": int(service.config.dict_size),
                "device": service.device,
                "compute_dtype": service.compute_dtype,
                "partition": service.partition,
                "batch_bucketing": service.batch_bucketing,
            }
            self._send(200, json.dumps(info).encode(), "application/json")

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/edit":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                ids = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                if ids.ndim not in (2, 3):
                    raise ValueError(f"id map must be 2-D or 3-D, got {ids.shape}")
                if ids.size == 0:
                    raise ValueError(f"empty id map (shape {ids.shape})")
            except Exception as e:  # malformed request body
                self._send(400, str(e).encode(), "text/plain")
                return
            want_png = "format=png" in query
            try:
                recon, ms = service.edit(ids, uint8=want_png)
            except ValueError as e:  # labels outside the codebook: the client's
                self._send(400, str(e).encode(), "text/plain")
                return
            except Exception as e:  # the decode failed: the server's
                self._send(500, str(e).encode(), "text/plain")
                return
            extra = {"X-Edit-Ms": f"{ms:.2f}"}
            if want_png:
                img = recon if recon.ndim == 2 else recon[0]
                self._send(200, encode_png(img), "image/png", extra)
            else:
                buf = io.BytesIO()
                np.save(buf, recon.astype(np.float32), allow_pickle=False)
                self._send(200, buf.getvalue(), "application/octet-stream", extra)

    return Handler


def serve(config, host="127.0.0.1", port=8760, warm_shapes=((1, 512, 512),),
          partition: str = "none", batch_bucketing: str = "pow2", device="cuda", mesh=None,
          seed: int = 0, started=None):
    """Build the service, decode each warm shape once (f32 and uint8), serve
    until interrupted, or until a caller's `httpd.shutdown()` (`started`, if
    given, is called with the server once it listens). Partitioned, rank 0
    serves and sends "stop" when it ends (normally or on an interrupt), the
    other ranks follow until then and return the count of each request op
    they received; a failed decode ends every rank with `RankFailure` or the
    failed collective's error."""
    service = EditService(config, partition=partition, batch_bucketing=batch_bucketing,
                          device=device, mesh=mesh, seed=seed)
    if service.rank > 0:
        try:
            seen = service.follow()
        finally:
            service.close()
        print(f"rank {service.rank}: {seen['edit']} requests decoded; stopped by rank 0")
        return seen
    httpd = None
    try:
        for shape in warm_shapes or ():
            service.edit(np.zeros(shape, np.int32))
            service.edit(np.zeros(shape, np.int32), uint8=True)
            print(f"warmed {shape}")
        httpd = service.server = ThreadingHTTPServer((host, port), make_handler(service))
        if started is not None:
            started(httpd)
        print(f"edit service on http://{host}:{httpd.server_address[1]} ({service.device}, "
              f"partition {partition})")
        httpd.serve_forever()
    finally:
        if httpd is not None:
            httpd.server_close()
        service.close()
    if service.failed is not None:
        raise pmesh.RankFailure("a partitioned decode failed") from service.failed
    return None


def main(argv=None):
    """CLI of the HTTP service. Spec: `serve_http.py:206-246`."""
    from ..utils.config import load_dotenv
    from ..utils.device import apply_conv_precision
    from .run_recon import CRCConfig, LungConfig

    apply_conv_precision()
    load_dotenv()
    parser = argparse.ArgumentParser(description="HTTP editing service")
    parser.add_argument("--config", choices=["lung", "crc"], default="lung")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8760)
    parser.add_argument("--warm", default="1x512x512",
                        help="comma-separated BxHxW shapes to decode once at "
                             "start, or 'none'")
    parser.add_argument("--partition", choices=list(PARTITIONS), default="none",
                        help="shard each decode over every rank of the torchrun group "
                             "(rank 0 serves, the others follow): 'data' = the batch "
                             "(throughput), 'spatial' = each map's rows with "
                             "halo-exchanged convolutions (latency)")
    parser.add_argument("--dtype", choices=["f32", "bf16"], default=None,
                        help="decode compute dtype (parameters and checkpoints "
                             "stay f32); default: $MEDIMG_EDIT_DTYPE, else f32")
    parser.add_argument("--bucket", choices=["pow2", "exact"], default="pow2",
                        help="batch-size bucketing: 'pow2' pads requests up to "
                             "the next power of two; 'exact' dispatches as sent")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..parallel.mesh import torchrun_mesh

    config = LungConfig() if args.config == "lung" else CRCConfig()
    if args.dtype:
        config.compute_dtype = {"f32": None, "bf16": "bfloat16"}[args.dtype]
    warm = ()
    if args.warm and args.warm != "none":
        warm = tuple(tuple(int(d) for d in s.split("x")) for s in args.warm.split(","))
    if args.partition == "none":
        grid = contextlib.nullcontext(None)
    else:  # every rank on the partition's axis
        grid = torchrun_mesh(*((None, 1) if args.partition == "data" else (1, None)),
                             args.device)
    with grid as mesh:
        serve(config, host=args.host, port=args.port, warm_shapes=warm,
              partition=args.partition, batch_bucketing=args.bucket, device=args.device,
              mesh=mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
