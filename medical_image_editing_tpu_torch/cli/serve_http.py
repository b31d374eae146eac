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

Not ported: `partition` "data"/"spatial" (multi-card serving, ROADMAP item
15; `EditService` raises `NotImplementedError` for them) and the JAX CLI's
`cli_setup` (item 13).
"""

import argparse
import contextlib
import io
import json
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..utils.device import resolve_device


def build_service(config, *, device="cuda"):
    """(decoder, vq_state) on `device` from a run_recon-style config."""
    from .run_recon import load_model

    _, decoder, vq_state = load_model(config, device=device)
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
    output), called on one dispatch thread. `close()` stops that thread."""

    def __init__(self, config, partition: str = "none",
                 batch_bucketing: str = "pow2", device="cuda"):
        from .edit_batch import make_batched_edit_fn
        from .run_recon import compute_dtype

        if partition != "none":
            raise NotImplementedError(
                f"partition={partition!r}: multi-card serving is ROADMAP item 15; "
                "the port serves on one device (partition='none')")
        if batch_bucketing not in ("pow2", "exact"):
            raise ValueError(f"batch_bucketing {batch_bucketing!r}: 'pow2' or 'exact'")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # pinned: the dispatch thread starts on device 0
            dev = torch.device("cuda", torch.cuda.current_device())
        self.dev = dev
        self.config = config
        self.partition = partition
        self.batch_bucketing = batch_bucketing
        self.compute_dtype = str(compute_dtype(config) or torch.float32).split(".")[-1]
        self.decoder, self.vq_state = build_service(config, device=dev)
        kw = dict(
            is_lung=config.config_name == "LungConfig",
            dataset_window=(config.window_width, config.window_center,
                            config.window_scale),
            device=dev,
        )
        self.edit_fn = make_batched_edit_fn(self.decoder, **kw)
        # PNG responses decode straight to uint8 on the device: a 4× smaller
        # copy to the host
        self.edit_fn_u8 = make_batched_edit_fn(self.decoder, output_dtype="uint8", **kw)
        self.device = (f"{dev} ({torch.cuda.get_device_name(dev)})"
                       if dev.type == "cuda" else str(dev))
        # one thread for all device work: serializes dispatch per request and
        # keeps cuDNN's per-thread execution plans from request to request
        self._dispatch = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="edit-dispatch")

    def edit(self, ids, uint8: bool = False):
        """id map (H,W) or (B,H,W) → (recon of the same leading shape, ms of
        dispatch plus copy to the host). A label outside the codebook raises
        `ValueError` before anything reaches the device."""
        ids = np.asarray(ids)
        squeeze = ids.ndim == 2
        if squeeze:
            ids = ids[None]
        b = ids.shape[0]
        pad = bucket_batch(b, self.batch_bucketing) - b
        if pad:
            ids = np.concatenate([ids, np.repeat(ids[-1:], pad, axis=0)])
        fn = self.edit_fn_u8 if uint8 else self.edit_fn
        t0 = time.perf_counter()
        recon = self._dispatch.submit(self._decode, fn, ids).result()
        ms = (time.perf_counter() - t0) * 1000.0
        recon = recon[:b]
        return (recon[0] if squeeze else recon), ms

    def _decode(self, fn, ids):
        scope = (torch.cuda.device(self.dev) if self.dev.type == "cuda"
                 else contextlib.nullcontext())
        with scope:
            return fn(self.vq_state, ids).cpu().numpy()

    def close(self):
        """Stop the dispatch thread (after the decodes already submitted)."""
        self._dispatch.shutdown(wait=True)


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
          partition: str = "none", batch_bucketing: str = "pow2", device="cuda"):
    """Build the service, decode each warm shape once (f32 and uint8), serve
    until interrupted."""
    service = EditService(config, partition=partition,
                          batch_bucketing=batch_bucketing, device=device)
    for shape in warm_shapes or ():
        service.edit(np.zeros(shape, np.int32))
        service.edit(np.zeros(shape, np.int32), uint8=True)
        print(f"warmed {shape}")
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    print(f"edit service on http://{host}:{port} ({service.device})")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        service.close()


def main(argv=None):
    """CLI of the HTTP service. Spec: `serve_http.py:206-246`."""
    from ..utils.config import load_dotenv
    from .run_recon import CRCConfig, LungConfig

    load_dotenv()
    parser = argparse.ArgumentParser(description="HTTP editing service")
    parser.add_argument("--config", choices=["lung", "crc"], default="lung")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8760)
    parser.add_argument("--warm", default="1x512x512",
                        help="comma-separated BxHxW shapes to decode once at "
                             "start, or 'none'")
    parser.add_argument("--dtype", choices=["f32", "bf16"], default=None,
                        help="decode compute dtype (parameters and checkpoints "
                             "stay f32); default: $MEDIMG_EDIT_DTYPE, else f32")
    parser.add_argument("--bucket", choices=["pow2", "exact"], default="pow2",
                        help="batch-size bucketing: 'pow2' pads requests up to "
                             "the next power of two; 'exact' dispatches as sent")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    config = LungConfig() if args.config == "lung" else CRCConfig()
    if args.dtype:
        config.compute_dtype = {"f32": None, "bf16": "bfloat16"}[args.dtype]
    warm = ()
    if args.warm and args.warm != "none":
        warm = tuple(tuple(int(d) for d in s.split("x")) for s in args.warm.split(","))
    serve(config, host=args.host, port=args.port, warm_shapes=warm,
          batch_bucketing=args.bucket, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
