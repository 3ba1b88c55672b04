"""HTTP depth server of the port, on ``serving.DepthService``, with the
flags of the JAX package's ``examples/serve.py``: every request thread
submits into one shared service, whose dispatcher micro-batches
co-arriving requests onto the card.

  python -m supervised_dispnet_tpu_torch.cli.serve --pretrained ckpt.pth.tar \\
      --network disp_res_50 [--port 8502]

  curl -s -X POST --data-binary @kitti.png localhost:8502/depth -o depth.npy
  curl -s localhost:8502/healthz

POST /depth: the body is a PNG (8-bit grey, RGB or RGBA), decoded by the
port's codec and area-resized to the configured size; the answer is the
(H, W) float32 depth map as an ``.npy`` payload. Another format, or a
frame smaller than the network input, answers 400; a full queue 503.
GET /healthz: "ok" once the buckets are warm. ``--port 0`` takes a free
port; the line "serving on :<port>" names it. ``--int8 --calib-dir <dir>``
serves the int8 path, calibrated on the folder's first 8 images (sorted by
name, decoded as requests are). Runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import io
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="HTTP depth server (PyTorch port, CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--pretrained", required=True,
                   help=".pth.tar (the port's Trainer or the reference)")
    p.add_argument("--network", default="disp_res_50")
    p.add_argument("--img-height", type=int, default=128)
    p.add_argument("--img-width", type=int, default=416)
    p.add_argument("--buckets", default="1,8,64")
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--int8", action="store_true",
                   help="the int8 path (ops/quant.py); needs --calib-dir")
    p.add_argument("--calib-dir", default=None,
                   help="--int8: folder of PNG images for range calibration (the first 8)")
    p.add_argument("--imagenet-normalization", action="store_true")
    p.add_argument("--port", type=int, default=8502)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs on the CPU")
    return p


def decode(buf: bytes, height: int, width: int) -> np.ndarray:
    """A PNG body -> (height, width, 3) uint8 RGB, area-resized as
    ``cv2.INTER_AREA`` does. ``ValueError`` for anything that is not a
    decodable PNG at least as large as the network input."""
    from supervised_dispnet_tpu_torch.data.image_resize import resize_area_uint8
    from supervised_dispnet_tpu_torch.utils.image_io import as_rgb, decode_png, is_png

    if not is_png(buf):
        raise ValueError("only PNG images are decoded (8-bit grey, RGB or RGBA)")
    img = as_rgb(decode_png(buf, "request body"))
    if img.shape[0] < height or img.shape[1] < width:
        raise ValueError(f"image {img.shape[:2]} is smaller than the network input "
                         f"({height}, {width})")
    return resize_area_uint8(img, height, width)


def make_server(argv: list[str] | None = None):
    """Build, warm and start the service and bind the HTTP server; returns
    (server, service). The caller runs ``server.serve_forever()`` and, when
    done, ``server.server_close()`` and ``service.stop()``."""
    parser = build_parser()
    args = parser.parse_args(argv)

    from supervised_dispnet_tpu_torch.serving import DepthService, ServingConfig

    H, W = args.img_height, args.img_width
    calibration = None
    if args.int8:
        if not args.calib_dir:
            parser.error("--int8 requires --calib-dir")
        files = sorted(Path(args.calib_dir).iterdir())[:8]
        calibration = [decode(f.read_bytes(), H, W) for f in files]
        print(f"calibrating int8 on {len(calibration)} images", flush=True)
    cfg = ServingConfig(img_height=H, img_width=W,
                        buckets=tuple(int(b) for b in args.buckets.split(",")),
                        max_wait_ms=args.max_wait_ms, int8=args.int8,
                        imagenet_normalization=args.imagenet_normalization)
    service = DepthService.from_checkpoint(args.pretrained, args.network, cfg,
                                           device=args.device, calibration=calibration)
    print("warming buckets", cfg.buckets, "...", flush=True)
    service.warmup()
    service.start()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            self._reply(b"ok", "text/plain")

        def do_POST(self):
            if self.path != "/depth":
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                depth = service.submit(decode(self.rfile.read(n), H, W)).result(timeout=30.0)
            except ValueError as e:
                self.send_error(400, str(e))
                return
            except RuntimeError as e:  # queue full, or stopped: shed load
                self.send_error(503, str(e))
                return
            except Exception as e:  # noqa: BLE001 - the server keeps serving
                self.send_error(500, repr(e))
                return
            buf = io.BytesIO()
            np.save(buf, depth.astype(np.float32))
            self._reply(buf.getvalue(), "application/octet-stream")

        def _reply(self, body: bytes, kind: str) -> None:
            self.send_response(200)
            self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *a):  # no line a request
            pass

    try:
        server = ThreadingHTTPServer(("", args.port), Handler)
    except OSError:
        service.stop()
        raise
    print(f"serving on :{server.server_address[1]}", flush=True)
    return server, service


def main(argv: list[str] | None = None) -> None:
    server, service = make_server(argv)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.stop()


if __name__ == "__main__":
    main()
