"""Model server: the SageMaker hosting contract over an exported model
(counterpart of the JAX package's infer/server.py, with the same contract):

  * ``GET /ping``         -> 200 when the model is loaded (health check)
  * ``POST /invocations`` -> predictions

Payloads (request and response symmetric):
  * ``application/json``: ``{"inputs": {...}}`` with nested-list arrays, or
    ``{"inputs": [[...]]}`` for a bare single-modality input.
  * ``application/x-npz``: an .npz body, one array per modality (``image`` +
    ``clinical``) or a single ``inputs`` array.

A malformed request or one the model rejects is a 400, an unknown path a
404, and a fault while running the model a 500.

Run:  python -m mmnn_sts_torch.infer.server model.pt [--port 8080] [--device cuda]
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils.logging import get_logger
from .export import BATCH_SIZES, ServingModel

JSON = "application/json"
NPZ = "application/x-npz"


def _decode_request(body: bytes, content_type: str):
    """Request bytes -> model inputs (dict of arrays or a bare array)."""
    ctype = (content_type or JSON).split(";")[0].strip().lower()
    if ctype == NPZ or ctype == "application/octet-stream":
        with np.load(io.BytesIO(body), allow_pickle=False) as data:
            arrays = {k: np.asarray(data[k], np.float32) for k in data.files}
    elif ctype == JSON:
        payload = json.loads(body.decode("utf-8"))
        inputs = payload.get("inputs", payload) if isinstance(payload, dict) \
            else payload
        if isinstance(inputs, dict):
            arrays = {k: np.asarray(v, np.float32) for k, v in inputs.items()}
        else:
            arrays = {"inputs": np.asarray(inputs, np.float32)}
    else:
        raise ValueError(f"unsupported content type {content_type!r}")
    if not arrays:
        raise ValueError("empty request")
    if set(arrays) == {"inputs"}:
        return arrays["inputs"], ctype
    return arrays, ctype


def _encode_response(preds: np.ndarray, ctype: str) -> tuple[bytes, str]:
    if ctype == JSON:
        return (
            json.dumps({"predictions": np.asarray(preds).tolist()}).encode(),
            JSON,
        )
    buf = io.BytesIO()
    np.savez(buf, predictions=np.asarray(preds))
    return buf.getvalue(), NPZ


class ModelServer:
    """Loads one exported model onto ``device`` (default: the card) and
    serves it until shutdown. Requests run one at a time on the device."""

    def __init__(self, artifact_path: str, host: str = "0.0.0.0",
                 port: int = 8080, batch_sizes=BATCH_SIZES, device=None):
        self.model = ServingModel(artifact_path, batch_sizes=batch_sizes,
                                  device=device)
        self._model_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route through our logger
                get_logger().info("serve: " + fmt % args)

            def _reply(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, e: Exception):
                self._reply(code, json.dumps({"error": str(e)}).encode(), JSON)

            def do_GET(self):
                if self.path == "/ping":
                    self._reply(200, b"{}", JSON)
                else:
                    self._reply(404, b'{"error": "not found"}', JSON)

            def do_POST(self):
                if self.path != "/invocations":
                    self._reply(404, b'{"error": "not found"}', JSON)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    inputs, ctype = _decode_request(
                        self.rfile.read(n), self.headers.get("Content-Type")
                    )
                except Exception as e:  # noqa: BLE001 — malformed request
                    self._error(400, e)
                    return
                try:
                    with server._model_lock:
                        preds = server.model(inputs)
                    body, out_type = _encode_response(preds, ctype)
                except (ValueError, TypeError) as e:
                    # the model rejecting the inputs (wrong modality set,
                    # shape) is still the client's fault
                    self._error(400, e)
                    return
                except Exception as e:  # noqa: BLE001 — model/server fault
                    get_logger().exception("serve: model fault")
                    self._error(500, e)
                    return
                self._reply(200, body, out_type)

        self.httpd = ThreadingHTTPServer((host, port), Handler)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mmnn_sts_torch.infer.server")
    ap.add_argument("artifact", help="servable from mmnn_sts_torch.infer.export")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    srv = ModelServer(args.artifact, args.host, args.port, device=args.device)
    get_logger().info(f"serving {args.artifact} on :{srv.port} ({args.device})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
