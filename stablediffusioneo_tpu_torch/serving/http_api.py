"""HTTP front end over DiffusionServer (counterpart of
stablediffusioneo_tpu/serving/http_api.py, same routes and fields).

A stdlib HTTP server whose handler threads submit into the batching
DiffusionServer, so concurrent HTTP clients batch onto the card. Images
travel as base64 PNG (or JPEG) and are coded with OpenCV, which the port's
annotators already need.

Endpoints:
  POST /generate  JSON {"image_b64": <base64 PNG/JPEG>, "prompt": str,
                        ...any GenRequest field}
                  -> {"image_b64": <base64 PNG>, "detected_b64": ..., "ms": float}
  GET  /stats     -> ServerStats snapshot JSON
  GET  /healthz   -> {"ok": true}

Run: python -m stablediffusioneo_tpu_torch.cli.serve [--port 8000] (see
cli/serve.py for loading a checkpoint; --tiny serves seeded tiny weights).
"""

from __future__ import annotations

import base64
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from stablediffusioneo_tpu_torch.serving.server import DiffusionServer, GenRequest

# GenRequest fields settable over the wire (image comes via image_b64)
_REQ_FIELDS = (
    "prompt", "a_prompt", "n_prompt", "image_resolution", "ddim_steps",
    "guess_mode", "strength", "scale", "seed", "eta", "low_threshold",
    "high_threshold", "sampler", "encoder_cache_interval", "clip_skip",
    "denoise_strength", "prompt_emphasis", "long_prompt", "cfg_rescale",
    "tome_ratio",
)


def _decode_image(b64: str) -> np.ndarray:
    """base64 PNG / JPEG -> (H, W, 3) uint8 RGB (gray and alpha images too)."""
    import cv2

    buf = np.frombuffer(base64.b64decode(b64), np.uint8)
    img = cv2.imdecode(buf, cv2.IMREAD_COLOR) if buf.size else None
    if img is None:
        raise ValueError("image_b64 does not hold a PNG or JPEG image")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _encode_image(arr: np.ndarray) -> str:
    import cv2

    ok, buf = cv2.imencode(".png", cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))
    if not ok:
        raise ValueError("PNG encoding failed")
    return base64.b64encode(buf.tobytes()).decode("ascii")


class _Handler(BaseHTTPRequestHandler):
    server_version = "sdeo-torch/1"
    # set by make_http_server
    diffusion: DiffusionServer = None
    request_timeout_s: float = 900.0
    max_body_bytes: int = 32 * 1024 * 1024  # 413 above this, before read

    def log_message(self, fmt, *args):  # quiet by default; stats has counts
        pass

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            return self._json(200, {"ok": True})
        if self.path == "/stats":
            return self._json(200, self.diffusion.stats.snapshot())
        return self._json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/generate":
            return self._json(404, {"error": f"no route {self.path}"})
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length > self.max_body_bytes:
                return self._json(413, {
                    "error": f"body {length} B exceeds "
                             f"{self.max_body_bytes} B cap"})
            payload = json.loads(self.rfile.read(length) or b"{}")
            image = _decode_image(payload["image_b64"])
            kwargs = {k: payload[k] for k in _REQ_FIELDS if k in payload}
            # blended-latent inpainting over the wire: source + mask images
            if "inpaint_image" in payload or "inpaint_mask" in payload:
                # GenRequest's ndarray field names don't travel as JSON —
                # reject loudly instead of silently running plain generation
                return self._json(400, {
                    "error": "use inpaint_image_b64/inpaint_mask_b64 "
                             "(base64 images), not inpaint_image/"
                             "inpaint_mask"})
            if "inpaint_image_b64" in payload:
                kwargs["inpaint_image"] = _decode_image(
                    payload["inpaint_image_b64"])
                kwargs["inpaint_mask"] = _decode_image(
                    payload["inpaint_mask_b64"])
            if "init_image" in payload:
                return self._json(400, {
                    "error": "use init_image_b64 (base64 image), "
                             "not init_image"})
            if "init_image_b64" in payload:  # img2img over the wire
                kwargs["init_image"] = _decode_image(
                    payload["init_image_b64"])
            req = GenRequest(image=image, **kwargs)
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            # ValueError covers bad base64 and bytes that are no image: a
            # malformed request, not a server fault
            return self._json(400, {"error": f"bad request: {e!r}"})
        t0 = time.perf_counter()
        try:
            # submit() runs host preprocessing and can reject a request on
            # its own (missing inpaint mask, bad emphasis syntax, mismatched
            # multi-ControlNet arity) — map those to 400, not a dropped connection
            fut = self.diffusion.submit(req)
        except (ValueError, TypeError) as e:
            return self._json(400, {"error": f"bad request: {e!r}"})
        except Exception as e:  # noqa: BLE001 — preprocess crash = 500
            return self._json(500, {"error": repr(e)})
        try:
            # handler threads block here; the DiffusionServer dispatcher
            # batches across all concurrently-blocked handlers
            detected, image_out = fut.result(timeout=self.request_timeout_s)
        except TimeoutError:
            # drop the abandoned request from the queue (succeeds unless it
            # was already cut into a batch) so timed-out work stops
            # consuming batch capacity under sustained overload
            fut.cancel()
            return self._json(
                504, {"error": f"timed out after {self.request_timeout_s}s"})
        except Exception as e:  # noqa: BLE001 — surface per-request errors as 500s
            return self._json(500, {"error": repr(e)})
        return self._json(200, {
            "image_b64": _encode_image(image_out),
            "detected_b64": _encode_image(detected),
            "ms": (time.perf_counter() - t0) * 1e3,
        })


def make_http_server(
    diffusion: DiffusionServer,
    host: str = "127.0.0.1",
    port: int = 8000,
    request_timeout_s: float = 900.0,
) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; call .serve_forever() to run.
    Port 0 picks a free port (see server_address[1] after construction)."""
    handler = type("Handler", (_Handler,), {
        "diffusion": diffusion,
        "request_timeout_s": request_timeout_s,
    })
    return ThreadingHTTPServer((host, port), handler)
