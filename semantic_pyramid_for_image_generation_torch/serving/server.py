"""Stdlib HTTP server over a serving artifact (or in-memory modules).

Same endpoints and payload as the JAX package's serving/server.py:

    GET  /healthz   -> {"status": "ok", "batch_buckets": [...], ...}
    GET  /manifest  -> the artifact's manifest
    POST /generate  -> body {
        "image_b64":   base64 PNG/JPEG conditioning image (required),
        "level":       0..6 semantic level, deep->shallow (default 0),
        "class_id":    class for the CBN conditioning (default: the image's
                       own VGG fc8 argmax),
        "num_samples": latents to draw (default 1; routed to the smallest
                       fitting batch bucket),
        "seed":        latent RNG seed (default 0),
    }                -> {"images": [base64 PNG, ...], "bucket": N,
                         "class_id": the class actually used}

`GenerateService.generate_arrays` is the layer below PNG decode: it takes
one (H, W, 3) float image and returns float arrays, and needs no PIL.
Requests are serialized through one lock: the device runs one forward at a
time, and bucketing already batches the parallelism that matters.
"""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from semantic_pyramid_for_image_generation_torch.data.masks import MaskSchedule
from semantic_pyramid_for_image_generation_torch.serving.export import (
    ServingArtifact,
)


def decode_image_m11(data: bytes, size: int) -> np.ndarray:
    """PNG/JPEG bytes -> (size, size, 3) float32 in [-1, 1] (per-image
    min-max)."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        img = img.convert("RGB")
        if img.size != (size, size):
            img = img.resize((size, size), Image.BILINEAR)
        arr = np.asarray(img, dtype=np.float32) / 255.0
    mn, mx = float(arr.min()), float(arr.max())
    return (2.0 * (arr - mn) / max(mx - mn, 1e-12) - 1.0).astype(np.float32)


def encode_png(image_m11: np.ndarray) -> bytes:
    """(H, W, 3) float -> PNG bytes via per-image min-max to [0, 255]."""
    from PIL import Image

    mn, mx = float(image_m11.min()), float(image_m11.max())
    u8 = ((image_m11 - mn) / max(mx - mn, 1e-12) * 255.0 + 0.5).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, format="PNG")
    return buf.getvalue()


class GenerateService:
    """Request -> model call plumbing, independent of the HTTP layer."""

    def __init__(self, artifact: ServingArtifact):
        self.artifact = artifact
        self.config = artifact.config
        self.schedule = MaskSchedule(self.config)
        self._lock = threading.Lock()

    def generate_arrays(self, image: np.ndarray, level: int = 0,
                        class_id: int | None = None, num_samples: int = 1,
                        seed: int = 0) -> dict:
        """One (H, W, 3) image in [-1, 1] -> {"fakes": (n, H, W, 3) float32,
        "bucket": N, "class_id": the class used}."""
        levels = len(self.config.mask_shapes)
        if not 0 <= level < levels:
            raise ValueError(f"level must be in [0, {levels - 1}]: {level}")
        if class_id is not None and not 0 <= class_id < self.config.num_classes:
            raise ValueError(f"class_id must be in [0, "
                             f"{self.config.num_classes - 1}]: {class_id}")
        n = num_samples
        if n < 1:
            raise ValueError(f"num_samples must be >= 1: {n}")
        bucket = self.artifact.bucket_for(n)  # raises if n exceeds buckets
        s = self.config.image_size
        if image.shape != (s, s, 3):
            raise ValueError(f"image must be ({s}, {s}, 3): {image.shape}")

        images = np.broadcast_to(image, (n,) + image.shape)
        masks = self.schedule.batch([self.schedule.inference_masks(level)] * n)
        if class_id is None:
            # auto-conditioning on the image's own fc8 prediction
            with self._lock:
                class_id = self.artifact.classify(image)
        labels = np.zeros((n, self.config.num_classes), np.float32)
        labels[:, class_id] = 1.0
        noise = np.random.default_rng(seed).standard_normal(
            (n, self.config.latent_dim)).astype(np.float32)
        with self._lock:
            fakes = self.artifact.generate(images, masks, labels, noise)
            fakes = fakes.to(torch.float32).cpu().numpy()
        return {"fakes": fakes, "bucket": bucket, "class_id": int(class_id)}

    def generate(self, request: dict) -> dict:
        if "image_b64" not in request:
            raise ValueError("missing required field 'image_b64'")
        class_id = request.get("class_id")
        fields = dict(level=int(request.get("level", 0)),
                      class_id=None if class_id is None else int(class_id),
                      num_samples=int(request.get("num_samples", 1)),
                      seed=int(request.get("seed", 0)))
        self.artifact.bucket_for(fields["num_samples"])  # before decoding
        try:
            image = decode_image_m11(base64.b64decode(request["image_b64"]),
                                     self.config.image_size)
        except Exception as e:  # an undecodable upload is a caller error
            raise ValueError(f"image_b64 did not decode to an image: {e}")
        out = self.generate_arrays(image, **fields)
        return {
            "images": [base64.b64encode(encode_png(f)).decode("ascii")
                       for f in out["fakes"]],
            "bucket": out["bucket"],
            "class_id": out["class_id"],
        }


def make_handler(service: GenerateService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                m = service.artifact.manifest
                self._reply(200, {"status": "ok",
                                  "batch_buckets": m["batch_buckets"],
                                  "platforms": m["platforms"],
                                  "weights": m.get("weights", "baked")})
            elif self.path == "/manifest":
                self._reply(200, service.artifact.manifest)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/generate":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                request = json.loads(self.rfile.read(length) or b"{}")
                self._reply(200, service.generate(request))
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # surface, don't kill the server
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def make_server(service: GenerateService, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """The HTTP server (not yet serving): .serve_forever() runs it;
    .server_address has the bound port (port=0 picks a free one)."""
    return ThreadingHTTPServer((host, port), make_handler(service))


def serve_artifact(artifact_dir: str, host: str = "127.0.0.1",
                   port: int = 8000,
                   device: str | torch.device = "cuda") -> ThreadingHTTPServer:
    return make_server(GenerateService(ServingArtifact(artifact_dir, device)),
                       host, port)
