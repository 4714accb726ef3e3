"""Serve a serving artifact over HTTP.

    python -m semantic_pyramid_for_image_generation_torch.cli.serve \
        --artifact artifacts/generate --port 8000

    curl -s localhost:8000/healthz
    curl -s -X POST localhost:8000/generate -d '{
        "image_b64": "<base64 PNG/JPEG>", "level": 3, "class_id": 42,
        "num_samples": 4, "seed": 7}'

An artifact of the port's `cli/export_serving.py` is served through its
`torch.export` programs for the device's platform, without building a model
(serving/program.py); one of the JAX package's `cli/export_serving` (written
with weights="external", whose programs the port cannot run) is served by
the port's modules, built from its weights.npz. Endpoints and payload:
serving/server.py.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--artifact", type=str, required=True,
                   help="artifact directory (the port's or the JAX "
                        "package's cli.export_serving)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from semantic_pyramid_for_image_generation_torch.serving.server import (
        serve_artifact,
    )

    server = serve_artifact(args.artifact, args.host, args.port, args.device)
    host, port = server.server_address[:2]
    print(f"serving {args.artifact} on http://{host}:{port} "
          f"(endpoints: /healthz /manifest POST /generate)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
