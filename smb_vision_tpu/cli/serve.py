"""Embedding server — the online serving surface of the encoder stack.

The reference ships batch fan-out only (run_inspect.py shards a manifest
over processes); production deployments also need an online endpoint that
keeps the compiled program and params resident on the device and answers
per-volume requests. This is that endpoint, stdlib-only (http.server):

    python -m smb_vision_tpu.cli.serve \
        --model_name_or_path out/mim/model.safetensors \
        --config_path out/mim/config.json --port 8000

    GET  /healthz                -> {"status": "ok", model, device, ...}
    POST /embed                  body: {"image": "/path.nii.gz"} or
                                 {"images": [...paths]}
                                 optional: {"pool": "mean"|"none"}
      -> {"embeddings": [[...]], "shape": ...}   (pool=mean: one vector
         per volume; pool=none: full token grids — large)
    POST /embed?pool=...         body: raw NIfTI bytes
                                 (Content-Type: application/octet-stream)
      -> same response, for clients without a shared filesystem

Design choices:
- ONE compiled program at a fixed batch size: requests are padded to
  `--batch_size` and chunked, so no request shape ever triggers a
  recompile (first compile happens at startup via `--warmup`).
- preprocessing (NIfTI decode + resample, the native C++ path when
  built) runs in the request thread; device dispatch is serialized by a
  lock — the device executes one program at a time anyway, and the lock
  keeps host->device transfers ordered behind it.
- repeat requests for the same volume hit the versioned preprocess cache
  (`--cache_data_dir`), so only the encoder forward recurs.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from smb_vision_tpu.utils.args import parse_args_into_dataclasses
from smb_vision_tpu.utils.logging import get_logger

logger = get_logger("serve")


@dataclass
class ServeArguments:
    host: str = "127.0.0.1"
    port: int = 8000
    encoder: str = field(
        default="smb-vision",
        metadata={"help": "smb-vision (ViT, default) | merlin (first-"
                          "party I3D ResNet tower, models/resnet3d.py; "
                          "model_name_or_path must be the Merlin torch "
                          "state dict)"})
    model_name_or_path: Optional[str] = field(
        default=None, metadata={"help": "safetensors checkpoint"})
    config_path: Optional[str] = field(
        default=None, metadata={"help": "model config json"})
    target_size: Optional[str] = field(
        default=None, metadata={"help": "merlin only: override the "
                                        "resample grid, 3 comma-separated "
                                        "ints (default 224,224,160)"})
    model_id: str = "smb-vision-tpu-base"
    pipeline: str = "smb-vision"
    dtype: str = "bfloat16"
    attn_impl: str = "auto"
    batch_size: int = field(
        default=1, metadata={"help": "compiled batch size; requests are "
                                     "padded/chunked to it (static shapes "
                                     "-> exactly one compile)"})
    cache_data_dir: Optional[str] = field(
        default=None, metadata={"help": "preprocessed-volume cache dir "
                                        "(repeat requests skip decode+"
                                        "resample)"})
    warmup: bool = field(
        default=True, metadata={"help": "compile the encoder at startup "
                                        "instead of on the first request"})
    input_dtype: str = field(
        default="float32",
        metadata={"help": "dtype pixels are shipped host->device in: "
                          "bfloat16 halves, uint8 quarters the per-"
                          "request upload (full-res f32 is 336 MB/volume "
                          "— the dominant latency through a constrained "
                          "link); uint8 decodes on device with per-volume "
                          "affine keys, max abs err (max-min)/510"})


class EmbeddingService:
    """Owns the resident encoder; thread-safe embed() over volume paths."""

    def __init__(self, args: ServeArguments):
        self.args = args
        if args.encoder == "merlin":
            from smb_vision_tpu.inference.encoders import MerlinEncoder

            if not args.model_name_or_path:
                raise ValueError(
                    "--model_name_or_path is required for --encoder "
                    "merlin: the local Merlin image-tower torch state "
                    "dict (.pt/.safetensors)")
            target_size = None
            if args.target_size:
                try:
                    target_size = tuple(
                        int(s) for s in args.target_size.split(","))
                except ValueError:
                    target_size = ()
                if len(target_size) != 3:
                    raise ValueError(
                        f"--target_size needs 3 comma-separated ints, "
                        f"got {args.target_size!r}")
            self.encoder = MerlinEncoder(
                model_id=args.model_id if args.model_id !=
                "smb-vision-tpu-base" else "merlin",
                checkpoint=args.model_name_or_path, dtype=args.dtype,
                target_size=target_size)
        elif args.encoder == "smb-vision":
            from smb_vision_tpu.inference.runner import SmbVisionEncoder

            self.encoder = SmbVisionEncoder(
                checkpoint=args.model_name_or_path,
                config_path=args.config_path, model_id=args.model_id,
                pipeline=args.pipeline, dtype=args.dtype,
                attn_impl=args.attn_impl)
        else:
            raise ValueError(f"unknown encoder {args.encoder!r}; "
                             "valid: 'smb-vision', 'merlin'")
        self.encoder.setup_model()
        self._lock = threading.Lock()      # serializes device dispatch
        self.requests = 0
        if args.warmup:
            import numpy as np

            shape = (args.batch_size, *self._pixel_shape())
            with self._lock:
                if args.input_dtype == "uint8":
                    ones = np.ones(args.batch_size, np.float32)
                    self.encoder.generate_embedding(
                        np.zeros(shape, np.uint8), scale=ones,
                        offset=np.zeros(args.batch_size, np.float32))
                else:
                    self.encoder.generate_embedding(
                        np.zeros(shape, np.dtype(args.input_dtype)))
            logger.info("warmup compile done (batch %d, input %s)",
                        args.batch_size, args.input_dtype)

    def _pixel_shape(self):
        """Per-volume pixel shape the resident program compiles at."""
        if self.args.encoder == "merlin":
            from smb_vision_tpu.data.preprocess import CT_PIPELINES

            # CHWD layout: (C, *target grid)
            size = (self.encoder.target_size
                    or CT_PIPELINES["merlin"].target_size)
            return (1, *size)
        cfg = self.encoder._config()
        return (cfg.num_frames, 1, cfg.image_size, cfg.image_size)

    def _preprocess(self, paths, cache: bool = True):
        """Decode+resample each path to the model grid -> (pixels
        (N, D, C, H, W), scale, offset) — scale/offset are per-volume
        affine keys when input_dtype='uint8', else None. Runs in the
        request thread; cache hits skip the heavy work."""
        import numpy as np

        from smb_vision_tpu.data.dataset import CTDataset

        ds = self.encoder.create_dataset([{"image": p} for p in paths],
                                         out_dtype=self.args.input_dtype)
        if cache and self.args.cache_data_dir:
            ds = CTDataset(items=ds.items, pipeline=ds.pipeline,
                           cache_dir=self.args.cache_data_dir,
                           out_dtype=self.args.input_dtype)
        exs = [ds[i] for i in range(len(paths))]
        pixels = np.stack([e["image"] for e in exs])
        if "image_scale" in exs[0]:
            return (pixels,
                    np.asarray([e["image_scale"] for e in exs], np.float32),
                    np.asarray([e["image_offset"] for e in exs],
                               np.float32))
        return pixels, None, None

    def embed(self, paths, pool: str = "mean", cache: bool = True):
        """-> list (per volume) of pooled vectors (pool='mean') or token
        grids (pool='none'), as nested python lists."""
        import numpy as np

        if pool not in ("mean", "none"):
            raise ValueError(f"pool must be 'mean' or 'none', got {pool!r}")
        bs = self.args.batch_size
        outs = []
        for i in range(0, len(paths), bs):
            # preprocess per chunk: a long 'images' list must not
            # materialise every decoded volume in host RAM before the
            # first dispatch (full-res f32 is ~336 MB/volume)
            chunk, sc, of = self._preprocess(paths[i:i + bs], cache=cache)
            n = chunk.shape[0]
            if n < bs:                      # pad to the compiled shape
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], bs - n, axis=0)])
                if sc is not None:
                    sc = np.concatenate([sc, np.repeat(sc[-1:], bs - n)])
                    of = np.concatenate([of, np.repeat(of[-1:], bs - n)])
            with self._lock:
                # sc is None whenever input_dtype is float (both encoders
                # take uint8 codes + per-volume affine keys otherwise)
                emb = (self.encoder.generate_embedding(chunk)
                       if sc is None else
                       self.encoder.generate_embedding(chunk, scale=sc,
                                                       offset=of))
            outs.append(np.asarray(emb)[:n])
        emb = np.concatenate(outs)          # (N, L, D)
        with self._lock:
            self.requests += len(paths)
        if pool == "mean":
            emb = emb.mean(axis=1)          # (N, D)
        return emb

    def health(self):
        import jax

        rec = {"status": "ok", "encoder": self.args.encoder,
               "model_id": self.encoder.model_id,
               "checkpoint": self.args.model_name_or_path,
               "batch_size": self.args.batch_size,
               "input_dtype": self.args.input_dtype,
               "device": jax.devices()[0].device_kind,
               "requests_served": self.requests}
        if self.args.encoder == "merlin":
            rec["pixel_shape"] = list(self._pixel_shape())
            rec["hidden_size"] = self.encoder._cfg.hidden_size
        else:
            cfg = self.encoder._config()
            rec["grid"] = list(cfg.grid)
            rec["hidden_size"] = cfg.hidden_size
        return rec


def make_server(args: ServeArguments) -> ThreadingHTTPServer:
    """Build (but don't run) the HTTP server — also the test entry."""
    service = EmbeddingService(args)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):    # route through our logger
            logger.info("%s " + fmt, self.address_string(), *a)

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/healthz".rstrip("/")):
                return self._json(200, service.health())
            return self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            if url.path.rstrip("/") != "/embed":
                return self._json(404, {"error": f"no route {self.path}"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                if "octet-stream" in ctype:
                    # raw NIfTI bytes: clients without a shared filesystem
                    import os
                    import tempfile

                    pool = parse_qs(url.query).get("pool", ["mean"])[0]
                    sfx = ".nii.gz" if body[:2] == b"\x1f\x8b" else ".nii"
                    fd, tmp = tempfile.mkstemp(suffix=sfx)
                    try:
                        with os.fdopen(fd, "wb") as f:
                            f.write(body)
                        # cache=False: a one-shot temp path would pollute
                        # the preprocess cache with never-reused entries
                        emb = service.embed([tmp], pool=pool, cache=False)
                    finally:
                        os.unlink(tmp)
                    return self._json(200, {"embeddings": emb.tolist(),
                                            "shape": list(emb.shape)})
                req = json.loads(body or b"{}")
                if not isinstance(req, dict):
                    return self._json(
                        400, {"error": "body must be a JSON object like "
                              '{"images": [...]} or {"image": "..."}'})
                paths = req.get("images") or (
                    [req["image"]] if "image" in req else None)
                if isinstance(paths, str):   # single path under 'images'
                    paths = [paths]
                if not paths or not isinstance(paths, list) or not all(
                        isinstance(p, str) for p in paths):
                    return self._json(
                        400, {"error": "body needs 'image' (str) or "
                              "'images' (list of str)"})
                emb = service.embed(paths, pool=req.get("pool", "mean"))
                return self._json(200, {"embeddings": emb.tolist(),
                                        "shape": list(emb.shape)})
            except FileNotFoundError as e:
                return self._json(404, {"error": str(e)})
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — report, don't die
                logger.exception("embed failed")
                return self._json(500, {"error": str(e)})

    srv = ThreadingHTTPServer((args.host, args.port), Handler)
    srv.service = service
    return srv


def main(argv=None):
    (args,) = parse_args_into_dataclasses((ServeArguments,), argv)
    from smb_vision_tpu.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    srv = make_server(args)
    logger.info("serving on http://%s:%d (model %s)",
                *srv.server_address[:2], args.model_id)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
        srv.shutdown()


if __name__ == "__main__":
    main()
