"""Convert a raw LLaVA-Med-style dataset JSON (a list of
{"id", "image", "conversations"} records) into the encoder-runner input
manifest {"images": [{"uid", "image_path", "metadata"}, ...]} consumed by
smb_vision_tpu.cli.run_encoders / inference.runner.

Analog of the reference's llava-med prep script
(/root/reference/scripts/inference/llava-med/build_json.py:26-57). Accepts
both "conversations" and the reference data's misspelled "conversatons"
key; skips records with missing fields or missing image files (reported at
the end, non-zero exit if everything was skipped).

Usage:
  python scripts/build_encoder_manifest.py --input_json raw.json \
      --image_dir /data/images --output_json manifest.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def build_manifest(raw: list, image_dir: str) -> tuple[dict, list]:
    images, skipped = [], []
    for item in raw:
        uid = item.get("id")
        fname = item.get("image")
        if not uid or not fname:
            skipped.append((uid or "<no id>", "missing id/image field"))
            continue
        path = Path(image_dir) / fname
        if not path.exists():
            skipped.append((uid, f"image not found: {path}"))
            continue
        images.append({
            "uid": str(uid),
            "image_path": str(path),
            "metadata": {
                "original_filename": fname,
                "conversations": item.get("conversations",
                                          item.get("conversatons", [])),
            },
        })
    return {"images": images}, skipped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="raw LLaVA-style JSON -> encoder-runner manifest")
    ap.add_argument("--input_json", required=True)
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--output_json", required=True)
    args = ap.parse_args(argv)

    raw = json.loads(Path(args.input_json).read_text())
    if not isinstance(raw, list):
        raise ValueError("input JSON must be a list of image records")
    manifest, skipped = build_manifest(raw, args.image_dir)
    for uid, why in skipped:
        print(f"skip {uid}: {why}", file=sys.stderr)

    out = Path(args.output_json)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(manifest, indent=2))
    print(f"wrote {len(manifest['images'])} entries "
          f"({len(skipped)} skipped) -> {out}")
    return 0 if manifest["images"] or not raw else 1


if __name__ == "__main__":
    raise SystemExit(main())
