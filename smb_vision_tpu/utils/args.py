"""Dataclass-driven CLI argument parsing (HfArgumentParser-equivalent).

Matches the reference's three-tier config surface (SURVEY §5): dataclass
fields become --flags, and passing a single .json path as argv parses all
dataclasses from that file (run_mim.py:228-231 behaviour)."""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import typing
from pathlib import Path
from typing import List, Optional, Sequence, Type, Union, get_args, get_origin


def _add_field(parser: argparse.ArgumentParser, f: dataclasses.Field,
               ftype: type):
    name = "--" + f.name
    origin = get_origin(ftype)
    if origin is Union:  # Optional[T]
        args = [a for a in get_args(ftype) if a is not type(None)]
        ftype = args[0] if args else str
        origin = get_origin(ftype)

    default = (f.default if f.default is not dataclasses.MISSING
               else (f.default_factory()
                     if f.default_factory is not dataclasses.MISSING
                     else None))
    helptext = f.metadata.get("help", "")

    if ftype is bool:
        parser.add_argument(name, type=_str2bool, nargs="?", const=True,
                            default=default, help=helptext)
    elif origin in (list, List):
        elem = get_args(ftype)[0] if get_args(ftype) else str
        parser.add_argument(name, type=elem, nargs="*", default=default,
                            help=helptext)
    else:
        parser.add_argument(name, type=ftype, default=default, help=helptext)


def _str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    if s in ("1", "true", "yes", "y"):
        return True
    if s in ("0", "false", "no", "n", ""):
        return False
    # argparse type-callable contract: raise on bad values — silently
    # mapping a typo ('ture') to False would e.g. skip training entirely
    import argparse

    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def _coerce(v, ftype):
    """Coerce a string (from an HF-compat rewrite) to the field's type;
    values that are already JSON-typed pass through untouched."""
    if not isinstance(v, str):
        return v
    if get_origin(ftype) is Union:
        args = [a for a in get_args(ftype) if a is not type(None)]
        ftype = args[0] if args else str
    if ftype is bool:
        return _str2bool(v)
    if ftype in (int, float):
        return ftype(v)
    return v


# HF TrainingArguments flags the reference's launch recipes pass
# (reference scripts/training/run_{mim,cls,vjepa}.sh) that have no field
# here. Each maps to this framework's equivalent or is a documented no-op,
# so a recipe ports by swapping the entry point, not by debugging argparse
# errors. Only applied when the flag is NOT a real dataclass field and the
# mapped target (if any) IS one; every rewrite is logged.
#
#   name -> (kind, target) where kind is one of
#     'rename'    value passes through to target flag
#     'bool_set'  true -> `--target value`, false -> dropped
#     'tristate'  'no' -> `--target false`, else -> `--target true`
#     'json_pick' value is a json dict; known keys map via target dict
#     'ignore'    dropped with a warning (no equivalent needed)
#     'error'     unsupported here; fail with the message in target
_HF_COMPAT = {
    "bf16": ("bool_set", ("dtype", "bfloat16")),
    "fp16": ("error", "bfloat16 is the supported half precision "
                      "(--dtype bfloat16, the default)"),
    "eval_strategy": ("tristate", "do_eval"),
    "evaluation_strategy": ("tristate", "do_eval"),
    "cache_dir": ("rename", "cache_data_dir"),
    "dataloader_num_workers": ("rename", "num_workers"),
    "lr_scheduler_kwargs": ("json_pick", {"min_lr": "min_lr"}),
    "deepspeed": ("ignore", "ZeRO-3 here is --sharding_policy fsdp"),
    "save_strategy": ("ignore", "checkpointing is step-based; set "
                                "--save_steps"),
    "logging_strategy": ("ignore", "logging is step-based; set "
                                   "--logging_steps"),
    "remove_unused_columns": ("ignore", "datasets keep their columns"),
    "dataloader_pin_memory": ("ignore", "host->device transfer is "
                                        "managed by the prefetcher"),
    "tf32": ("ignore", "matmul precision is an XLA-level setting"),
    "save_safetensors": ("ignore", "checkpoints are step directories; HF "
                                   "export is --export_hf"),
    "ddp_find_unused_parameters": ("ignore", "no DDP wrapper here"),
    "torch_compile": ("ignore", "everything hot is jit-compiled already"),
}


def _warn(msg: str) -> None:
    print(f"[args] {msg}", file=sys.stderr)


def _hf_compat_argv(argv: List[str], field_names: set) -> List[str]:
    """Rewrite known HF TrainingArguments flags into this framework's
    flags (see _HF_COMPAT). Handles `--flag value`, `--flag=value` and
    bare boolean `--flag` forms."""
    out: List[str] = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        name, eq, inline = tok.partition("=") if tok.startswith("--") \
            else (tok, "", "")
        key = name[2:] if name.startswith("--") else None
        if key not in _HF_COMPAT or key in field_names:
            out.append(tok)
            i += 1
            continue
        kind, target = _HF_COMPAT[key]
        # consume the value: inline (--k=v) or the next non-flag token
        if eq:
            value, step = inline, 1
        elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            value, step = argv[i + 1], 2
        elif kind in ("rename", "json_pick", "tristate"):
            # value-taking kinds must not silently absorb "true" as the
            # value (--cache_dir as the last token would otherwise set
            # cache_data_dir to the literal path 'true'; a bare
            # --eval_strategy would silently enable eval)
            raise SystemExit(f"--{key} expects a value")
        else:
            value, step = "true", 1          # bare boolean form
        if kind == "error":
            # HF config dumps near-universally carry `"fp16": false`;
            # only a truthy request for the unsupported feature is fatal
            try:
                requested = _str2bool(value)
            except argparse.ArgumentTypeError:
                requested = True
            if requested:
                raise SystemExit(f"--{key}: {target}")
            _warn(f"--{key} {value} is a no-op here ({target})")
        if kind == "ignore":
            _warn(f"--{key} has no equivalent here and is ignored "
                  f"({target})")
        elif kind == "rename":
            if target in field_names:
                _warn(f"--{key} -> --{target} (HF-compat rename)")
                out += [f"--{target}", value]
            else:
                _warn(f"--{key} is ignored (no --{target} field on this "
                      f"entry point)")
        elif kind == "bool_set":
            tgt, tval = target
            try:
                truthy = _str2bool(value)
            except argparse.ArgumentTypeError as e:
                raise SystemExit(f"--{key}: {e}")
            if truthy and tgt in field_names:
                _warn(f"--{key} {value} -> --{tgt} {tval} (HF-compat)")
                out += [f"--{tgt}", tval]
            elif truthy:
                _warn(f"--{key} is ignored (no --{tgt} field on this "
                      f"entry point)")
        elif kind == "tristate":
            # HF semantics are promote-only: post_init sets do_eval=True
            # when eval_strategy != 'no' but never demotes an explicit
            # --do_eval true (the reference MIM recipe passes both)
            if target in field_names:
                if value == "no":
                    _warn(f"--{key} no is dropped (HF never demotes "
                          f"--{target}; pass --{target} false to disable)")
                else:
                    _warn(f"--{key} {value} -> --{target} true (HF-compat)")
                    out += [f"--{target}", "true"]
        elif kind == "json_pick":
            try:
                kw = json.loads(value)
            except json.JSONDecodeError:
                raise SystemExit(f"--{key} expects a JSON object, got "
                                 f"{value!r}")
            if kw is not None and not isinstance(kw, dict):
                raise SystemExit(f"--{key} expects a JSON object, got "
                                 f"{value!r}")
            for k, v in (kw or {}).items():
                tgt = target.get(k)
                if tgt in field_names:
                    _warn(f"--{key} {k}={v} -> --{tgt} {v} (HF-compat)")
                    out += [f"--{tgt}", str(v)]
                else:
                    _warn(f"--{key}: key {k!r} has no equivalent here "
                          f"and is ignored")
        i += step
    return out


def parse_args_into_dataclasses(classes: Sequence[Type],
                                argv: Optional[Sequence[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    field_names = {f.name for cls in classes
                   for f in dataclasses.fields(cls)}

    # single-JSON-file mode
    if len(argv) == 1 and argv[0].endswith(".json"):
        from smb_vision_tpu.models.configs import legacy_fields

        blob = legacy_fields(json.loads(Path(argv[0]).read_text()), argv[0])
        flat = []
        for k, v in blob.items():
            if k in _HF_COMPAT and k not in field_names:
                flat += [f"--{k}", json.dumps(v)
                         if isinstance(v, (dict, list)) else str(v)]
        for tok in _hf_compat_argv(flat, field_names):
            if tok.startswith("--"):
                pending = tok[2:]
            else:
                blob[pending] = tok
        out = []
        for cls in classes:
            names = {f.name for f in dataclasses.fields(cls)}
            vals = {}
            for k, v in blob.items():
                if k not in names:
                    continue
                # mapped values arrive as strings; coerce to field type
                f = next(x for x in dataclasses.fields(cls) if x.name == k)
                hints = typing.get_type_hints(cls)
                vals[k] = _coerce(v, hints.get(k, str))
            out.append(cls(**vals))
        return tuple(out)
    argv = _hf_compat_argv(argv, field_names)

    parser = argparse.ArgumentParser()
    seen = set()
    for cls in classes:
        hints = typing.get_type_hints(cls)
        for f in dataclasses.fields(cls):
            if f.name in seen:
                continue
            seen.add(f.name)
            _add_field(parser, f, hints.get(f.name, str))
    ns = vars(parser.parse_args(argv))
    out = []
    for cls in classes:
        names = {f.name for f in dataclasses.fields(cls)}
        out.append(cls(**{k: v for k, v in ns.items() if k in names}))
    return tuple(out)
