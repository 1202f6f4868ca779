"""Argparse bridge for the config dataclasses (port of
``radegs_tpu/train/arguments.py``).

Mirrors the reference's reflection-based ParamGroup (arguments/__init__.py:
19-45): every dataclass field becomes a flag, bools become store_true, and
``get_combined_args`` merges CLI overrides on top of a saved run's
``cfg_args`` (arguments/__init__.py:101-121) — without the reference's
eval(): the Namespace repr is parsed with ``ast``. The ``cfg_args`` text is
the same in both packages, so each reads the other's.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os

# fields that get single-letter shorthands, as in the reference (leading _)
SHORTHANDS = {"source_path": "s", "model_path": "m", "images": "i", "resolution": "r",
              "white_background": "w"}


def add_group(parser: argparse.ArgumentParser, cls, name: str):
    g = parser.add_argument_group(name)
    for f in dataclasses.fields(cls):
        flags = [f"--{f.name}"]
        if f.name in SHORTHANDS:
            flags.append(f"-{SHORTHANDS[f.name]}")
        if f.type in ("bool", bool):
            g.add_argument(*flags, action="store_true", default=f.default)
        else:
            ty = type(f.default) if f.default is not None else str
            g.add_argument(*flags, type=ty, default=f.default)
    return cls


def extract(cls, args: argparse.Namespace):
    return cls(**{f.name: getattr(args, f.name) for f in dataclasses.fields(cls)})


def save_cfg_args(model_path: str, mcfg):
    """train.py:227-228: the model parameters, for a later get_combined_args."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(repr(argparse.Namespace(**dataclasses.asdict(mcfg))))


def load_cfg_args(model_path: str) -> dict:
    """A saved cfg_args Namespace repr as a dict, parsed without eval()."""
    with open(os.path.join(model_path, "cfg_args")) as f:
        text = f.read().strip()
    if not (text.startswith("Namespace(") and text.endswith(")")):
        raise ValueError(f"{model_path}/cfg_args is not a Namespace repr")
    node = ast.parse(f"dict({text[len('Namespace('):-1]})", mode="eval")
    return {kw.arg: ast.literal_eval(kw.value) for kw in node.body.keywords}


def get_combined_args(parser: argparse.ArgumentParser, argv=None):
    """Inference-time merge: the saved cfg_args under explicit CLI values
    (arguments/__init__.py:101-121)."""
    args = parser.parse_args(argv)
    defaults = {a.dest: parser.get_default(a.dest) for a in parser._actions}
    merged = vars(args).copy()
    if getattr(args, "model_path", None):
        if os.path.exists(os.path.join(args.model_path, "cfg_args")):
            for k, v in load_cfg_args(args.model_path).items():
                if k in merged and merged[k] == defaults.get(k):
                    merged[k] = v
    return argparse.Namespace(**merged)
