"""Argparse <-> Config bridge of the port (a copy of
``movedepth_tpu/cli/options.py``): one flag per Config field."""

from __future__ import annotations

import argparse
import dataclasses

from movedepth_tpu_torch.config import Config


def add_config_args(parser: argparse.ArgumentParser):
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        default = f.default
        t = f.type
        if t == "bool" or isinstance(default, bool):
            parser.add_argument(name, action=argparse.BooleanOptionalAction,
                                default=default)
        elif isinstance(default, tuple):
            elem = int if (not default or isinstance(default[0], int)) else str
            parser.add_argument(name, nargs="+", type=elem, default=default)
        elif isinstance(default, int):
            parser.add_argument(name, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(name, type=float, default=default)
        else:
            parser.add_argument(name, type=str, default=default)
    return parser


def config_from_args(args: argparse.Namespace) -> Config:
    kw = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name)
        if isinstance(f.default, tuple) and v is not None:
            v = tuple(v)
        kw[f.name] = v
    return Config(**kw)
