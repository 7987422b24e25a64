"""Process-level flags (counterpart of paddle_tpu/flags.py; reference
platform/flags.cc, read and written through fluid.set_flags /
fluid.get_flags).

The same contract: a flag declares a name, a default and a doc;
a `FLAGS_<name>` environment variable overrides the default when this
module is imported; set_flags/get_flags read and write at run time. Only
the flags the port acts on are declared.
"""

from __future__ import annotations

import os

_FLAGS: dict[str, object] = {}
_DOCS: dict[str, str] = {}


def _declare(name, default, doc):
    env = os.environ.get("FLAGS_" + name)
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    else:
        value = default
    _FLAGS[name] = value
    _DOCS[name] = doc


_declare(
    "paddle_tpu_pallas_layer_norm", False,
    "Route layer_norm (and, in programs built with the flag on, its "
    "dedicated layer_norm_grad op) through the standalone LayerNorm "
    "kernels (kernels/layer_norm.py). Off by default: the kernels are for "
    "workloads where LN is isolated, such as pre-LN GPT; BERT's LNs take "
    "the fused residual kernels instead.",
)


def get_flags(flags):
    """fluid.get_flags parity: str or list -> {"FLAGS_name": value}."""
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for f in flags:
        if f.startswith("FLAGS_"):
            f = f[len("FLAGS_"):]
        if f not in _FLAGS:
            raise ValueError(f"unknown flag {f!r}")
        out["FLAGS_" + f] = _FLAGS[f]
    return out


def set_flags(flags_dict):
    """fluid.set_flags parity: {"FLAGS_name": value}."""
    for k, v in flags_dict.items():
        name = k[len("FLAGS_"):] if k.startswith("FLAGS_") else k
        if name not in _FLAGS:
            raise ValueError(f"unknown flag {name!r}")
        _FLAGS[name] = v


def flag(name):
    return _FLAGS[name]


def flag_docs():
    return dict(_DOCS)
