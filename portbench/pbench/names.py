"""Checks on names: the modules a run may not load, and the characters a
benchmark name, unit or file may use."""

from __future__ import annotations

import re
import sys

# compared whole against each loaded module's top-level name, so the port,
# bwameme_tpu_torch, is not the JAX package bwameme_tpu
FORBIDDEN = ("jax", "jaxlib", "flax", "bwameme_tpu")

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    tops = {m.partition(".")[0] for m in names}
    return sorted(tops.intersection(FORBIDDEN))


def valid_name(s: str) -> bool:
    return bool(NAME.fullmatch(s))


def valid_unit(s: str) -> bool:
    return bool(UNIT.fullmatch(s))
