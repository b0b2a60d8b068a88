"""Command-line launchers of the port."""
from __future__ import annotations

import json


def parse_overrides(pairs: list[str]) -> dict:
    """``--set`` entries ["field=value", ...] -> config overrides; values
    parse as JSON where they can, else stay strings."""
    overrides = {}
    for kv in pairs:
        k, sep, v = kv.partition("=")
        if not sep:
            raise SystemExit(f"--set entries are field=value, got {kv!r}")
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    return overrides
