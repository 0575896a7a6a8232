"""Dataclass-driven ``key=value,...`` CLI flag parsing (copy of
repro/launch/flags.py).

Every structured launcher flag (``--traffic``/``--adapt``/``--monitor`` on
launch/serve.py) is one compact spec string parsed against a config
dataclass: the dataclass's fields ARE the schema (names + type hints), so
flags never drift from the configs they build.  Unknown keys fail with the
same ``unknown key {k!r}; have [...]`` message everywhere.

    cfg = parse_kv_spec("shape=step,rate=1", TrafficConfig,
                        error=lambda m: p.error(f"--traffic: {m}"))
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Callable, Dict, Optional, Type, TypeVar

T = TypeVar("T")


def _unwrap_optional(tp):
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _convert(raw: str, tp):
    tp = _unwrap_optional(tp)
    if tp is bool:
        low = raw.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"not a bool: {raw!r}")
    if tp in (int, float, str):
        return tp(raw)
    return tp(raw)    # e.g. enums with a str constructor


def parse_kv_spec(spec: str, cls: Type[T], *,
                  aliases: Optional[Dict[str, str]] = None,
                  error: Optional[Callable[[str], None]] = None) -> T:
    """Parse ``"k=v,k=v"`` into dataclass ``cls``.

    ``aliases`` maps CLI spellings to field names (the CLI key replaces its
    target in the allowed set, keeping old flag vocabularies stable across
    dataclass renames).  ``error`` is called with the message on bad input
    (argparse's ``p.error`` — which raises SystemExit); by default a
    ValueError is raised.
    """
    aliases = aliases or {}

    def fail(msg: str):
        if error is not None:
            error(msg)        # argparse error() raises; belt-and-braces:
        raise ValueError(msg)

    hints = typing.get_type_hints(cls)
    field_names = {f.name for f in dataclasses.fields(cls)}
    # CLI vocabulary: aliased spellings replace their targets
    allowed = (field_names - set(aliases.values())) | set(aliases)

    kw = {}
    for tok in spec.split(","):
        if not tok.strip():
            continue
        k, sep, v = tok.partition("=")
        k, v = k.strip(), v.strip()
        if not sep:
            fail(f"expected key=value, got {tok.strip()!r}")
        if k not in allowed:
            fail(f"unknown key {k!r}; have {sorted(allowed)}")
        name = aliases.get(k, k)
        try:
            kw[name] = _convert(v, hints[name])
        except ValueError:
            fail(f"bad value for {k!r}: {v!r} "
                 f"(want {_unwrap_optional(hints[name]).__name__})")
    try:
        return cls(**kw)
    except (ValueError, TypeError) as e:   # dataclass __post_init__ checks
        fail(str(e))
