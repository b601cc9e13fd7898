"""Where a configuration's host spans and planted faults attach. A target
is "agent", or "agent.<attribute>..." on the object that the cell's driver
built (an agent without a replay ring simply names no target on one), or
else the import name of one of the program's modules; a hook is a target
and the name of the function on it to wrap."""

from __future__ import annotations

import importlib

ROOT = "agent"


def resolve(agent, target: str):
    """The object that `target` names."""
    head, _, rest = target.partition(".")
    if head != ROOT:
        return importlib.import_module(target)
    obj = agent
    for part in filter(None, rest.split(".")):
        obj = getattr(obj, part)
    return obj
