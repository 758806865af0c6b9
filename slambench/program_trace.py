"""The program's own spans and counters (``snakeslam_tpu_torch/system/
stats.py``), for the per-layer metrics that read them.

The program's tracer is off unless something turns it on.  A reader that
names ``SWITCH`` among its ``PROBES`` has it on for the measured window:
the harness installs the probes its readers name as the window opens and
removes them as it closes (``harness.run_window``), and ``TRACER`` turns
the program's tracer on, its records reset, when the probe replaces
``TRACER.window``, and off when the probe puts it back.  Nothing calls
``window`` itself.  A program without the tracer has no records to read:
the readers then return None.
"""

from __future__ import annotations

import importlib

SWITCH = "program_trace:TRACER.window"


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        mod = importlib.import_module("snakeslam_tpu_torch.system.stats")
    except ImportError:
        return None
    return mod if hasattr(mod, "records") else None


class _Switch:
    def window(self):
        """Replaced by a probe for the window's length; never called."""

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        t = tracer()
        if name != "window" or t is None:
            return
        if getattr(value, "__func__", None) is _Switch.window:
            t.disable()
        else:
            t.reset()
            t.enable()


TRACER = _Switch()


def spans():
    """The program's spans of the window, ``Record``s of ``stats.py``
    (open ones included, with ``t1`` None); None where the program has no
    tracer or recorded nothing."""
    t = tracer()
    recs = t.records() if t is not None else None
    return recs or None


def counters() -> dict | None:
    t = tracer()
    return t.counters() if t is not None else None


def durations_ns(recs, name: str) -> list[int]:
    """The closed spans named ``name``, each one's ns."""
    return [r.t1 - r.t0 for r in recs if r.name == name and r.t1 is not None]


def less_descendants_ns(recs, name: str, minus) -> list[int]:
    """Per closed span named ``name``: its ns less the time covered by its
    descendants named in ``minus`` (the outermost of them: one of those
    inside another is covered once)."""
    children: dict[int, list[int]] = {}
    for i, r in enumerate(recs):
        if r.parent >= 0:
            children.setdefault(r.parent, []).append(i)
    out = []
    for i, r in enumerate(recs):
        if r.name != name or r.t1 is None:
            continue
        covered = 0
        todo = list(children.get(i, ()))
        while todo:
            j = todo.pop()
            c = recs[j]
            if c.name in minus and c.t1 is not None:
                covered += c.t1 - c.t0
            else:
                todo += children.get(j, ())
        out.append(r.t1 - r.t0 - covered)
    return out
