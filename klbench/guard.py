"""The import guard: a run fails when JAX, or the JAX package the port was
made from, is loaded in its process.

Modules are compared by their top-level name (the part before the first
dot), whole: ``repro_torch`` is the port and passes, ``repro`` fails.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    modules = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in modules} & FORBIDDEN)


def check() -> None:
    """Exit with code 3, naming what was found on standard error, if any
    forbidden module is loaded."""
    found = loaded()
    if found:
        print(f"klbench: forbidden modules loaded in the run's process: "
              f"{', '.join(found)}", file=sys.stderr, flush=True)
        raise SystemExit(3)
