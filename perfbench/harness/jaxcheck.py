"""The no-JAX check: the port must run without JAX or the JAX package loaded."""
from __future__ import annotations

import sys

# Top-level module names that may not be loaded in a run, compared whole: the JAX
# package's name is a prefix of the port's, which passes.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax",
                       "future_urban_scene_generation_tpu"})


def forbidden_loaded(modules=None) -> list:
    """Sorted top-level names of ``modules`` (default ``sys.modules``) in FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


class JaxLoaded(RuntimeError):
    pass


def check(stage: str, modules=None) -> None:
    """Raise :class:`JaxLoaded`, naming what was found, if a forbidden module is loaded."""
    found = forbidden_loaded(modules)
    if found:
        raise JaxLoaded(f"{stage}: forbidden modules loaded: {', '.join(found)}")
