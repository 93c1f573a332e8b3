"""Shared warn-once deprecation helper.  Counterpart of
``repro/deprecation.py`` (a copy: the port imports nothing of the JAX
package).

The legacy shims (``core.balancer.DynamicLoadBalancer``,
``distributed.balancer.DistributedBalancer``, the ``fem.adapt`` drivers,
``serve.engine.ServeEngine``) each warn exactly once per process.  One
registry here, keyed by shim name, with one test hook.

Per-module ``_reset_deprecation_warning`` hooks remain as thin wrappers
over :func:`reset` so existing test imports keep working.
"""
from __future__ import annotations

import warnings
from typing import Optional, Set

__all__ = ["reset", "warn_once"]

_WARNED: Set[str] = set()


def warn_once(key: str, message: str, *, stacklevel: int = 4) -> None:
    """Emit ``DeprecationWarning(message)`` the first time ``key`` is
    seen this process; later calls are silent.

    ``stacklevel`` defaults to 4 so the warning points at the *user's*
    call site: user -> shim -> module wrapper -> here.
    """
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)


def reset(key: Optional[str] = None) -> None:
    """Test hook: forget ``key`` (or every key when ``None``) so the
    next :func:`warn_once` fires again."""
    if key is None:
        _WARNED.clear()
    else:
        _WARNED.discard(key)
