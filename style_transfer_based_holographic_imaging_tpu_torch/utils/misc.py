"""Host-side helpers shared by the ops and pipelines."""

from __future__ import annotations

import numpy as np

__all__ = ["static_scalar"]


def static_scalar(x) -> float | None:
    """``float(x)`` if ``x`` is a host scalar, else None.

    The one detector for "this value is configuration, not data": a Python
    int/float (not bool), a numpy scalar, or a size-1 numpy array. Tensors
    return None: whether to fetch one from the device is the caller's
    policy (see ``pipelines.field_retrieval._hoist_scalar``). A host-scalar
    distance routes the propagator to its constant-transfer-function kernel.
    """
    if isinstance(x, bool):
        return None
    if isinstance(x, (int, float)):
        return float(x)
    if isinstance(x, (np.floating, np.integer)):
        return float(x)
    if isinstance(x, np.ndarray) and x.size == 1:
        return float(x.reshape(-1)[0])
    return None
