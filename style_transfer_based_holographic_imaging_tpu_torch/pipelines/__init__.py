"""Eager end-to-end pipelines.

The names below load their module on first use, so that importing one
module of the package (``export_artifact``, which a serving host loads an
artifact with) imports no model code. ``autofocus`` and ``stylize`` are
imported here: each function shadows its module's name, as in the JAX
package, and neither module imports model code.
"""

import importlib

from style_transfer_based_holographic_imaging_tpu_torch.pipelines.autofocus import (
    autofocus,
    sharpness,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.stylize import stylize

_MODULES = {
    "domain_eval": ("evaluate_synth_domain",),
    "export_artifact": ("export_retrieval", "save_artifact", "load_artifact", "ArtifactRetrieval"),
    "field_retrieval": ("evaluate_golden_suite", "make_retrieval_fn", "retrieval_step"),
    "mat_eval": ("evaluate_mat_tree",),
    "refine": ("physics_refine", "refine_retrieval"),
    "server": ("RetrievalService", "ArtifactService", "retrieve_remote", "serve_forever"),
    "streaming": ("StreamStats", "stream_retrieval"),
    "style_vector": ("extract_style_vector", "save_style_vector", "style_vector_from_holograms"),
}
_HOME = {name: module for module, names in _MODULES.items() for name in names}

__all__ = sorted(set(_HOME) | {"autofocus", "sharpness", "stylize"})


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_HOME))
