"""The hand-written kernels as ``torch.library`` custom ops (``holostyle::``).

A ``ctypes`` launch is opaque to every graph capture (``torch.export``,
CUDA graphs, ``torch.compile``): each kernel entry point is therefore a
custom op under one namespace, registered by its kernel module with
``kernel_op``:

* the CPU implementation is the kernel's plain PyTorch version;
* the CUDA implementation is the ``ctypes`` launch, with the launch count
  and the profiler region inside it, so that every launch, eager or from a
  loaded ``ExportedProgram``, is counted and named. It makes its tensors
  contiguous itself (a no-op for a contiguous one): a traced graph keeps
  the strides its fake tensors had, and drops a ``.contiguous()`` that was
  a no-op there, while on the card a cuDNN conv of a channels-last input
  returns channels-last, which a kernel reading NCHW would misread;
* the fake implementation gives the outputs' shapes and dtypes, which is
  all ``torch.export`` sees of the kernel;
* where the kernel has a gradient, its backward (``register_autograd``).

The schema is read from the CPU implementation's annotations: tensors,
floats, ints and strings. A host-scalar distance stays a ``float``
argument, so ``asm_const`` keeps its meaning in a traced graph, where the
distance becomes a constant of the node.

Importing the kernel package registers every op (``kernels/__init__.py``
imports the four kernel modules); ``registered()`` names them. Neither
imports ``models`` or ``pipelines``, so a frozen artifact loads with the
ops and nothing of the model code.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

__all__ = ["NAMESPACE", "kernel_op", "registered", "graph_ops"]

NAMESPACE = "holostyle"

# name -> the registered op, in registration order.
_OPS: Dict[str, object] = {}


def kernel_op(name: str, cpu: Callable, cuda: Callable, fake: Callable, *,
              backward: Optional[Callable] = None,
              setup_context: Optional[Callable] = None):
    """Register ``holostyle::name``: ``cpu`` (annotated; its signature is the
    schema) for CPU tensors, ``cuda`` for CUDA tensors, ``fake`` for
    tracing, and with ``backward`` the op's gradient. Returns the op, which
    is called like ``cpu``."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu, mutates_args=(), device_types="cpu")
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    if backward is not None:
        op.register_autograd(backward, setup_context=setup_context)
    _OPS[name] = op
    return op


def registered() -> tuple:
    """The names of the registered ops (``holostyle::<name>``)."""
    return tuple(_OPS)


def graph_ops(graph) -> list:
    """The ``holostyle`` ops a ``torch.fx`` graph calls, one entry a node,
    as ``holostyle.<name>.default``."""
    return [str(n.target) for n in graph.nodes
            if n.op == "call_function" and str(n.target).startswith(NAMESPACE + ".")]
