"""PyTorch/CUDA port of the holostyle field-retrieval framework.

A second package beside the JAX one (``style_transfer_based_holographic_imaging_tpu``),
written in PyTorch, with the JAX package's Pallas TPU kernels rewritten by hand
for NVIDIA Hopper (CUDA C++ under ``kernels/csrc``, built with ``nvcc`` at first
use and loaded with ``ctypes``). It imports ``torch`` and ``numpy`` only: never
``jax`` and nothing of the JAX package.

Subpackages mirror the JAX package's layout:

- ``ops``       — angular-spectrum propagation, hologram formation, phase
                  unwrap, AdaIN statistics.
- ``kernels``   — the hand-written CUDA kernels, their wrappers and plain
                  PyTorch versions.
- ``models``    — ``nn.Module`` networks: VGG encoder, decoder, distance MLP.
- ``pipelines`` — eager end-to-end field retrieval, the golden-suite eval,
                  physics refinement and autofocus.
- ``train``     — losses (so far the TV regulariser refinement uses).
- ``interop``   — carrying JAX parameter trees (as numpy) across.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.

TF32 is switched off when the package is imported
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``): cuDNN would otherwise run every
fp32 convolution in TF32 (about three decimal digits), and parity with the
fp32 JAX package, and of each kernel with its plain version, needs full fp32.
"""

import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import (
    DataConfig,
    EvalConfig,
    ExperimentConfig,
    ModelConfig,
    PhysicsConfig,
)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"

__all__ = [
    "PhysicsConfig",
    "ModelConfig",
    "DataConfig",
    "EvalConfig",
    "ExperimentConfig",
    "__version__",
]
