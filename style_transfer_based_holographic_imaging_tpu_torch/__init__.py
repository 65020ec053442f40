"""PyTorch/CUDA port of the holostyle field-retrieval framework.

A second package beside the JAX one (``style_transfer_based_holographic_imaging_tpu``),
written in PyTorch, with the JAX package's Pallas TPU kernels rewritten by hand
for NVIDIA Hopper (CUDA C++ under ``kernels/csrc``, built with ``nvcc`` at first
use, loaded with ``ctypes`` and registered as ``torch.library`` custom ops,
``holostyle::*``). It imports ``torch`` and ``numpy`` only: never ``jax`` and
nothing of the JAX package.

Subpackages mirror the JAX package's layout:

- ``ops``       — angular-spectrum propagation, hologram formation, phase
                  unwrap, AdaIN statistics.
- ``kernels``   — the hand-written CUDA kernels as custom ops, their
                  wrappers and plain PyTorch versions.
- ``models``    — ``nn.Module`` networks: VGG encoder, decoder, distance MLP,
                  the PatchGAN discriminator.
- ``pipelines`` — eager end-to-end field retrieval, the golden-suite eval,
                  physics refinement, autofocus, the HTTP server and the
                  stream, the frozen ``torch.export`` artifact and its
                  service, the measured-tree and synthetic-domain evals,
                  style vectors, stylize.
- ``data``      — the golden suite, hologram synthesis and the object banks,
                  the measured ``.mat`` tree and its sampler, the host ->
                  card prefetch.
- ``eval``      — the metrics and the reports (montages, box plot, jsonl).
- ``utils``     — ``jax.random``'s threefry stream in numpy, profiling.
- ``train``     — the generator's and discriminator's losses, the optax-faithful
                  train state (Adam, clip, EMA, checkpoints) and the loop.
- ``interop``   — carrying JAX parameter trees (as numpy) across, and a
                  release's weights from its numpy file.
- ``parallel``  — the device mesh and its process world (one process a
                  position), batch data parallelism, ZeRO-1/FSDP and channel
                  tensor parallelism with explicit collectives.
- ``cli``       — ``python -m style_transfer_based_holographic_imaging_tpu_torch.cli
                  eval|train|extract-style|stream|autofocus|serve|export|
                  sweep|synth-bench|doctor``.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.

TF32 is switched off when the package is imported
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``): cuDNN would otherwise run every
fp32 convolution in TF32 (about three decimal digits), and parity with the
fp32 JAX package, and of each kernel with its plain version, needs full fp32.
"""

import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import (
    DOMAIN_PRESETS,
    DataConfig,
    EvalConfig,
    ExperimentConfig,
    ModelConfig,
    PhysicsConfig,
    TrainConfig,
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
    "TrainConfig",
    "DOMAIN_PRESETS",
    "__version__",
]
