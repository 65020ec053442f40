"""The golden MNIST suite: the reference's 20 x 5 bundled fixtures.

Read by path, with ``numpy.load``, from the data file that ships beside the
JAX package (``style_transfer_based_holographic_imaging_tpu/data/golden_mnist.npz``);
the port keeps no copy of it and imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np

__all__ = ["GoldenSuite", "load_golden_suite", "GOLDEN_NPZ", "GOLDEN_HELDOUT_BATCHES"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN_NPZ = os.path.join(
    _REPO_ROOT, "style_transfer_based_holographic_imaging_tpu", "data", "golden_mnist.npz"
)
# Batches whose digits the default mixed training bank never sees: the
# held-out half of the suite.
GOLDEN_HELDOUT_BATCHES = range(10, 20)


@dataclass(frozen=True)
class GoldenSuite:
    """The 100-sample golden suite, batch-major."""

    content_holo: np.ndarray      # (20, 5, 1, 128, 128) intensity
    distance_style: np.ndarray    # (20, 5, 1, 1, 1) mm
    distance_content: np.ndarray  # (20, 5, 1, 1, 1) mm
    gt_amplitude: np.ndarray      # (20, 5, 1, 128, 128)
    gt_phase: np.ndarray          # (20, 5, 1, 128, 128)
    style_mean: np.ndarray        # (1, 1, 1, 512) AdaIN style means (NHWC)
    style_std: np.ndarray         # (1, 1, 1, 512)

    @property
    def n_batches(self) -> int:
        return self.content_holo.shape[0]

    @property
    def batch_size(self) -> int:
        return self.content_holo.shape[1]

    def subset(self, n_batches: int) -> "GoldenSuite":
        """The first ``n_batches`` batches; the style vector carries over."""
        return dataclasses.replace(
            self,
            **{
                f: getattr(self, f)[:n_batches]
                for f in ("content_holo", "distance_style", "distance_content",
                          "gt_amplitude", "gt_phase")
            },
        )


def load_golden_suite(npz_path: str = GOLDEN_NPZ) -> GoldenSuite:
    """Load the golden suite from its npz file."""
    with np.load(npz_path) as z:
        return GoldenSuite(**{k: z[k] for k in z.files})
