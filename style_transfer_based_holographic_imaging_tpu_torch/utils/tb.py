"""TensorBoard scalar mirroring for the training loop (port of the JAX
package's ``utils/tb.py``).

The structured sink is the JSONL file beside the checkpoints; a TensorBoard
event directory (``TrainConfig.tensorboard_dir``) mirrors it. tensorboardX
is imported when a writer is made, so a machine without it still trains:
the writer warns once on stderr and every call does nothing.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

__all__ = ["ScalarWriter", "make_writer"]


class ScalarWriter:
    """Per-log-step scalars under ``train/<tag>`` in an event directory:
    :meth:`write` each log step, :meth:`close` at the end of training."""

    def __init__(self, logdir: str):
        self._writer = None
        try:
            from tensorboardX import SummaryWriter
        except Exception as e:
            print("style_transfer_based_holographic_imaging_tpu_torch: tensorboard_dir set but "
                  f"tensorboardX is unavailable ({type(e).__name__}: {e}); scalar mirroring "
                  "disabled (JSONL sink unaffected)", file=sys.stderr)
            return
        self._writer = SummaryWriter(logdir=logdir)

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        if self._writer is None:
            return
        for tag, value in scalars.items():
            self._writer.add_scalar(f"train/{tag}", float(value), step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def make_writer(logdir: str) -> Optional[ScalarWriter]:
    """A ``ScalarWriter`` for a non-empty directory, else None (mirroring off)."""
    return ScalarWriter(logdir) if logdir else None
