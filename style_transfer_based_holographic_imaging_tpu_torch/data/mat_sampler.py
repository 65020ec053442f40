"""Training batches from measured ``.mat`` hologram trees (the JAX package's
``data/mat_sampler.py``).

``MeasuredHologramSampler`` is an endless, reproducible stream over a
``HoloMatDataset`` train split, shaped like ``InfiniteHologramSampler``'s
batches, so ``train.loop.train(sampler=...)`` takes either: B content
holograms from the content-distance folders and B style holograms from the
style-distance folders, each a random crop of the frame's sqrt-intensity,
flipped at random. Batch ``i`` draws from numpy's ``default_rng((seed, i))``,
as the JAX package's does, so the batches are its batches. The frames are
read once, at construction. Measured trees carry no complex ground truth,
so the batches have no ``phase_content``/``amplitude`` keys, and the
generator loss trains without its supervised term.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from style_transfer_based_holographic_imaging_tpu_torch.config import DataConfig, PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch.data.mat_loader import HoloMatDataset

__all__ = ["MeasuredHologramSampler"]


class MeasuredHologramSampler:
    """Endless (content, style) batch stream over a measured train tree.

    Args:
      root: dataset root (``root/train/holography/<distance>/*.mat``).
      data: batch size / image size / augmentation / seed, and the
        distance folders (mm) to draw style and content frames from.
      physics: distance normalization into network units.
      domain: tree layout or preset alias (see HoloMatDataset); inferred
        from ``root`` when None.

    ``iteration`` is the next batch's index; ``train.loop.train`` sets it to
    the state's step.
    """

    def __init__(
        self,
        root: str,
        data: DataConfig,
        physics: PhysicsConfig,
        *,
        domain: Optional[str] = None,
    ):
        self.data = data
        self.physics = physics
        self.iteration = 0
        style_d = tuple(data.style_distances)
        content_d = tuple(data.content_distances)
        all_d = sorted(set(style_d) | set(content_d))
        self.ds = HoloMatDataset(root, "train", all_d, domain=domain)
        by_d: Dict[float, List[int]] = {}
        for i, rec in enumerate(self.ds.records):
            by_d.setdefault(rec.distance, []).append(i)
        self._style_idx = np.asarray(
            [i for d in style_d for i in by_d.get(float(d), [])], np.int64
        )
        self._content_idx = np.asarray(
            [i for d in content_d for i in by_d.get(float(d), [])], np.int64
        )
        if not len(self._style_idx):
            raise ValueError(
                f"no style frames under {root!r} at distances {style_d} "
                f"(tree has {sorted(by_d)})"
            )
        if not len(self._content_idx):
            raise ValueError(
                f"no content frames under {root!r} at distances {content_d} "
                f"(tree has {sorted(by_d)})"
            )
        self._distances = np.asarray(
            [rec.distance for rec in self.ds.records], np.float32
        )
        self._frames = [self._load(i) for i in range(len(self.ds))]

    # ------------------------------------------------------------------

    @property
    def n_content(self) -> int:
        """Frames eligible as content draws."""
        return len(self._content_idx)

    @property
    def n_style(self) -> int:
        """Frames eligible as style draws."""
        return len(self._style_idx)

    def _load(self, i: int) -> np.ndarray:
        """(H, W) sqrt-intensity hologram, float32 (the net's input units)."""
        holo = self.ds[i]["holo"][0]
        if holo.shape[0] < self.data.image_size or holo.shape[1] < self.data.image_size:
            raise ValueError(
                f"{self.ds.records[i].holo_path}: frame {holo.shape} smaller "
                f"than the train patch {self.data.image_size}"
            )
        return np.sqrt(np.clip(holo, 0.0, None), dtype=np.float32)

    def _draw(
        self, rng: np.random.Generator, pool: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(B, 1, S, S) random-crop+flip patches and their (B, 1, 1, 1)
        distances in network units."""
        b, s = self.data.batch_size, self.data.image_size
        idx = pool[rng.integers(0, len(pool), b)]
        out = np.empty((b, 1, s, s), np.float32)
        for j, i in enumerate(idx):
            frame = self._frames[int(i)]
            oy = rng.integers(0, frame.shape[0] - s + 1)
            ox = rng.integers(0, frame.shape[1] - s + 1)
            patch = frame[oy : oy + s, ox : ox + s]
            if self.data.flip:
                if rng.integers(2):
                    patch = patch[::-1]
                if rng.integers(2):
                    patch = patch[:, ::-1]
            out[j, 0] = patch
        d_mm = self._distances[idx]
        d_net = np.asarray(
            self.physics.to_network_units(d_mm), np.float32
        ).reshape(b, 1, 1, 1)
        return out, d_net

    # ------------------------------------------------------------------

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.data.seed, self.iteration))
        self.iteration += 1
        content, d_c = self._draw(rng, self._content_idx)
        style, d_s = self._draw(rng, self._style_idx)
        return {
            "content_holo": content,
            "style_holo": style,
            "distance_content": d_c,
            "distance_style": d_s,
        }

    def style_batches(self, n_batches: int, *, seed: int = 1234):
        """Yield ``n_batches`` (B, 1, S, S) measured style-plane patches, batch
        ``i`` from ``default_rng((seed, i))``: the input of
        ``pipelines.style_vector.style_vector_from_holograms``."""
        for i in range(n_batches):
            rng = np.random.default_rng((seed, i))
            patches, _ = self._draw(rng, self._style_idx)
            yield patches
