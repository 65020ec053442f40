"""Experimental-domain datasets: ``.mat`` hologram trees (the JAX package's
``data/mat_loader.py``, the reference's ``Holo_loader`` layouts).

Measured diffraction patterns are MATLAB files organized by
object-to-sensor distance:

* generic / train:      ``root/<split>/holography/<'%1.2f' % d>/*.mat``
* red_blood_cell:       ``root/<split>/holography/<'%1.1f' % d>/holography<j>.mat``
                        (300 test frames at d=6.0, 100 otherwise), ground
                        truth at ``root/test/gt_{amplitude,phase}/holography<j>.mat``
* polystyrene / tissue test: ``root/fov<1..16>/test/holography/<'%d' % d>/*.mat``
                        with ground truth at ``.../gt_amplitude/gt_amplitude<d-4>.mat``

Distances are parsed from the directory names once, at index time. Missing
ground truth gives no ``gt_*`` key (not the reference's all-ones stand-in).
``batches`` yields numpy stacks for the stream (``pipelines/streaming.py``),
a ragged last batch at its own size.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["MatRecord", "HoloMatDataset", "load_matfile", "DOMAIN_LAYOUTS"]

#: Preset-name aliases (``config.DOMAIN_PRESETS``) -> tree layouts.
DOMAIN_LAYOUTS = {
    "rbc": "red_blood_cell",
    "polystyrene_bead": "polystyrene",
    "mnist": "generic",
}
#: The variable that holds a hologram frame.
HOLO_KEY = "holography"


def load_matfile(path: str, key: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Read a MATLAB file: with ``key``, that variable through the native
    reader where it can serve it (``{key: float64 array}``); else every
    variable through ``scipy.io.loadmat``."""
    if key is not None:
        from style_transfer_based_holographic_imaging_tpu_torch.data.mat_native import (
            read_mat_2d,
        )

        arr = read_mat_2d(path, key)
        if arr is not None:
            return {key: arr}
    import scipy.io as sio

    return sio.loadmat(path)


@dataclass(frozen=True)
class MatRecord:
    holo_path: str
    distance: float                       # in the domain's native units (mm)
    gt_amplitude_path: Optional[str] = None
    gt_phase_path: Optional[str] = None


def _fmt_dir(d: float, style: str) -> str:
    if style == "int":
        return "%d" % int(d)
    if style == "1f":
        return "%1.1f" % d
    return "%1.2f" % d


class HoloMatDataset:
    """Flat index over a .mat hologram tree.

    Args:
      root: dataset root directory.
      image_set: "train" | "test".
      distances: the distance folders to include (mm).
      domain: "generic" | "polystyrene" | "tissue" | "red_blood_cell"
        (the tree layout), or a preset alias of one (``DOMAIN_LAYOUTS``);
        inferred from ``root``'s last name when None.
    """

    def __init__(
        self,
        root: str,
        image_set: str = "train",
        distances: Sequence[float] = (),
        *,
        domain: Optional[str] = None,
    ):
        self.root = root
        self.image_set = image_set
        domain = DOMAIN_LAYOUTS.get(domain, domain)
        if domain is None:
            base = os.path.basename(os.path.normpath(root))
            if "poly" in base:
                domain = "polystyrene"
            elif "tissue" in base:
                domain = "tissue"
            elif "red_blood_cell" in base or "rbc" in base:
                domain = "red_blood_cell"
            else:
                domain = "generic"
        self.domain = domain
        self.records: List[MatRecord] = []
        self._build_index(distances)

    # ------------------------------------------------------------------

    def _build_index(self, distances):
        for d in distances:
            if self.domain in ("polystyrene", "tissue") and self.image_set == "test":
                self._index_fov_tree(d)
            elif self.domain == "red_blood_cell":
                self._index_rbc(d)
            else:
                self._index_generic(d)

    def _index_generic(self, d: float):
        style = "int" if self.domain in ("polystyrene", "tissue") else "2f"
        dir_ = os.path.join(
            self.root, self.image_set, "holography", _fmt_dir(d, style)
        )
        if not os.path.isdir(dir_):
            return
        for name in sorted(os.listdir(dir_)):
            if name.endswith(".mat"):
                self.records.append(MatRecord(os.path.join(dir_, name), float(d)))

    def _index_fov_tree(self, d: float):
        """Polystyrene/tissue test layout: per-fov trees with shared GT
        (gt index = distance - 4)."""
        for fov in range(1, 17):
            fov_root = os.path.join(self.root, f"fov{fov}", "test")
            holo_dir = os.path.join(fov_root, "holography", _fmt_dir(d, "int"))
            if not os.path.isdir(holo_dir):
                continue
            gt_idx = int(d) - 4
            gt_amp = os.path.join(fov_root, "gt_amplitude", f"gt_amplitude{gt_idx}.mat")
            gt_ph = os.path.join(fov_root, "gt_phase", f"gt_phase{gt_idx}.mat")
            for name in sorted(os.listdir(holo_dir)):
                if name.endswith(".mat"):
                    self.records.append(
                        MatRecord(
                            os.path.join(holo_dir, name),
                            float(d),
                            gt_amp if os.path.isfile(gt_amp) else None,
                            gt_ph if os.path.isfile(gt_ph) else None,
                        )
                    )

    def _index_rbc(self, d: float):
        dir_ = os.path.join(self.root, self.image_set, "holography", _fmt_dir(d, "1f"))
        if self.image_set == "test":
            n = 300 if d == 6.0 else 100
            for j in range(1, n + 1):
                p = os.path.join(dir_, f"holography{j}.mat")
                if os.path.isfile(p):
                    gt_amp = os.path.join(
                        self.root, "test", "gt_amplitude", f"holography{j}.mat"
                    )
                    gt_ph = os.path.join(
                        self.root, "test", "gt_phase", f"holography{j}.mat"
                    )
                    self.records.append(
                        MatRecord(
                            p,
                            float(d),
                            gt_amp if os.path.isfile(gt_amp) else None,
                            gt_ph if os.path.isfile(gt_ph) else None,
                        )
                    )
        else:
            if not os.path.isdir(dir_):
                return
            for name in sorted(os.listdir(dir_)):
                if name.endswith(".mat"):
                    self.records.append(MatRecord(os.path.join(dir_, name), float(d)))

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rec = self.records[i]
        holo = np.asarray(load_matfile(rec.holo_path, HOLO_KEY)[HOLO_KEY], np.float32)
        item = {
            "holo": holo[None] if holo.ndim == 2 else holo,
            "distance": np.float32(rec.distance),
        }
        if rec.gt_amplitude_path:
            gt = load_matfile(rec.gt_amplitude_path, "gt_amplitude")["gt_amplitude"]
            item["gt_amplitude"] = np.asarray(gt, np.float32)[None]
        if rec.gt_phase_path:
            gt = load_matfile(rec.gt_phase_path, "gt_phase")["gt_phase"]
            item["gt_phase"] = np.asarray(gt, np.float32)[None]
        return item

    def batches(self, batch_size: int):
        """Yield batched numpy dicts (holo: (B,1,H,W), distance: (B,1,1,1)),
        the last at its own size."""
        n = len(self)
        for start in range(0, n, batch_size):
            idx = range(start, min(start + batch_size, n))
            items = [self[i] for i in idx]
            batch = {
                "holo": np.stack([it["holo"] for it in items]),
                "distance": np.asarray(
                    [it["distance"] for it in items], np.float32
                ).reshape(-1, 1, 1, 1),
            }
            if all("gt_amplitude" in it for it in items):
                batch["gt_amplitude"] = np.stack([it["gt_amplitude"] for it in items])
            if all("gt_phase" in it for it in items):
                batch["gt_phase"] = np.stack([it["gt_phase"] for it in items])
            yield batch
