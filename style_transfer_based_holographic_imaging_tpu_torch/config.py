"""Configuration of the port: the subset of the JAX package's config tree
that field retrieval reads.

Mirrors ``config.py`` of the JAX package (``PhysicsConfig``, ``ModelConfig``,
``EvalConfig``, ``ExperimentConfig.from_json``, and of ``DataConfig`` the
object amplitude that refinement takes as known). ``from_json`` parses a
run's full ``config.json`` and ignores what this port does not use yet (the
rest of ``data``, ``train``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass(frozen=True)
class PhysicsConfig:
    """Optical constants: 532 nm laser, 1.5 µm pixels, distances in mm."""

    wavelength: float = 532e-9          # metres
    pixel_size: float = 1.5e-6          # metres
    phase_normalize: float = 1.0        # multiplier applied to phase maps
    distance_normalize: float = 1.0     # d_metres = (d + const) * normalize * 1e-3
    distance_normalize_constant: float = 0.0
    pad_factor: int = 2                 # replicate-pad factor inside ASM
    band_limit: bool = False            # Matsushima-Shimobaba band limit

    def to_metres(self, d):
        """De-normalize a distance (network units -> metres)."""
        return (d + self.distance_normalize_constant) * self.distance_normalize * 1e-3

    def to_network_units(self, d_mm):
        """Millimetres -> network distance units (inverse of ``to_metres``
        up to the mm/m factor)."""
        return -self.distance_normalize_constant + d_mm / self.distance_normalize


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the style-transfer network."""

    image_size: int = 128
    width: float = 1.0                  # channel multiplier; 1.0 = flagship
    with_phase_decoder: bool = False
    n_enc_layers: int = 4
    style_channels: int = 512
    decoder_out_channels: int = 2
    distance_hidden: int = 1024
    dtype: str = "float32"
    param_dtype: str = "float32"


@dataclass(frozen=True)
class DataConfig:
    """The data section's fields that the port reads."""

    amplitude: float = 0.6              # constant object amplitude


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation settings."""

    save_dir: str = "output"
    exp_name: str = "MNIST_test"
    save_ext: str = ".png"
    alpha: float = 1.0
    unknown_distance: bool = True
    save_montages: bool = True
    report_jsonl: bool = True


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level bundle: the physics, model, data and eval sections of a run."""

    name: str = "mnist"
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentConfig":
        def build(tp, sub):
            if sub is None:
                return tp()
            names = {f.name for f in dataclasses.fields(tp)}
            return tp(
                **{
                    k: tuple(v) if isinstance(v, list) else v
                    for k, v in sub.items()
                    if k in names
                }
            )

        return cls(
            name=d.get("name", "mnist"),
            physics=build(PhysicsConfig, d.get("physics")),
            model=build(ModelConfig, d.get("model")),
            data=build(DataConfig, d.get("data")),
            eval=build(EvalConfig, d.get("eval")),
        )

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))
