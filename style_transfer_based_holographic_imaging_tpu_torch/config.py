"""Configuration of the port: the JAX package's config tree.

Mirrors ``config.py`` of the JAX package (``PhysicsConfig``, ``ModelConfig``,
``DataConfig``, ``TrainConfig``, ``EvalConfig``, ``ExperimentConfig.from_json``),
so a run's ``config.json`` loads whole. ``from_json`` ignores keys the port
does not know.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


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


def compute_dtype_name(name: str) -> str:
    """``ModelConfig.dtype`` as "float32" or "bfloat16" (the JAX package's
    ``_compute_dtype``: "bf16" and "fp32" are the same); anything else is
    refused."""
    if name in ("bfloat16", "bf16"):
        return "bfloat16"
    if name in ("float32", "fp32"):
        return "float32"
    raise ValueError(f"unsupported ModelConfig.dtype {name!r}")


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
    dtype: str = "float32"              # compute dtype: float32/fp32 or bfloat16/bf16
    param_dtype: str = "float32"

    def __post_init__(self):
        compute_dtype_name(self.dtype)


@dataclass(frozen=True)
class DataConfig:
    """Hologram synthesis (``data/synth.py``) and the served style plane."""

    batch_size: int = 8
    image_size: int = 128
    digit_pad: int = 32                 # 64x64 object padded to 128x128
    amplitude: float = 0.6              # constant object amplitude
    style_distances: Sequence[float] = (0.2,)  # mm; the first is the served style plane
    content_distances: Sequence[float] = (0.4, 0.5, 0.6, 0.7, 0.8)
    translate_frac: float = 0.1         # random-translate augmentation
    flip: bool = True
    # Per-sample phase scale and gamma jitter of the phase object;
    # (1.0, 1.0) ranges disable it.
    phase_scale_range: Sequence[float] = (0.7, 1.0)
    gamma_range: Sequence[float] = (0.6, 1.6)
    # Shape-diversity warp of the phase object: rotation (+/- deg) and a
    # smooth elastic displacement (px) on an elastic_cells^2 control grid;
    # 0 = off.
    rotate_deg: float = 0.0
    elastic_px: float = 0.0
    elastic_cells: int = 8
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """Optimization settings (``train/``), the JAX package's fields."""

    iterations: int = 20000              # the schedule's total length
    lr: float = 1e-4
    lr_decay: float = 5e-5
    lr_schedule: str = "invtime"         # 'invtime' lr/(1+decay*count) | 'cosine' to 2 %
    grad_clip_norm: float = 1.0          # global-norm clip of the gradient; 0 disables
    content_weight: float = 1.0
    style_weight: float = 10.0
    physics_weight: float = 10.0
    distance_weight: float = 10.0
    supervised_weight: float = 10.0      # direct field supervision (synthetic data)
    perceptual_weight: float = 0.0       # encoder-tap loss on the style-plane phase
    tv_weight: float = 0.0
    adv_weight: float = 0.0              # PatchGAN adversarial term
    use_dropout: bool = False            # train-mode Dropout(0.5) in the distance head;
                                         # off: a stochastic head scores far worse in
                                         # eval mode on the same data (JAX package)
    checkpoint_every: int = 5000
    log_every: int = 100
    checkpoint_dir: str = "checkpoints"
    remat: bool = False                 # recompute the network forward in the backward
                                        # (activation memory for about a third more work)
    grad_accum: int = 1                 # micro-batches a step, gradients averaged
    freeze_encoder: bool = True         # the encoder gets no update
    ema_decay: float = 0.0              # Polyak averaging of the generator; 0 = off
    tensorboard_dir: str = ""           # mirror the logged scalars to this event dir; "" = off
    dp_axis: str = "data"               # the mesh axis the batch is split over


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
    """Top-level bundle, one per run."""

    name: str = "mnist"
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

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
            train=build(TrainConfig, d.get("train")),
            eval=build(EvalConfig, d.get("eval")),
        )

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# The experimental domains' presets (the JAX package's, field for field).
# ---------------------------------------------------------------------------

def mnist_config() -> ExperimentConfig:
    """The bundled MNIST demo."""
    return ExperimentConfig(name="mnist")


def polystyrene_config() -> ExperimentConfig:
    """The polystyrene-bead domain: 5-20 mm recording distances, mapped into
    the distance head's (0, 1) by ``distance_normalize`` 25; band-limited,
    since that range lies far past the sampled transfer function's alias-free
    one (about 1.1 mm here)."""
    return ExperimentConfig(
        name="polystyrene_bead",
        physics=PhysicsConfig(distance_normalize=25.0, band_limit=True),
        data=DataConfig(
            style_distances=(8.0,),
            content_distances=tuple(float(d) for d in range(5, 21)),
        ),
    )


def red_blood_cell_config() -> ExperimentConfig:
    """The red-blood-cell streaming domain: 4-8 mm, band-limited."""
    return ExperimentConfig(
        name="red_blood_cell",
        physics=PhysicsConfig(distance_normalize=10.0, band_limit=True),
        data=DataConfig(
            style_distances=(6.0,),
            content_distances=(4.0, 5.0, 6.0, 7.0, 8.0),
        ),
    )


DOMAIN_PRESETS = {
    "mnist": mnist_config,
    "polystyrene": polystyrene_config,
    "polystyrene_bead": polystyrene_config,
    "tissue": polystyrene_config,
    "red_blood_cell": red_blood_cell_config,
    "rbc": red_blood_cell_config,
}
