"""Hologram synthesis: the training data path (port of the JAX ``data/synth.py``).

A batch is made in two parts:

* **draws** (``draw_batch``): the digit indices, flips, shifts, phase scale
  and gamma, distance indices, rotation angles and elastic flow cells, taken
  on the host from a ``torch.Generator``. ``InfiniteHologramSampler`` seeds
  one from ``(data.seed, iteration)``, so iteration N is the same on the CPU
  and on the card, and after a resume. The JAX package draws the same
  quantities with ``jax.random``; the two streams differ, and the tests hand
  the JAX package's draws to ``render_batch``.
* **render** (``render_batch``): everything else, on the bank's device:
  gamma and scale, the rotation and elastic warp (``jax.image.resize``'s
  cubic weights, ``map_coordinates``' bilinear gather with zero fill, both
  written out), the zero pad, flip and roll, and the holograms. They are
  ``ops.holo.holo_forward`` with a per-sample distance, under ``no_grad``:
  on a CUDA tensor the ``asm_dynamic`` kernel, two launches a batch (style
  and content), as the JAX package's synthesis takes its Pallas kernel on
  the TPU.

The JAX package's evaluation streams (the domain records,
``extract_style_vector``) key ``synth_batch`` with ``jax.random``:
``jax_key_draws`` takes the same draws from a numpy reproduction of that
stream (``utils/jax_random.py``), and ``synth_batch_from_key`` renders them,
so those batches are the JAX package's, the warp's rotations and flows
included; ``synth_interpolation_batch`` (the ``sweep`` command's) draws its
digit and distance from that stream too. The training stream keeps its
``torch.Generator``.

Banks: ``golden_digit_bank`` (the golden suite's GT digits),
``load_digit_bank`` (an ``.npz``), ``sklearn_digit_bank`` /
``mixed_digit_bank``, which need ``sklearn`` and raise where it is absent,
``morphed_digit_bank`` (a bank widened by affine, elastic and stroke
morphs, the JAX package's ``jax.random`` stream), and the experimental
domains' ``bead_bank`` and ``rbc_bank`` (numpy, seeded).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import DataConfig, PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch.data.goldens import GOLDEN_HELDOUT_BATCHES
from style_transfer_based_holographic_imaging_tpu_torch.ops.holo import holo_forward
from style_transfer_based_holographic_imaging_tpu_torch.utils import jax_random

__all__ = [
    "load_digit_bank",
    "sklearn_digit_bank",
    "golden_digit_bank",
    "mixed_digit_bank",
    "morphed_digit_bank",
    "GOLDEN_TRAIN_DIGITS",
    "GOLDEN_HELDOUT_BATCHES",
    "bead_bank",
    "rbc_bank",
    "resize_cubic",
    "draw_batch",
    "jax_key_draws",
    "render_batch",
    "synth_batch",
    "synth_batch_from_key",
    "synth_interpolation_batch",
    "stream_generator",
    "InfiniteHologramSampler",
]

# The golden suite's first 50 digits train; batches 10..19 stay unseen.
GOLDEN_TRAIN_DIGITS = slice(0, 50)

_F32 = np.float32


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel, a = -0.5, in fp32 (``jax.image``'s)."""
    out = ((_F32(1.5) * x - _F32(2.5)) * x) * x + _F32(1.0)
    out = np.where(x >= 1.0, ((_F32(-0.5) * x + _F32(2.5)) * x - _F32(4.0)) * x + _F32(2.0), out)
    return np.where(x >= 2.0, _F32(0.0), out).astype(_F32)


def cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """``(in_size, out_size)`` fp32 weights of ``jax.image.resize(...,
    "cubic")`` along one axis (``compute_weight_mat``, antialiased): the
    kernel widened by the inverse scale when shrinking, each output's taps
    renormalized to sum to one, outputs whose sample lies outside the input
    zeroed."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = _F32(max(inv_scale, 1.0))
    sample = (np.arange(out_size, dtype=_F32) + _F32(0.5)) * _F32(inv_scale) - _F32(0.0) - _F32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=_F32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True, dtype=_F32)
    w = np.where(np.abs(total) > _F32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, _F32(1.0)), _F32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, _F32(0.0)).astype(_F32)


def resize_cubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``jax.image.resize(x, (..., height, width), "cubic")`` of the last two
    axes, fp32, on ``x``'s device. An axis whose size stays is left alone."""
    x = x.float()
    h, w = x.shape[-2], x.shape[-1]
    if h != height:
        wh = torch.from_numpy(cubic_weights(h, height)).to(x.device)
        x = torch.einsum("...hw,ho->...ow", x, wh)
    if w != width:
        ww = torch.from_numpy(cubic_weights(w, width)).to(x.device)
        x = torch.einsum("...hw,wo->...ho", x, ww)
    return x


def _gather2d(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """``img[b, iy, ix]`` per sample, indices clamped into range."""
    b, h, w = img.shape
    flat = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    return img.reshape(b, h * w).gather(1, flat.reshape(b, -1)).reshape(iy.shape)


def _map_coordinates_linear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.ndimage.map_coordinates(img, [ys, xs], order=1,
    mode="constant", cval=0)`` per sample: the four taps in JAX's order,
    each weight ``wy * wx`` times the tap (0 outside the image), summed in
    order, with integer index math."""
    h, w = img.shape[-2], img.shape[-1]
    nodes = []
    for coord in (ys, xs):
        lower = torch.floor(coord)
        upper_w = coord - lower
        idx = lower.to(torch.int64)
        nodes.append(((idx, 1.0 - upper_w), (idx + 1, upper_w)))
    out = None
    for iy, wy in nodes[0]:
        for ix, wx in nodes[1]:
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            tap = torch.where(valid, _gather2d(img, iy, ix), 0.0)
            term = (wy * wx) * tap
            out = term if out is None else out + term
    return out


def _shape_warp(img: torch.Tensor, angle_deg: torch.Tensor, flow: Optional[torch.Tensor],
                elastic_px: float) -> torch.Tensor:
    """Per-sample rotation by ``angle_deg`` ``(B,)`` and elastic warp by
    ``flow`` ``(B, 2, cells, cells)`` upsampled cubically, of ``(B, S, S)``
    phase objects: one bilinear gather at the displaced inverse-rotation
    grid (the JAX ``_shape_warp``)."""
    b, s = img.shape[0], img.shape[-1]
    grid = torch.arange(s, dtype=torch.float32, device=img.device)
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")
    c = (s - 1) / 2.0
    theta = (angle_deg * float(_F32(np.pi / 180.0))).reshape(b, 1, 1)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    ys = (yy - c) * cos_t - (xx - c) * sin_t + c
    xs = (yy - c) * sin_t + (xx - c) * cos_t + c
    if elastic_px:
        up = resize_cubic(flow, s, s) * elastic_px
        ys = ys + up[:, 0]
        xs = xs + up[:, 1]
    return _map_coordinates_linear(img, ys, xs)


def _morph_draws(keys: np.ndarray, *, rotate_deg: float, scale_range, shear: float,
                 elastic_px: float, elastic_cells: int, thickness: float) -> Dict[str, np.ndarray]:
    """The draws of the JAX ``_morph_digit`` for each of ``keys`` ``(B, 2)``:
    each key split in five (rotation, scale, shear, flow, thickness), a
    ``uniform`` angle in radians ``(B,)``, scales ``(B, 2)`` (y, x), shear
    ``(B,)``, with ``elastic_px`` a ``normal`` flow ``(B, 2, cells, cells)``
    and with ``thickness`` a ``uniform`` lerp weight ``(B,)``."""
    ks = jax_random.split(keys, 5)
    out = {
        "theta": jax_random.uniform(ks[:, 0], (), -rotate_deg, rotate_deg) * _F32(np.pi / 180.0),
        "scale": jax_random.uniform(ks[:, 1], (2,), scale_range[0], scale_range[1]),
        "shear": jax_random.uniform(ks[:, 2], (), -shear, shear),
    }
    if elastic_px:
        out["flow"] = jax_random.normal(ks[:, 3], (2, elastic_cells, elastic_cells))
    if thickness:
        out["thick"] = jax_random.uniform(ks[:, 4], (), -thickness, thickness)
    return out


def _morph_digits(img: torch.Tensor, draws: Dict[str, np.ndarray], *, elastic_px: float) -> torch.Tensor:
    """The JAX ``_morph_digit`` of each ``(S, S)`` digit of ``img`` ``(B, S,
    S)`` with its ``draws`` (``_morph_draws``), on ``img``'s device: the
    digit sampled bilinearly at the inverse of rotation @ shear @
    diag(sy, sx) about the centre, displaced by the cubic-upsampled flow,
    then lerped toward its 3x3 grey dilation (weight t >= 0) or erosion
    (t < 0), clipped to [0, 1]."""
    dev = img.device
    b, s = img.shape[0], img.shape[-1]
    theta = draws["theta"].astype(_F32)
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    rot = np.stack([np.stack([cos_t, -sin_t], -1), np.stack([sin_t, cos_t], -1)], -2)
    shr = np.zeros((b, 2, 2), _F32)
    shr[:, 0, 0] = shr[:, 1, 1] = 1.0
    shr[:, 0, 1] = draws["shear"]
    diag = np.zeros((b, 2, 2), _F32)
    diag[:, 0, 0], diag[:, 1, 1] = draws["scale"][:, 0], draws["scale"][:, 1]
    inv = torch.from_numpy(np.linalg.inv(rot @ shr @ diag).astype(_F32)).to(dev)
    grid = torch.arange(s, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")
    c = (s - 1) / 2.0
    m = [inv[:, i, j].reshape(b, 1, 1) for i in range(2) for j in range(2)]
    ys = m[0] * (yy - c) + m[1] * (xx - c) + c
    xs = m[2] * (yy - c) + m[3] * (xx - c) + c
    if elastic_px:
        up = resize_cubic(torch.from_numpy(draws["flow"]).to(dev), s, s) * elastic_px
        ys = ys + up[:, 0]
        xs = xs + up[:, 1]
    out = _map_coordinates_linear(img, ys, xs)
    if "thick" in draws:
        x4 = out[:, None]
        dil = torch.nn.functional.max_pool2d(x4, 3, 1, 1)[:, 0]        # -inf pad
        ero = -torch.nn.functional.max_pool2d(-x4, 3, 1, 1)[:, 0]      # +inf pad
        t = torch.from_numpy(draws["thick"]).to(dev).reshape(b, 1, 1)
        out = torch.where(t >= 0.0, out * (1.0 - t) + dil * t, out * (1.0 + t) - ero * t)
    return out.clamp(0.0, 1.0)


def morphed_digit_bank(base: np.ndarray, n: int, *, seed: int = 0, rotate_deg: float = 25.0,
                       scale_range=(0.8, 1.15), shear: float = 0.2, elastic_px: float = 5.0,
                       elastic_cells: int = 8, thickness: float = 0.8, batch: int = 1024,
                       device: str | torch.device = "cuda") -> np.ndarray:
    """``base`` (kept verbatim at the front) and ``n - len(base)`` random
    morphs of its digits (``_morph_digits``): the JAX package's
    ``morphed_digit_bank``, with its ``jax.random`` stream. From
    ``key(seed)``, each chunk splits the key in three (the next key, the
    digit indices, the morphs), draws ``batch`` indices and ``batch`` morph
    keys even for a last partial chunk, and keeps the chunk's first ones.
    The morphs render on ``device``."""
    base = np.asarray(base, np.float32)
    if n <= len(base):
        return base[:n]
    n_new = n - len(base)
    key = jax_random.key(seed)
    base_dev = torch.from_numpy(base).to(device)
    kw = dict(rotate_deg=rotate_deg, scale_range=scale_range, shear=shear, elastic_px=elastic_px,
              elastic_cells=elastic_cells, thickness=thickness)
    chunks = [base]
    done = 0
    while done < n_new:
        take = min(batch, n_new - done)
        key, k_idx, k_morph = jax_random.split(key, 3)
        idx = jax_random.randint(k_idx, (batch,), 0, len(base))[:take]
        draws = {k: v[:take] for k, v in _morph_draws(jax_random.split(k_morph, batch), **kw).items()}
        out = _morph_digits(base_dev[torch.from_numpy(idx.astype(np.int64)).to(base_dev.device)], draws,
                            elastic_px=elastic_px)
        chunks.append(out.cpu().numpy())
        done += take
    return np.concatenate(chunks, axis=0)


def _augment(img: torch.Tensor, flips: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Per-sample vertical/horizontal flip (``flips`` ``(B, 2)``) and
    ``jnp.roll`` by ``shifts`` ``(B, 2)`` of ``(B, S, S)`` images: a
    zero-filled translate, since the digit sits in a zero margin at least
    the largest shift wide."""
    b, s = img.shape[0], img.shape[-1]
    img = torch.where(flips[:, 0].reshape(b, 1, 1), img.flip(-2), img)
    img = torch.where(flips[:, 1].reshape(b, 1, 1), img.flip(-1), img)
    ar = torch.arange(s, device=img.device)
    iy = (ar[None, :] - shifts[:, 0:1]) % s                      # out[y] = in[y - shift]
    ix = (ar[None, :] - shifts[:, 1:2]) % s
    img = img.gather(1, iy[:, :, None].expand(b, s, s))
    return img.gather(2, ix[:, None, :].expand(b, s, s))


def _warps(data: DataConfig) -> bool:
    return bool(data.rotate_deg or data.elastic_px)


def draw_batch(generator: torch.Generator, n_bank: int, data: DataConfig) -> Dict[str, torch.Tensor]:
    """The host draws of one batch from ``generator``, CPU tensors (the first
    axis of the pairs: 0 style, 1 content): ``idx`` ``(2, B)``, ``flips``
    ``(2, B, 2)`` bool, ``shifts`` ``(2, B, 2)``, ``pscale``/``pgamma``
    ``(2, B)``, ``d_idx`` ``(2, B)`` into the style/content distance lists,
    and with the warp on ``angle`` ``(2, B)`` in degrees and, with
    ``elastic_px``, ``flow`` ``(2, B, 2, cells, cells)``."""
    b = data.batch_size
    max_shift = int(round(data.translate_frac * data.image_size))

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    d_idx = torch.stack([
        torch.randint(0, len(data.style_distances), (b,), generator=generator),
        torch.randint(0, len(data.content_distances), (b,), generator=generator),
    ])
    draws = {
        "idx": torch.randint(0, n_bank, (2, b), generator=generator),
        "flips": torch.rand((2, b, 2), generator=generator) < 0.5,
        "shifts": torch.randint(-max_shift, max_shift + 1, (2, b, 2), generator=generator),
        "pscale": uniform((2, b), *data.phase_scale_range),
        "pgamma": uniform((2, b), *data.gamma_range),
        "d_idx": d_idx,
    }
    if _warps(data):
        draws["angle"] = uniform((2, b), -data.rotate_deg, data.rotate_deg)
        if data.elastic_px:
            c = data.elastic_cells
            draws["flow"] = torch.randn((2, b, 2, c, c), generator=generator)
    return draws


def jax_key_draws(key: np.ndarray, n_bank: int, data: DataConfig) -> Dict[str, torch.Tensor]:
    """The draws of the JAX package's ``synth_batch(key, ...)``, as the dict
    ``draw_batch`` returns: ``key`` (``jax_random.key`` data) split in 8,
    sub-keys 0 and 1 the style and content digit indices, 2 the flips, 3 the
    shifts, 4 and 5 the style and content distance indices, 6 the phase
    scale and 7 the gamma. With the warp on, ``fold_in(key, 0x5A17)`` split
    in two (style, content), each split into one key a sample, each of those
    split into the rotation's key (a ``uniform`` angle) and the flow's (a
    ``normal`` ``(2, cells, cells)``), as the JAX ``_shape_warp`` draws
    them."""
    b = data.batch_size
    max_shift = int(round(data.translate_frac * data.image_size))
    ks = jax_random.split(key, 8)
    lo_s, hi_s = data.phase_scale_range
    lo_g, hi_g = data.gamma_range

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    draws = {
        "idx": t(np.stack([jax_random.randint(ks[0], (b,), 0, n_bank),
                           jax_random.randint(ks[1], (b,), 0, n_bank)]).astype(np.int64)),
        "flips": t(jax_random.bernoulli(ks[2], 0.5, (2, b, 2))),
        "shifts": t(jax_random.randint(ks[3], (2, b, 2), -max_shift, max_shift + 1).astype(np.int64)),
        "pscale": t(jax_random.uniform(ks[6], (2, b), lo_s, hi_s)),
        "pgamma": t(jax_random.uniform(ks[7], (2, b), lo_g, hi_g)),
        "d_idx": t(np.stack([
            jax_random.randint(ks[4], (b,), 0, len(data.style_distances)),
            jax_random.randint(ks[5], (b,), 0, len(data.content_distances)),
        ]).astype(np.int64)),
    }
    if _warps(data):
        pair = jax_random.split(jax_random.fold_in(key, 0x5A17), 2)      # style, content
        rot_flow = jax_random.split(jax_random.split(pair, b), 2)         # (2, B, 2, 2)
        draws["angle"] = t(jax_random.uniform(rot_flow[:, :, 0], (), -data.rotate_deg, data.rotate_deg))
        if data.elastic_px:
            c = data.elastic_cells
            draws["flow"] = t(jax_random.normal(rot_flow[:, :, 1], (2, c, c)))
    return draws


def render_batch(bank: torch.Tensor, draws: Dict[str, torch.Tensor], data: DataConfig,
                 physics: PhysicsConfig, *, return_gt: bool = False) -> Dict[str, torch.Tensor]:
    """One batch of (style, content) hologram pairs from ``draws``, on
    ``bank``'s device. NCHW: ``style_holo``/``content_holo`` sqrt-intensity
    ``(B, 1, S, S)``, ``distance_style``/``distance_content`` ``(B, 1, 1, 1)``
    in network units; with ``return_gt`` also ``amplitude``,
    ``phase_style`` and ``phase_content``."""
    dev = bank.device
    d = {k: v.to(dev) for k, v in draws.items()}
    b = d["idx"].shape[1]
    size, pad = data.image_size, data.digit_pad

    def units(values, idx):
        mm = torch.tensor(tuple(values), dtype=torch.float32, device=dev)[idx]
        return physics.to_network_units(mm).reshape(b, 1, 1, 1)

    d_style = units(data.style_distances, d["d_idx"][0])
    d_content = units(data.content_distances, d["d_idx"][1])

    flips = d["flips"] if data.flip else torch.zeros_like(d["flips"])
    phases = []
    for i in range(2):
        digits = torch.pow(bank[d["idx"][i]].clamp(0.0, 1.0), d["pgamma"][i].reshape(b, 1, 1))
        digits = digits * d["pscale"][i].reshape(b, 1, 1)
        pad_rem = pad
        if _warps(data):
            m = min(8, pad)          # warp the digit tile plus a margin, not the canvas
            pad_rem = pad - m
            flow = d["flow"][i] if data.elastic_px else None
            digits = _shape_warp(torch.nn.functional.pad(digits, (m, m, m, m)), d["angle"][i],
                                 flow, data.elastic_px)
        canvas = torch.nn.functional.pad(digits, (pad_rem,) * 4)
        phases.append(_augment(canvas, flips[i], d["shifts"][i])[:, None])
    phase_s, phase_c = phases
    amplitude = torch.full((b, 1, size, size), data.amplitude, dtype=torch.float32, device=dev)
    with torch.no_grad():
        style_holo = holo_forward(amplitude, phase_s, d_style, physics)
        content_holo = holo_forward(amplitude, phase_c, d_content, physics)
    out = {
        "style_holo": torch.sqrt(style_holo),
        "content_holo": torch.sqrt(content_holo),
        "distance_style": d_style,
        "distance_content": d_content,
    }
    if return_gt:
        out.update(amplitude=amplitude, phase_style=phase_s, phase_content=phase_c)
    return out


def stream_generator(seed: int, iteration: int) -> torch.Generator:
    """The host generator of batch ``iteration`` of the stream seeded
    ``seed``."""
    state = np.random.SeedSequence([seed, iteration]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & 0x7FFF_FFFF_FFFF_FFFF)


def synth_batch(iteration: int, bank: torch.Tensor, data: DataConfig, physics: PhysicsConfig,
                *, return_gt: bool = False) -> Dict[str, torch.Tensor]:
    """Batch ``iteration`` of the stream seeded ``data.seed``."""
    draws = draw_batch(stream_generator(data.seed, iteration), bank.shape[0], data)
    return render_batch(bank, draws, data, physics, return_gt=return_gt)


def synth_batch_from_key(key: np.ndarray, bank: torch.Tensor, data: DataConfig,
                         physics: PhysicsConfig, *, return_gt: bool = False) -> Dict[str, torch.Tensor]:
    """The JAX package's ``synth_batch(key, bank, ...)``: its ``jax.random``
    draws (``jax_key_draws``) rendered on ``bank``'s device."""
    return render_batch(bank, jax_key_draws(key, bank.shape[0], data), data, physics,
                        return_gt=return_gt)


def synth_interpolation_batch(key: np.ndarray, bank: torch.Tensor, *, data: DataConfig,
                              physics: PhysicsConfig) -> Dict[str, torch.Tensor]:
    """Distance-interpolation sweep: one content object at every style
    distance (the JAX package's ``synth_interpolation_batch``, the
    reference's ``test_interpolation`` mode), on ``bank``'s device.

    ``key`` (``jax_random.key`` data) split in 3: sub-key 0 draws the digit,
    1 the content distance, as ``jax.random`` draws them. The batch axis
    enumerates ``data.style_distances``: ``B`` of them. Returns
    ``synth_batch``'s keys (sqrt-intensity holograms, distances in network
    units ``(B, 1, 1, 1)``) plus ``amplitude`` and ``phase_content``; the
    holograms are ``holo_forward`` with per-sample distances, on a CUDA
    tensor the ``asm_dynamic`` kernel."""
    dev = bank.device
    size, pad = data.image_size, data.digit_pad
    ks = jax_random.split(key, 3)
    idx = int(jax_random.randint(ks[0], (), 0, bank.shape[0]))
    d_c = torch.tensor(data.content_distances, dtype=torch.float32, device=dev)[
        int(jax_random.randint(ks[1], (), 0, len(data.content_distances)))]
    b = len(data.style_distances)
    d_style = physics.to_network_units(
        torch.tensor(data.style_distances, dtype=torch.float32, device=dev)).reshape(b, 1, 1, 1)
    d_content = physics.to_network_units(d_c).expand(b, 1, 1, 1)
    digit = bank[idx].clamp(0.0, 1.0)
    phase = torch.nn.functional.pad(digit, (pad, pad, pad, pad)).expand(b, 1, size, size)
    amplitude = torch.full((b, 1, size, size), data.amplitude, dtype=torch.float32, device=dev)
    with torch.no_grad():
        style_holo = holo_forward(amplitude, phase, d_style, physics)
        content_holo = holo_forward(amplitude, phase, d_content, physics)
    return {
        "style_holo": torch.sqrt(style_holo),
        "content_holo": torch.sqrt(content_holo),
        "distance_style": d_style,
        "distance_content": d_content,
        "amplitude": amplitude,
        "phase_content": phase,
    }


class InfiniteHologramSampler:
    """Endless reproducible batch stream: batch N comes from the generator
    of ``(data.seed, N)``, the same across runs, devices and resumes.

    With ``rows`` (a rank's share of the batch on a mesh,
    ``parallel.local_rows``) the whole batch's draws are taken on the host
    and only those rows are rendered, in that order: the rank's rows of the
    one-process batch."""

    def __init__(self, bank, data: DataConfig, physics: PhysicsConfig, *,
                 return_gt: bool = False, start_iteration: int = 0,
                 device: str | torch.device = "cuda", rows: Optional[np.ndarray] = None):
        self.bank = torch.as_tensor(np.asarray(bank, np.float32), device=device)
        self.data = data
        self.physics = physics
        self.return_gt = return_gt
        self.iteration = start_iteration
        self.rows = None if rows is None else torch.as_tensor(np.asarray(rows), dtype=torch.int64)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        draws = draw_batch(stream_generator(self.data.seed, self.iteration), self.bank.shape[0],
                           self.data)
        if self.rows is not None:
            draws = {k: v[:, self.rows] for k, v in draws.items()}
        batch = render_batch(self.bank, draws, self.data, self.physics, return_gt=self.return_gt)
        self.iteration += 1
        return batch


def load_digit_bank(path: str, size: int = 64) -> np.ndarray:
    """An offline digit bank from an ``.npz``: ``bank`` (N, H, W) in [0, 1],
    or an MNIST export under ``x_train``/``train_images``/``images``/
    ``arr_0`` (uint8 scaled to [0, 1]), cubic-resized to ``size``."""
    with np.load(path) as z:
        keys = ("bank", "x_train", "train_images", "images", "arr_0")
        key = next((k for k in keys if k in z.files), None)
        if key is None:
            raise ValueError(f"{path}: no digit array found (expected one of {keys}; got {z.files})")
        arr = np.asarray(z[key])
    if arr.ndim == 4 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim != 3:
        raise ValueError(f"{path}[{key}]: expected (N, H, W), got {arr.shape}")
    arr = arr.astype(np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    if arr.shape[1:] != (size, size):
        arr = resize_cubic(torch.from_numpy(arr), size, size).numpy()
    return np.clip(arr, 0.0, 1.0)


def sklearn_digit_bank(size: int = 64) -> np.ndarray:
    """(1797, size, size) digits in [0, 1] from sklearn's 8x8 ``load_digits``,
    cubic-resized. Raises where ``sklearn`` is not installed."""
    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        raise ImportError(
            "the sklearn digit bank needs scikit-learn, which is not installed; "
            "use --bank golden or --digit-bank FILE.npz"
        ) from e
    imgs = load_digits().images.astype(np.float32) / 16.0
    return np.clip(resize_cubic(torch.from_numpy(imgs), size, size).numpy(), 0.0, 1.0)


def golden_digit_bank(goldens, size: int = 64, subset: Optional[slice] = None) -> np.ndarray:
    """The golden suite's GT phases (100 digits at 128x128) centre-cropped to
    their 64x64 active area; ``subset`` selects digits (``GOLDEN_TRAIN_DIGITS``
    keeps the held-out half out of training)."""
    ph = goldens.gt_phase.reshape((-1,) + goldens.gt_phase.shape[2:])[:, 0]
    if subset is not None:
        ph = ph[subset]
    crop = np.ascontiguousarray(ph[:, 32:96, 32:96], dtype=np.float32)
    if size != 64:
        crop = resize_cubic(torch.from_numpy(crop), size, size).numpy()
    return np.clip(crop, 0.0, 1.0).astype(np.float32)


def mixed_digit_bank(goldens, *, oversample: int = 36, size: int = 64) -> np.ndarray:
    """sklearn digits + the golden train-split digits oversampled to about
    half the stream (``cli train --bank mixed``). Needs ``sklearn``."""
    golden = golden_digit_bank(goldens, size=size, subset=GOLDEN_TRAIN_DIGITS)
    return np.concatenate([sklearn_digit_bank(size), np.tile(golden, (oversample, 1, 1))], axis=0)


def bead_bank(n: int = 512, size: int = 64, *, radius_range=(0.12, 0.3), phase_peak: float = 1.0,
              seed: int = 0) -> np.ndarray:
    """Synthetic polystyrene-bead phase objects: 1-3 spherical caps a field,
    ``peak * sqrt(1 - (r/R)^2)``, from numpy's ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1) - 0.5
    out = np.zeros((n, size, size), np.float32)
    for i in range(n):
        for _ in range(rng.integers(1, 4)):
            r = rng.uniform(*radius_range)
            cy, cx = rng.uniform(-0.3, 0.3, 2)
            rho2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / (r * r)
            cap = np.sqrt(np.clip(1.0 - rho2, 0.0, 1.0))
            out[i] = np.maximum(out[i], phase_peak * cap)
    return out


def rbc_bank(n: int = 512, size: int = 64, *, radius_range=(0.15, 0.28), seed: int = 0) -> np.ndarray:
    """Synthetic red-blood-cell phase objects: 1-4 biconcave discs a field,
    the Evans-Fung thickness ``sqrt(1 - (r/R)^2) (c0 + c2 (r/R)^2 + c4
    (r/R)^4)``, each field scaled to a peak of 1; numpy's
    ``default_rng(seed)``."""
    c0, c2, c4 = 0.21, 2.0, -1.13
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1) - 0.5
    out = np.zeros((n, size, size), np.float32)
    for i in range(n):
        for _ in range(rng.integers(1, 5)):
            r = rng.uniform(*radius_range)
            cy, cx = rng.uniform(-0.32, 0.32, 2)
            rho2 = np.clip(((yy - cy) ** 2 + (xx - cx) ** 2) / (r * r), 0.0, 1.0)
            t = np.sqrt(1.0 - rho2) * (c0 + c2 * rho2 + c4 * rho2 * rho2)
            out[i] = np.maximum(out[i], np.clip(t, 0.0, None))
    peak = out.reshape(n, -1).max(axis=1, keepdims=True)
    return (out.reshape(n, -1) / np.maximum(peak, 1e-6)).reshape(n, size, size)
