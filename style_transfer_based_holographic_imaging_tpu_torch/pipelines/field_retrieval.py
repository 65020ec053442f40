"""End-to-end field retrieval: hologram in, focused complex object out.

Port of the JAX package's ``pipelines/field_retrieval.py``, run eagerly:

    sqrt(holo) -> VGG encode -> AdaIN(style vector) -> decode (A_t, phi_t)
    -> distance head -> ASM refocus by -d_style -> DCT phase unwrap

The public layout is the JAX package's: NCHW ``(B, 1, H, W)`` intensity
holograms and ``(1, 1, 1, C)`` style statistics in, the same output dict out.

A style distance that is a host scalar, or an array whose entries are all
equal, is hoisted to a Python float: the refocus then takes the
constant-transfer-function kernel (``asm_const``). A genuinely per-sample
distance takes the per-image kernel (``asm_dynamic``).

``evaluate_golden_suite(refine_steps=n)`` polishes each batch's refocused
phase against its hologram with ``pipelines.refine.physics_refine``
(phase only, at the known amplitude ``config.data.amplitude``).

``dtype`` is the net's compute dtype: the fp net's (fp32 when None; bf16
is what ``cli serve`` serves by default), or, with ``quant_scales`` (from
``models.quant.calibrate_scales``), that of the int8 serving path
(``models/quant.py``; bf16 when None). The physics stays fp32 and every
output is fp32 either way.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import (
    ExperimentConfig,
    PhysicsConfig,
)
from style_transfer_based_holographic_imaging_tpu_torch.data.goldens import (
    GOLDEN_HELDOUT_BATCHES,
)
from style_transfer_based_holographic_imaging_tpu_torch.eval import metrics as metrics_mod
from style_transfer_based_holographic_imaging_tpu_torch.models.net import (
    StyleTransferNet,
    style_stats_nchw,
)
from style_transfer_based_holographic_imaging_tpu_torch.models.quant import quant_retrieval_forward
from style_transfer_based_holographic_imaging_tpu_torch.ops.holo import holo_forward
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.refine import physics_refine
from style_transfer_based_holographic_imaging_tpu_torch.utils.misc import static_scalar

__all__ = ["retrieval_step", "make_retrieval_fn", "retrieval_replicas", "evaluate_golden_suite"]


def _check_device(net: StyleTransferNet, device: torch.device) -> None:
    p = next(net.parameters())
    if p.device.type != device.type or (
        device.index is not None and p.device.index != device.index
    ):
        raise ValueError(f"the net lies on {p.device}, the call asks for {device}")


@torch.inference_mode()
def retrieval_step(
    net: StyleTransferNet,
    content_holo,
    style_mean,
    style_std,
    distance_style,
    physics: PhysicsConfig,
    *,
    alpha: float = 1.0,
    unknown_distance: bool = True,
    unwrap: bool = True,
    dtype: Optional[torch.dtype] = None,
    quant_scales: Optional[Dict[str, float]] = None,
    asm_backend: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> Dict[str, torch.Tensor]:
    """One retrieval step on an NCHW intensity-hologram batch.

    Returns the style-plane field (``amp_field``, ``ph_field``), the field
    refocused to the object plane (``amp_foc``, ``ph_foc``) and, with
    ``unknown_distance``, the predicted content distance (``distance_pred``,
    ``(B, 1, 1, 1)``), all fp32 on ``device``. ``dtype`` is the fp net's
    compute dtype (fp32 when None); ``quant_scales`` runs the net on the
    int8 path in ``dtype`` instead (bf16 when None).
    """
    device = torch.device(device)
    _check_device(net, device)
    f32 = dict(dtype=torch.float32, device=device)
    content = torch.sqrt(torch.as_tensor(content_holo, **f32))
    sm = style_stats_nchw(torch.as_tensor(style_mean, **f32))
    ss = style_stats_nchw(torch.as_tensor(style_std, **f32))

    if quant_scales is not None:
        out = quant_retrieval_forward(
            net, content, sm, ss, alpha, scales=quant_scales,
            compute_dtype=dtype or torch.bfloat16, unknown_distance=unknown_distance,
        )
    else:
        out = net.field_retrieval(
            content, sm, ss, alpha, unknown_distance=unknown_distance,
            dtype=dtype or torch.float32)
    if unknown_distance:
        amp, ph, d_pred = out
    else:
        (amp, ph), d_pred = out, None

    # Refocus to the object plane by -d_style (with the reference's
    # -2 * distance_normalize_constant term). A host-scalar style distance
    # stays a Python float, its fp32 roundings mirrored with numpy.
    d_static = static_scalar(distance_style)
    if d_static is not None:
        refocus_d = float(
            -np.float32(d_static) - np.float32(2.0 * physics.distance_normalize_constant)
        )
    else:
        refocus_d = (
            -torch.as_tensor(distance_style, **f32) - 2.0 * physics.distance_normalize_constant
        )
    amp_foc, ph_foc = holo_forward(
        amp,
        ph * float(np.float32(physics.phase_normalize)),
        refocus_d,
        physics,
        return_field=True,
        unwrap=unwrap,
        asm_backend=asm_backend,
    )
    result = {"amp_field": amp.float(), "ph_field": ph.float(), "amp_foc": amp_foc, "ph_foc": ph_foc}
    if d_pred is not None:
        result["distance_pred"] = d_pred.reshape(-1, 1, 1, 1).float()
    return result


def _hoist_scalar(distance_style) -> Optional[float]:
    """A Python float if ``distance_style`` is a host scalar or an array with
    all entries equal, else None (per-sample distances stay tensors)."""
    s = static_scalar(distance_style)
    if s is not None:
        return s
    arr = None
    if isinstance(distance_style, np.ndarray):
        arr = distance_style
    elif isinstance(distance_style, torch.Tensor) and distance_style.numel() <= 4096:
        arr = distance_style.detach().cpu().numpy()
    if arr is not None and arr.size >= 1 and (arr == arr.flat[0]).all():
        return float(arr.flat[0])
    return None


def make_retrieval_fn(
    physics: PhysicsConfig,
    *,
    alpha: float = 1.0,
    unknown_distance: bool = True,
    unwrap: bool = True,
    dtype: Optional[torch.dtype] = None,
    quant_scales: Optional[Dict[str, float]] = None,
    asm_backend: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``call(net, holo, style_mean, style_std, distance_style)`` over the
    fixed config. Scalar and all-equal style distances are hoisted to a host
    float (the ``asm_const`` route); per-sample ones stay per-sample."""

    def call(net, content_holo, style_mean, style_std, distance_style):
        d = _hoist_scalar(distance_style)
        return retrieval_step(
            net,
            content_holo,
            style_mean,
            style_std,
            distance_style if d is None else d,
            physics,
            alpha=alpha,
            unknown_distance=unknown_distance,
            unwrap=unwrap,
            dtype=dtype,
            quant_scales=quant_scales,
            asm_backend=asm_backend,
            device=device,
        )

    return call


def retrieval_replicas(net: StyleTransferNet, style_vector, physics: PhysicsConfig, devices,
                       **fn_kw) -> Dict[torch.device, Tuple]:
    """``{device: (net, style mean, style std, make_retrieval_fn(...))}`` on
    each of ``devices`` (a mesh's ``data`` positions; a device named twice
    gets one replica): ``net`` itself on the first, a copy elsewhere, the
    style statistics fp32. ``fn_kw`` goes to ``make_retrieval_fn``."""
    out: Dict[torch.device, Tuple] = {}
    for dev in devices:
        if dev in out:
            continue
        f32 = dict(dtype=torch.float32, device=dev)
        out[dev] = (net if not out else copy.deepcopy(net).to(dev),
                    style_stats_nchw(torch.as_tensor(np.asarray(style_vector[0]), **f32)),
                    style_stats_nchw(torch.as_tensor(np.asarray(style_vector[1]), **f32)),
                    make_retrieval_fn(physics, device=dev, **fn_kw))
    return out


def evaluate_golden_suite(
    net: Optional[StyleTransferNet],
    goldens,
    config: Optional[ExperimentConfig] = None,
    *,
    save_dir: Optional[str] = None,
    style_override: Optional[Tuple[Any, Any]] = None,
    dtype: Optional[torch.dtype] = None,
    quant_scales: Optional[Dict[str, float]] = None,
    refine_steps: int = 0,
    refine_distance: bool = False,
    retrieval_fn: Optional[Callable[..., Dict[str, Any]]] = None,
    device: str | torch.device = "cuda",
) -> Dict[str, Any]:
    """Run the 20 x 5 golden suite and return the reference's metrics.

    Per-batch PSNR/MAE of the focused phase against the GT phase (both
    zero-meaned), the (true, predicted) distances in µm, their R², the
    batches whose worst distance misses by more than 25 µm, and the same
    metrics over the held-out batches. Metrics stay on the device until the
    end of the loop. ``dtype`` and ``quant_scales`` are ``retrieval_step``'s:
    the fp net in ``dtype`` (fp32 when None), or the int8 path in ``dtype``
    (bf16 when None).

    ``refine_steps > 0`` refines each batch's focused phase against its
    hologram (``physics_refine``, phase only at the known amplitude
    ``config.data.amplitude``, from the network's ``ph_foc`` and
    ``distance_pred``); with ``refine_distance`` the distance too, and the
    refined distances are the ones reported. 0 keeps the network-only
    inference.

    ``retrieval_fn`` replaces the retrieval with any callable of the same
    ``fn(net, holo, style_mean, style_std, distance_style)`` contract, its
    outputs tensors or host arrays (moved to ``device``): a frozen artifact
    (``pipelines.export_artifact``), so that a release file is scored
    without the model code it was built from; ``net`` may then be None.

    With ``save_dir`` it also writes the reports of ``eval/report.py`` there:
    the per-sample montages, the distance box plot and one ``metrics.jsonl``
    line. The montage planes stay on the device with the metrics and come to
    the host in one go after the loop.
    """
    config = config or ExperimentConfig()
    physics = config.physics
    device = torch.device(device)
    if retrieval_fn is None:
        fn = make_retrieval_fn(
            physics,
            alpha=config.eval.alpha,
            dtype=dtype,
            quant_scales=quant_scales,
            device=device,
        )
    else:
        def fn(*args):
            return {k: torch.as_tensor(v, device=device) for k, v in retrieval_fn(*args).items()}
    if style_override is not None:
        sm, ss = style_override
    else:
        sm, ss = goldens.style_mean, goldens.style_std
    sm = torch.as_tensor(np.asarray(sm), dtype=torch.float32, device=device)
    ss = torch.as_tensor(np.asarray(ss), dtype=torch.float32, device=device)

    psnr_list, mae_list, preds, planes = [], [], [], []
    for i in range(goldens.n_batches):
        holo = torch.as_tensor(goldens.content_holo[i], device=device)
        # Host numpy on purpose: an all-equal style distance is hoisted to
        # a host float without a device round trip.
        out = fn(net, holo, sm, ss, goldens.distance_style[i])
        if refine_steps:
            # The golden suite is a pure-phase domain of known constant
            # amplitude: refine the phase alone against that prior.
            refined = physics_refine(
                torch.full_like(out["amp_foc"], config.data.amplitude),
                out["ph_foc"],
                out["distance_pred"],
                torch.sqrt(holo),
                physics,
                steps=refine_steps,
                optimize_amp=False,
                refine_distance=refine_distance,
                device=device,
            )
            out = dict(out, ph_foc=refined["phase"])
            if refine_distance:
                out["distance_pred"] = refined["distance"]
        gt_phase = metrics_mod.zero_mean(torch.as_tensor(goldens.gt_phase[i], device=device))
        ph_foc = metrics_mod.zero_mean(out["ph_foc"])
        psnr_list.append(metrics_mod.psnr(ph_foc, gt_phase))
        mae_list.append(metrics_mod.mae(ph_foc, gt_phase))
        preds.append(out["distance_pred"].reshape(-1))
        if save_dir is not None:
            planes.append({
                "content": torch.sqrt(holo),
                "amp_field": out["amp_field"],
                "amp_foc": out["amp_foc"],
                "ph_field": metrics_mod.zero_mean(out["ph_field"]),
                "gt_phase": gt_phase,
                "ph_foc": ph_foc,
            })

    psnr_list = torch.stack(psnr_list).cpu().tolist()
    mae_list = torch.stack(mae_list).cpu().tolist()
    d_pred = torch.cat(preds).cpu().numpy()
    d_true = np.asarray(goldens.distance_content).reshape(-1)
    pairs = np.stack([d_true, d_pred], axis=1).astype(np.float64)
    um = metrics_mod.distances_to_um(pairs, physics)
    bs0 = goldens.content_holo[0].shape[0]
    abs_err = np.abs(um[:, 1] - um[:, 0]).reshape(-1, bs0)
    # Batches whose worst sample misses by > 25 µm (~5x the suite's typical
    # error): a distance failure the suite mean would hide.
    outliers = [int(b) for b in np.nonzero(abs_err.max(axis=1) > 25.0)[0]]
    metrics = {
        "mean_psnr": float(np.mean(psnr_list)),
        "mean_mae": float(np.mean(mae_list)),
        "r2": float(metrics_mod.r2_score(um[:, 0], um[:, 1])),
        "psnr_per_batch": psnr_list,
        "mae_per_batch": mae_list,
        "distance_true_um": um[:, 0].tolist(),
        "distance_pred_um": um[:, 1].tolist(),
        "distance_outlier_batches": outliers,
        "distance_max_abs_err_um": float(abs_err.max()),
    }
    held = [b for b in GOLDEN_HELDOUT_BATCHES if b < goldens.n_batches]
    if held:
        held_samples = [s for b in held for s in range(b * bs0, (b + 1) * bs0)]
        metrics["heldout_mean_psnr"] = float(np.mean([psnr_list[b] for b in held]))
        metrics["heldout_mean_mae"] = float(np.mean([mae_list[b] for b in held]))
        metrics["heldout_r2"] = float(
            metrics_mod.r2_score(um[held_samples, 0], um[held_samples, 1])
        )

    if save_dir is not None:
        from style_transfer_based_holographic_imaging_tpu_torch.eval import report

        montage_batches = [
            {**{k: v.cpu().numpy() for k, v in p.items()}, "gt_amplitude": goldens.gt_amplitude[i]}
            for i, p in enumerate(planes)
        ]
        report.save_montages(montage_batches, save_dir)
        report.save_distance_boxplot(um[:, 0], um[:, 1], save_dir)
        report.save_metrics_jsonl(metrics, save_dir)
    return metrics
