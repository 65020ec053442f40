"""Feature statistics: AdaIN and friends (port of the JAX ``ops/stats.py``).

The port's conv stack is NCHW, so ``channel_axis`` defaults to 1. Statistics
reduce over the spatial axes per (sample, channel), with the unbiased (N-1)
variance plus eps of the reference.

On bf16 features (the int8 serving path) the roundings sit where XLA puts
them on the JAX package's jitted path: the sums are taken in fp32 and
rounded to bf16, the square that feeds a sum is not rounded, and every other
op rounds to bf16. Style statistics in fp32 promote the
AdaIN output to fp32, as in JAX; there the centred features round to bf16,
and the division by the std and the multiply-add of the style statistics run
in fp32 (one fused multiply-add), as XLA fuses them.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["calc_mean_std", "adain", "adain_with_stats", "coral"]


def _spatial_axes(ndim: int, channel_axis: int) -> Tuple[int, ...]:
    channel_axis = channel_axis % ndim
    return tuple(a for a in range(1, ndim) if a != channel_axis)


def calc_mean_std(
    feat: torch.Tensor, eps: float = 1e-5, *, channel_axis: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel) spatial mean and std, spatial axes kept as size 1."""
    if feat.ndim < 4:
        raise ValueError(
            f"calc_mean_std expects batched (N, C, ...) features with >= 2 "
            f"spatial axes, got shape {tuple(feat.shape)}; add a leading batch axis"
        )
    axes = _spatial_axes(feat.ndim, channel_axis)
    n = 1
    for a in axes:
        n *= feat.shape[a]
    dt = feat.dtype
    mean = feat.float().mean(dim=axes, keepdim=True).to(dt)
    centered = feat - mean
    if dt == torch.float32:
        var = (centered * centered).sum(dim=axes, keepdim=True) / max(n - 1, 1)
        return mean, torch.sqrt(var + eps)
    # Below fp32, XLA's fusion: the square feeds the fp32 sum unrounded, the
    # sum is rounded, then scaled by fp32(1 / (n - 1)); eps is a bf16 constant.
    c = centered.float()
    var = (c * c).sum(dim=axes, keepdim=True).to(dt)
    var = (var.float() * float(torch.tensor(1.0 / max(n - 1, 1), dtype=torch.float32))).to(dt)
    var_eps = (var.float() + float(torch.tensor(eps, dtype=dt))).to(dt)
    return mean, torch.sqrt(var_eps.float()).to(dt)


def adain(
    content_feat: torch.Tensor, style_feat: torch.Tensor, *, channel_axis: int = 1
) -> torch.Tensor:
    """Adaptive instance normalization."""
    style_mean, style_std = calc_mean_std(style_feat, channel_axis=channel_axis)
    content_mean, content_std = calc_mean_std(content_feat, channel_axis=channel_axis)
    return (content_feat - content_mean) / content_std * style_std + style_mean


def adain_with_stats(
    content_feat: torch.Tensor,
    style_mean: torch.Tensor,
    style_std: torch.Tensor,
    *,
    channel_axis: int = 1,
) -> torch.Tensor:
    """AdaIN against precomputed style statistics that broadcast against
    ``content_feat`` (e.g. ``(1, C, 1, 1)``)."""
    content_mean, content_std = calc_mean_std(content_feat, channel_axis=channel_axis)
    if content_feat.dtype == torch.float32:
        normalized = (content_feat - content_mean) / content_std
        return normalized * style_std + style_mean
    out_dtype = torch.promote_types(content_feat.dtype, style_mean.dtype)
    normalized = (content_feat - content_mean).float() / content_std.float()
    return torch.addcmul(style_mean.float(), normalized, style_std.float()).to(out_dtype)


def _flatten_mean_std(feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(C, H, W) -> the flattened features and their per-channel mean and std
    (unbiased, no eps)."""
    c = feat.shape[0]
    flat = feat.reshape(c, -1)
    mean = flat.mean(dim=-1, keepdim=True)
    n = flat.shape[-1]
    var = ((flat - mean) ** 2).sum(dim=-1, keepdim=True) / max(n - 1, 1)
    return flat, mean, torch.sqrt(var)


def _mat_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Symmetric matrix square root through the SVD, ``U sqrt(S) V^T``."""
    u, s, vt = torch.linalg.svd(x)
    return (u * torch.sqrt(s)[None, :]) @ vt


def coral(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """CORAL: whiten the (C, H, W) ``source`` features with their channel
    covariance (plus the identity) and colour them with ``target``'s, then
    restore ``target``'s per-channel std and mean. Off the retrieval path,
    as in the JAX package."""
    c = source.shape[0]
    eye = torch.eye(c, dtype=source.dtype, device=source.device)
    src_f, src_mean, src_std = _flatten_mean_std(source)
    src_norm = (src_f - src_mean) / src_std
    src_cov = src_norm @ src_norm.T + eye
    tgt_f, tgt_mean, tgt_std = _flatten_mean_std(target)
    tgt_norm = (tgt_f - tgt_mean) / tgt_std
    tgt_cov = tgt_norm @ tgt_norm.T + eye
    transfer = _mat_sqrt(tgt_cov) @ (torch.linalg.inv(_mat_sqrt(src_cov)) @ src_norm)
    out = transfer * tgt_std + tgt_mean
    return out.reshape(source.shape)
