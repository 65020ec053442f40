"""Evaluate a JAX release with the PyTorch port on the golden suite (CPU).

Restores the release with orbax (the one step that needs the JAX stack),
hands the numpy tree to the port's converter, and runs the port's
``evaluate_golden_suite`` on the CPU over the whole 20 x 5 suite. Prints one
JSON line: the port's metrics beside the release's recorded
``golden_metrics.json`` values.

    JAX_PLATFORMS=cpu python scripts/port_golden_eval.py \
        [--release checkpoints/release] [--style checkpoints/style_vector.npz] \
        [--config checkpoints/config.json] [--recorded checkpoints/golden_metrics.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--release", default="checkpoints/release")
    ap.add_argument("--style", default="checkpoints/style_vector.npz")
    ap.add_argument("--config", default="checkpoints/config.json")
    ap.add_argument("--recorded", default="checkpoints/golden_metrics.json")
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import orbax.checkpoint as ocp

    from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig
    from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
    from style_transfer_based_holographic_imaging_tpu_torch.interop import (
        convert_params,
        load_style_vector,
    )
    from style_transfer_based_holographic_imaging_tpu_torch.models import (
        StyleTransferNet,
        has_phase_decoder,
    )
    from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (
        evaluate_golden_suite,
    )

    path = lambda p: os.path.join(REPO, p)  # noqa: E731
    params = ocp.StandardCheckpointer().restore(path(args.release))["params"]
    with open(path(args.config)) as f:
        cfg = ExperimentConfig.from_json(f.read())
    net = StyleTransferNet(width=cfg.model.width, with_phase_decoder=has_phase_decoder(params))
    net.load_state_dict(convert_params(params), strict=True)
    net.eval()
    style = load_style_vector(path(args.style))

    t0 = time.perf_counter()
    got = evaluate_golden_suite(net, load_golden_suite(), cfg, style_override=style, device="cpu")
    seconds = time.perf_counter() - t0
    with open(path(args.recorded)) as f:
        rec = json.load(f)
    keys = ("mean_psnr", "heldout_mean_psnr", "mean_mae", "r2", "heldout_r2",
            "distance_max_abs_err_um")
    print(json.dumps({
        "release": args.release, "device": "cpu", "eval_seconds": round(seconds, 3),
        "port": {k: got[k] for k in keys},
        "recorded": {k: rec.get(k) for k in keys},
        "max_abs_psnr_per_batch_diff_db": max(
            abs(a - b) for a, b in zip(got["psnr_per_batch"], rec["psnr_per_batch"])
        ),
        "distance_outlier_batches": got["distance_outlier_batches"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
