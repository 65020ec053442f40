"""Evaluate a JAX release with the PyTorch port on the golden suite (CPU).

Restores the release with orbax (the one step that needs the JAX stack),
hands the numpy tree to the port's converter, and runs the port's
``evaluate_golden_suite`` on the CPU over the whole 20 x 5 suite. Prints one
JSON line: the port's metrics beside the release's recorded values.

    JAX_PLATFORMS=cpu python scripts/port_golden_eval.py \
        [--release checkpoints/release] [--style checkpoints/style_vector.npz] \
        [--config checkpoints/config.json] [--recorded checkpoints/golden_metrics.json]

``--quant`` evaluates the int8 serving path in bf16 with the scales of
``--scales`` (default ``checkpoints/quant_scales.json``), against
``checkpoints/quant_golden_metrics.json`` unless ``--recorded`` is given;
``--fused-stacks on|off`` sets the fused head and tail (default off, the
mode the recorded int8 metrics were taken in). ``--jax`` also runs the JAX
package's own evaluation of the same release, path and mode, and prints its
metrics beside the port's (minutes on the CPU).

``--refine-steps N`` refines every batch's phase against its hologram
(``physics_refine``, N Adam steps, phase only at the known amplitude) in
both evaluations; ``--refine-distance`` refines the distances too. The
release's recorded ``refined_*`` metrics are then the ones compared.

``--bf16`` runs the fp net in bf16 (the JAX package's
``StyleTransferNet(dtype=bfloat16)``, which ``cli serve`` serves by default),
in both evaluations; the physics stays fp32. ``--write-record PATH`` (with
``--jax``) writes the JAX package's metrics of that run as a JSON record with
a ``note`` on how it was made: ``checkpoints/fast/bf16_golden_metrics.json``
is one.

``--export-npz PATH`` writes the release's weights for the port and exits:
the port's state dict (``convert_params`` of the orbax restore) as fp32
arrays, one per state-dict key, with ``numpy.savez_compressed``. The port
reads it with ``interop.load_release_weights`` where orbax cannot run.
``checkpoints/fast/torch_weights.npz`` was written by

    JAX_PLATFORMS=cpu python scripts/port_golden_eval.py \
        --release checkpoints/fast/release --export-npz checkpoints/fast/torch_weights.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("mean_psnr", "heldout_mean_psnr", "mean_mae", "r2", "heldout_r2",
        "distance_max_abs_err_um")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--release", default="checkpoints/release")
    ap.add_argument("--style", default="checkpoints/style_vector.npz")
    ap.add_argument("--config", default="checkpoints/config.json")
    ap.add_argument("--recorded", default=None)
    ap.add_argument("--quant", action="store_true", help="the int8 serving path, bf16")
    ap.add_argument("--scales", default="checkpoints/quant_scales.json")
    ap.add_argument("--fused-stacks", choices=("on", "off"), default="off")
    ap.add_argument("--jax", action="store_true", help="also run the JAX package's evaluation")
    ap.add_argument("--refine-steps", type=int, default=0, help="physics refinement steps (0: off)")
    ap.add_argument("--refine-distance", action="store_true", help="refine the distances too")
    ap.add_argument("--bf16", action="store_true", help="the fp net in bf16")
    ap.add_argument("--write-record", default=None, metavar="PATH",
                    help="write the JAX package's metrics as a record (needs --jax)")
    ap.add_argument("--export-npz", default=None, metavar="PATH",
                    help="write the port's state dict of the release and exit")
    args = ap.parse_args()
    if args.write_record and not args.jax:
        ap.error("--write-record writes the JAX package's metrics: add --jax")
    if args.bf16 and args.quant:
        ap.error("--bf16 is the fp net in bf16; the int8 path (--quant) runs bf16 already")
    sys.path.insert(0, REPO)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import orbax.checkpoint as ocp
    import torch

    from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig
    from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
    from style_transfer_based_holographic_imaging_tpu_torch.interop import (
        convert_params,
        load_style_vector,
    )
    from style_transfer_based_holographic_imaging_tpu_torch.models import (
        StyleTransferNet,
        has_phase_decoder,
        quant,
    )
    from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (
        evaluate_golden_suite,
    )

    path = lambda p: os.path.join(REPO, p)  # noqa: E731
    recorded = args.recorded or (
        "checkpoints/quant_golden_metrics.json" if args.quant else "checkpoints/golden_metrics.json"
    )
    params = ocp.StandardCheckpointer().restore(path(args.release))["params"]
    if args.export_npz:
        import numpy as np

        state = convert_params(params)
        np.savez_compressed(path(args.export_npz), **{k: v.numpy() for k, v in state.items()})
        print(json.dumps({"release": args.release, "npz": args.export_npz, "arrays": len(state),
                          "parameters": sum(v.numel() for v in state.values()),
                          "bytes": os.path.getsize(path(args.export_npz))}))
        return 0
    with open(path(args.config)) as f:
        config_text = f.read()
    cfg = ExperimentConfig.from_json(config_text)
    net = StyleTransferNet(width=cfg.model.width, with_phase_decoder=has_phase_decoder(params))
    net.load_state_dict(convert_params(params), strict=True)
    net.eval()
    style = load_style_vector(path(args.style))
    scales = quant.load_scales(path(args.scales)) if args.quant else None
    quant.set_fused_stacks(args.fused_stacks)

    refine = dict(refine_steps=args.refine_steps, refine_distance=args.refine_distance)
    t0 = time.perf_counter()
    got = evaluate_golden_suite(
        net, load_golden_suite(), cfg, style_override=style, quant_scales=scales,
        dtype=torch.bfloat16 if args.quant or args.bf16 else None, device="cpu", **refine,
    )
    seconds = time.perf_counter() - t0
    with open(path(recorded)) as f:
        rec = json.load(f)
    # Refined runs are compared with the record's refined_* keys (the
    # record keeps no refined per-batch PSNR).
    rec_key = (lambda k: f"refined_{k}") if args.refine_steps else (lambda k: k)  # noqa: E731
    out = {
        "release": args.release, "device": "cpu", "eval_seconds": round(seconds, 3),
        "path": "int8 bf16" if args.quant else ("fp bf16" if args.bf16 else "fp32"),
        "fused_stacks": args.fused_stacks if args.quant else None,
        **refine,
        "port": {k: got[k] for k in KEYS},
        "recorded": {k: rec.get(rec_key(k)) for k in KEYS},
        "recorded_refined_steps": rec.get("refined_steps"),
        "recorded_file": recorded,
        "distance_outlier_batches": got["distance_outlier_batches"],
    }
    if "psnr_per_batch" in rec and not args.refine_steps:
        out["max_abs_psnr_per_batch_diff_db"] = max(
            abs(a - b) for a, b in zip(got["psnr_per_batch"], rec["psnr_per_batch"])
        )
    if args.jax:
        import jax.numpy as jnp

        from style_transfer_based_holographic_imaging_tpu.config import ExperimentConfig as JConfig
        from style_transfer_based_holographic_imaging_tpu.data import load_golden_suite as j_goldens
        from style_transfer_based_holographic_imaging_tpu.models import quant as jquant
        from style_transfer_based_holographic_imaging_tpu.pipelines import field_retrieval as jfr

        jquant.set_fused_stacks(args.fused_stacks)
        t0 = time.perf_counter()
        ref = jfr.evaluate_golden_suite(
            params, j_goldens(), JConfig.from_json(config_text),
            style_override=(jnp.asarray(style[0]), jnp.asarray(style[1])),
            quant_scales=scales, dtype=jnp.bfloat16 if args.bf16 else None, **refine,
        )
        out["jax"] = {k: float(ref[k]) for k in KEYS}
        out["jax_eval_seconds"] = round(time.perf_counter() - t0, 3)
        out["max_abs_psnr_per_batch_diff_vs_jax_db"] = max(
            abs(a - b) for a, b in zip(got["psnr_per_batch"], ref["psnr_per_batch"])
        )
        if args.write_record:
            what = "the int8 path in bf16" if args.quant else (
                "the fp net in bf16 (StyleTransferNet(dtype=bfloat16))" if args.bf16 else "fp32")
            record = {
                **{k: ref[k] for k in ref},
                "note": (
                    f"JAX package's evaluate_golden_suite of {args.release}, {what}, physics fp32, "
                    f"on the CPU, fused stacks {args.fused_stacks}, refine_steps {args.refine_steps}; "
                    "written by scripts/port_golden_eval.py --write-record"
                ),
            }
            with open(path(args.write_record), "w") as f:
                json.dump(record, f, indent=1)
            out["record_written"] = args.write_record
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
