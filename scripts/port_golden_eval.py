"""Evaluate a JAX release with the PyTorch port on the golden suite (CPU).

Restores the release with orbax (the one step that needs the JAX stack),
hands the numpy tree to the port's converter, and runs the port's
``evaluate_golden_suite`` on the CPU over the whole 20 x 5 suite. Prints one
JSON line: the port's metrics beside the release's recorded values.

    JAX_PLATFORMS=cpu python scripts/port_golden_eval.py \
        [--release checkpoints/release] [--style checkpoints/style_vector.npz] \
        [--config checkpoints/config.json] [--recorded checkpoints/golden_metrics.json]

``--checkpoint DIR`` takes all four (and ``--scales``) from a release
directory such as ``checkpoints/turbo``. ``--batches N`` scores the first N
batches of the suite only.

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
release's recorded ``refined_*`` metrics are then the ones compared, with
``--refine-distance`` its ``refine_distance_*`` ones (``balanced`` and
``turbo`` record them at 240 steps); a record without them stops the script
before it evaluates. ``--threads N`` sets torch's CPU threads, on which a
refine with the distance depends (ROADMAP C.7).

``--save FILE`` merges the port's reading (its means, every batch's PSNR,
every true and predicted distance, torch's version and threads, the
command) into FILE under the release's name (``turbo``; ``flagship`` for
``checkpoints/release``) and ``fp32``, ``int8``, ``refined`` or
``refine_distance``: ``chip_smoke.py``'s ``narrow_releases`` phase holds the
card to ``checkpoints/port_cpu_golden_readings.json`` where the records
cannot be reproduced (``ultra``'s int8 R², ROADMAP C.2) or its time allows
fewer batches than the record's (refine-distance, 3 of 20).

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
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="a release directory: its release/, style vector, config, records and scales")
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
    ap.add_argument("--batches", type=int, default=None, help="the first N batches of the suite")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch's CPU threads (default: torch's own); the refine with the "
                         "distance depends on them (ROADMAP C.7)")
    ap.add_argument("--save", metavar="FILE", default=None,
                    help="merge the port's reading into FILE (see the docstring)")
    ap.add_argument("--write-record", default=None, metavar="PATH",
                    help="write the JAX package's metrics as a record (needs --jax)")
    ap.add_argument("--export-npz", default=None, metavar="PATH",
                    help="write the port's state dict of the release and exit")
    args = ap.parse_args()
    if args.write_record and not args.jax:
        ap.error("--write-record writes the JAX package's metrics: add --jax")
    if args.bf16 and args.quant:
        ap.error("--bf16 is the fp net in bf16; the int8 path (--quant) runs bf16 already")
    if args.refine_distance and not args.refine_steps:
        ap.error("--refine-distance refines during the refine: add --refine-steps N")
    if args.checkpoint:
        d = args.checkpoint.rstrip("/")
        args.release, args.style, args.config = f"{d}/release", f"{d}/style_vector.npz", f"{d}/config.json"
        args.scales = f"{d}/quant_scales.json"
        args.recorded = args.recorded or f"{d}/{'quant_' if args.quant else ''}golden_metrics.json"
    sys.path.insert(0, REPO)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import orbax.checkpoint as ocp
    import torch

    if args.threads:
        torch.set_num_threads(args.threads)

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
    with open(path(recorded)) as f:
        rec = json.load(f)
    # Refined runs are compared with the record's refined_* keys, a refine
    # with the distance with its refine_distance_* keys (neither record
    # keeps per-batch PSNRs).
    prefix = ("refine_distance_" if args.refine_distance else "refined_") if args.refine_steps else ""
    if args.refine_distance and rec.get("refine_distance_mean_psnr") is None:
        ap.exit(2, f"{recorded} records no refine-distance run (no refine_distance_* keys): "
                   "nothing to compare --refine-distance with\n")
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
    goldens = load_golden_suite()
    if args.batches:
        goldens = goldens.subset(args.batches)
    t0 = time.perf_counter()
    got = evaluate_golden_suite(
        net, goldens, cfg, style_override=style, quant_scales=scales,
        dtype=torch.bfloat16 if args.quant or args.bf16 else None, device="cpu", **refine,
    )
    seconds = time.perf_counter() - t0
    out = {
        "release": args.release, "device": "cpu", "eval_seconds": round(seconds, 3),
        "path": "int8 bf16" if args.quant else ("fp bf16" if args.bf16 else "fp32"),
        "fused_stacks": args.fused_stacks if args.quant else None,
        "batches": goldens.n_batches, "threads": torch.get_num_threads(),
        **refine,
        "port": {k: got.get(k) for k in KEYS},
        "recorded": {k: rec.get(prefix + k) for k in KEYS},
        "recorded_steps": rec.get(prefix + "steps") if prefix else None,
        "recorded_file": recorded,
        "distance_outlier_batches": got["distance_outlier_batches"],
    }
    if args.save:
        name = args.release.rstrip("/")
        name = "flagship" if name == "checkpoints/release" else os.path.basename(os.path.dirname(name))
        key = "int8" if args.quant else (prefix.rstrip("_") or "fp32")
        readings = {}
        if os.path.exists(path(args.save)):
            with open(path(args.save)) as f:
                readings = json.load(f)
        readings.setdefault(name, {})[key] = {
            **{k: got[k] for k in ("mean_psnr", "r2", "psnr_per_batch", "distance_true_um", "distance_pred_um")},
            "heldout_mean_psnr": got.get("heldout_mean_psnr"),
            "batches": goldens.n_batches, "refine_steps": args.refine_steps,
            "fused_stacks": args.fused_stacks if args.quant else None,
            "torch": torch.__version__, "threads": torch.get_num_threads(),
            "command": "JAX_PLATFORMS=cpu python scripts/port_golden_eval.py "
                       + " ".join(a for a in sys.argv[1:] if a != "--jax"),
        }
        with open(path(args.save), "w") as f:
            json.dump(readings, f, indent=1, sort_keys=True)
            f.write("\n")
        out["saved"] = f"{args.save}: {name}/{key}"
    if "psnr_per_batch" in rec and not args.refine_steps:
        out["max_abs_psnr_per_batch_diff_db"] = max(
            abs(a - b) for a, b in zip(got["psnr_per_batch"], rec["psnr_per_batch"])
        )
    if "distance_pred_um" in rec and not args.refine_steps:
        out["max_abs_distance_diff_um"] = max(
            abs(a - b) for a, b in zip(got["distance_pred_um"], rec["distance_pred_um"])
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
            params, j_goldens().subset(goldens.n_batches), JConfig.from_json(config_text),
            style_override=(jnp.asarray(style[0]), jnp.asarray(style[1])),
            quant_scales=scales, dtype=jnp.bfloat16 if args.bf16 else None, **refine,
        )
        out["jax"] = {k: float(ref[k]) for k in KEYS if k in ref}
        out["jax_eval_seconds"] = round(time.perf_counter() - t0, 3)
        out["max_abs_psnr_per_batch_diff_vs_jax_db"] = max(
            abs(a - b) for a, b in zip(got["psnr_per_batch"], ref["psnr_per_batch"])
        )
        out["max_abs_distance_diff_vs_jax_um"] = max(
            abs(a - b) for a, b in zip(got["distance_pred_um"], ref["distance_pred_um"])
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
