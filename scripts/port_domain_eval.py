"""Score an experimental-domain release with the PyTorch port on the CPU.

Restores ``checkpoints/<tag>_release`` with orbax (the one step that needs
the JAX stack; ``bead``'s was saved on a TPU and restores into ``rbc``'s
tree, the same architecture), converts it, and runs the port's
``evaluate_synth_domain`` on the records' protocol: batches of 32 of the
JAX package's ``jax.random`` stream (seed 7777, reproduced in numpy by
``utils/jax_random.py``) over ``bead_bank``/``rbc_bank`` seed 7919. Prints
one JSON line: the port's metrics beside the record's.

    JAX_PLATFORMS=cpu python scripts/port_domain_eval.py --tag rbc|bead \\
        [--batches 10] [--quant] [--refine-steps N [--refine-distance]] [--jax]

``--quant`` runs the int8 serving path in bf16 with
``checkpoints/<tag>_quant_scales.json`` over the int8 record's 3 batches
(``<tag>_quant_domain_metrics.json``), and the fp32 path on the same
batches (its ``fp_same_subset``). ``--refine-steps N`` refines every batch
(phase only, at the known amplitude); the record's ``refined_*`` (or, with
``--refine-distance``, ``refine_distance_*``) keys are then compared.
``--jax`` also runs the JAX package's ``evaluate_synth_domain`` on the same
release, stream and path, and prints its metrics beside the port's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("mean_psnr", "mean_mae", "r2")
DOMAINS = {"rbc": "red_blood_cell", "bead": "polystyrene"}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", choices=sorted(DOMAINS), required=True)
    ap.add_argument("--batches", type=int, default=None,
                    help="batches of 32 (default: the record's count)")
    ap.add_argument("--quant", action="store_true")
    ap.add_argument("--refine-steps", type=int, default=0)
    ap.add_argument("--refine-distance", action="store_true")
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import orbax.checkpoint as ocp
    import torch

    from style_transfer_based_holographic_imaging_tpu_torch.config import DOMAIN_PRESETS
    from style_transfer_based_holographic_imaging_tpu_torch.data import synth
    from style_transfer_based_holographic_imaging_tpu_torch.interop import (
        convert_params,
        load_style_vector,
    )
    from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet, quant
    from style_transfer_based_holographic_imaging_tpu_torch.pipelines import evaluate_synth_domain

    ckpt = lambda name: os.path.join(REPO, "checkpoints", name)  # noqa: E731
    restore = ocp.StandardCheckpointer().restore
    target = None if args.tag == "rbc" else {"params": restore(ckpt("rbc_release"))["params"]}
    params = restore(ckpt(f"{args.tag}_release"), target)["params"]
    net = StyleTransferNet(width=1.0)
    net.load_state_dict(convert_params(params), strict=True)
    net.eval()
    cfg = DOMAIN_PRESETS[DOMAINS[args.tag]]()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=32))
    style = load_style_vector(ckpt(f"{args.tag}_style_vector.npz"))
    bank = getattr(synth, f"{args.tag}_bank")(n=512, seed=7919)

    record_file = f"{args.tag}_quant_domain_metrics.json" if args.quant else f"{args.tag}_domain_metrics.json"
    with open(ckpt(record_file)) as f:
        record = json.load(f)
    n = args.batches or (record["n_batches"] if args.quant else len(record["psnr_per_batch"]))
    kw = dict(n_batches=n, refine_steps=args.refine_steps, refine_distance=args.refine_distance)
    prefix = ("refine_distance_" if args.refine_distance else "refined_") if args.refine_steps else ""
    recorded = {k: record.get(prefix + k) for k in KEYS}
    paths = {"fp32": {}}
    if args.quant:
        scales = quant.load_scales(ckpt(f"{args.tag}_quant_scales.json"))
        paths = {"int8": {"quant_scales": scales}, "fp32": {}}
        recorded = {"int8": {k: record[k] for k in KEYS}, "fp32": record["fp_same_subset"]}
    out = {"tag": args.tag, "batches": n, "batch": 32, "refine_steps": args.refine_steps,
           "refine_distance": args.refine_distance, "recorded": recorded}
    for name, extra in paths.items():
        t0 = time.time()
        m = evaluate_synth_domain(net, cfg, bank, style, device="cpu", **kw, **extra,
                                  **({"dtype": torch.bfloat16} if extra else {}))
        out[f"port_{name}"] = {**{k: m[k] for k in KEYS}, "psnr_per_batch": m["psnr_per_batch"],
                               "seconds": round(time.time() - t0, 1)}
        if args.jax:
            from style_transfer_based_holographic_imaging_tpu.config import DOMAIN_PRESETS as J_PRESETS
            from style_transfer_based_holographic_imaging_tpu.pipelines.domain_eval import (
                evaluate_synth_domain as j_evaluate,
            )

            jcfg = J_PRESETS[DOMAINS[args.tag]]()
            jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, batch_size=32))
            t0 = time.time()
            jm = j_evaluate(params, jcfg, bank, style, **kw, **extra,
                            **({"dtype": jnp.bfloat16} if extra else {}))
            out[f"jax_{name}"] = {**{k: jm[k] for k in KEYS}, "psnr_per_batch": jm["psnr_per_batch"],
                                  "seconds": round(time.time() - t0, 1)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
