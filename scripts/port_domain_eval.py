"""Score an experimental-domain release with the PyTorch port on the CPU.

Restores ``checkpoints/<tag>_release`` with orbax (the one step that needs
the JAX stack; ``bead``'s was saved on a TPU and restores into ``rbc``'s
tree, the same architecture), converts it, and runs the port's
``evaluate_synth_domain`` on the records' protocol: batches of 32 of the
JAX package's ``jax.random`` stream (seed 7777, reproduced in numpy by
``utils/jax_random.py``) over ``bead_bank``/``rbc_bank`` seed 7919. Prints
one JSON line: the port's metrics beside the record's.

    JAX_PLATFORMS=cpu python scripts/port_domain_eval.py --tag rbc|bead \\
        [--batches 10] [--quant] [--refine-steps N [--refine-distance]] [--jax] \
        [--threads N] [--save FILE] [--distance-gradient]

``--quant`` runs the int8 serving path in bf16 with
``checkpoints/<tag>_quant_scales.json`` over the int8 record's 3 batches
(``<tag>_quant_domain_metrics.json``), and the fp32 path on the same
batches (its ``fp_same_subset``). ``--refine-steps N`` refines every batch
(phase only, at the known amplitude); the record's ``refined_*`` (or, with
``--refine-distance``, ``refine_distance_*``) keys are then compared.
``--jax`` also runs the JAX package's ``evaluate_synth_domain`` on the same
release, stream and path, and prints its metrics beside the port's.
``--distance-gradient`` prints, at the stream's first batch and the net's
predicted distances, how far the refine loss's distance gradient of the port
(autograd) and of the JAX package (``jax.grad``) lie from a central
difference of the JAX package's own loss (``distance_gradients``; ROADMAP
C.7), also on the samples whose difference crosses no step of the band
limit (``band_limit_steps``). ``--threads N`` sets torch's CPU threads,
on which the refine with the distance depends (ROADMAP C.7). ``--save
FILE`` merges the port's reading of the path (its means, every batch's
PSNR, every predicted distance and the command) into FILE under
``<tag>`` and ``fp32``, ``int8``, ``refined`` or ``refine_distance``:
``chip_smoke.py`` holds the card to ``checkpoints/port_cpu_domain_readings.json``
where the records cannot be reproduced (ROADMAP C.6, C.8) or its time allows
fewer batches than the record's (refine-distance, 5 of 10).
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


def distance_stage_inputs(net, cfg, bank, style):
    """Where ``physics_refine`` starts its distance stage on the stream's
    first batch: (the known amplitude, the net's phase in network units, the
    net's distances, the measured amplitude), numpy fp32 of ``(B, 1, H, W)``
    and ``(B, 1, 1, 1)``."""
    import numpy as np
    import torch

    from style_transfer_based_holographic_imaging_tpu_torch.data.synth import synth_batch_from_key
    from style_transfer_based_holographic_imaging_tpu_torch.pipelines.field_retrieval import make_retrieval_fn
    from style_transfer_based_holographic_imaging_tpu_torch.utils import jax_random

    physics = cfg.physics
    batch = synth_batch_from_key(jax_random.fold_in(jax_random.key(7777), 0),
                                 torch.as_tensor(np.asarray(bank, np.float32)), cfg.data, physics, return_gt=True)
    d_style = float(physics.to_network_units(float(cfg.data.style_distances[0])))
    with torch.no_grad():
        out = make_retrieval_fn(physics, alpha=cfg.eval.alpha, device="cpu")(
            net, batch["content_holo"] ** 2, *(torch.as_tensor(np.asarray(v)) for v in style), d_style)
    amp = np.full(out["amp_foc"].shape, cfg.data.amplitude, np.float32)
    phase = out["ph_foc"].numpy() / np.float32(physics.phase_normalize)
    return amp, phase, out["distance_pred"].numpy(), batch["content_holo"].numpy()


def distance_gradients_at(inputs, physics, jphysics, eps=1e-3, asm_backend=None):
    """The refine loss's gradient in each sample's distance (network units)
    at ``inputs`` (``distance_stage_inputs``' four arrays): (the port's
    autograd through ``holo_forward`` with ``asm_backend``, the JAX
    package's ``jax.grad``, a central difference of the JAX package's loss
    by ``eps``), each (B,). The loss is a mean over the batch, each sample's
    term its own, so one pair of evaluations gives every sample's
    difference."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from style_transfer_based_holographic_imaging_tpu.ops import holo_forward as j_holo_forward
    from style_transfer_based_holographic_imaging_tpu_torch.ops import holo_forward

    amp, phase, d0, meas = inputs
    d = torch.tensor(d0, requires_grad=True)
    r = torch.sqrt(torch.clamp(holo_forward(torch.tensor(amp), torch.tensor(phase), d, physics,
                                            asm_backend=asm_backend), min=0.0))
    (port,) = torch.autograd.grad(torch.mean((r - torch.tensor(meas)) ** 2), d)

    def j_terms(dist):
        r = jnp.sqrt(jnp.maximum(j_holo_forward(jnp.asarray(amp), jnp.asarray(phase), dist, jphysics), 0.0))
        return jnp.mean((r - jnp.asarray(meas)) ** 2, axis=(1, 2, 3)) / r.shape[0]

    jgrad = jax.grad(lambda dist: jnp.sum(j_terms(dist)))(jnp.asarray(d0))
    diff = (np.asarray(j_terms(jnp.asarray(d0 + eps)), np.float64)
            - np.asarray(j_terms(jnp.asarray(d0 - eps)), np.float64)) / (2 * eps)
    return port.numpy().ravel(), np.asarray(jgrad).ravel(), diff.ravel()


def distance_gradients(net, cfg, jphysics, bank, style, eps=1e-3):
    """``distance_gradients_at`` the distance stage's start on the stream's
    first batch (``distance_stage_inputs``): (the port's autograd, the JAX
    package's ``jax.grad``, the central difference, the net's distances),
    each (B,)."""
    inputs = distance_stage_inputs(net, cfg, bank, style)
    return (*distance_gradients_at(inputs, cfg.physics, jphysics, eps), inputs[2].ravel())


def band_limit_steps(physics, d, eps, size):
    """For each distance ``d`` (network units), how many of the padded
    grid's frequencies the band limit's cutoff passes between ``d - eps``
    and ``d + eps``: where it passes any, the loss steps there and a
    central difference by ``eps`` sees a slope that no autograd sees."""
    import numpy as np

    n = size * physics.pad_factor
    f = np.abs(np.fft.fftfreq(n, d=physics.pixel_size))

    def f_lim(x):
        metres = np.abs(np.asarray(physics.to_metres(x), np.float64))
        return 1.0 / (physics.wavelength * np.sqrt((2.0 * metres / (n * physics.pixel_size)) ** 2 + 1.0))

    lo, hi = f_lim(d + eps), f_lim(d - eps)
    return np.array([int(np.sum((f > a) & (f <= b))) for a, b in zip(np.minimum(lo, hi), np.maximum(lo, hi))])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", choices=sorted(DOMAINS), required=True)
    ap.add_argument("--batches", type=int, default=None,
                    help="batches of 32 (default: the record's count)")
    ap.add_argument("--quant", action="store_true")
    ap.add_argument("--refine-steps", type=int, default=0)
    ap.add_argument("--refine-distance", action="store_true")
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--save", metavar="FILE", default=None)
    ap.add_argument("--distance-gradient", action="store_true")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch's CPU threads (default: torch's own); the refine "
                         "with the distance depends on them (ROADMAP C.7)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import orbax.checkpoint as ocp
    import torch

    if args.threads:
        torch.set_num_threads(args.threads)

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

    if args.distance_gradient:
        import numpy as np

        from style_transfer_based_holographic_imaging_tpu.config import DOMAIN_PRESETS as J_PRESETS

        port, jgrad, diff, d0 = distance_gradients(net, cfg, J_PRESETS[DOMAINS[args.tag]]().physics, bank, style)
        scale = float(np.abs(diff).max())
        steps = band_limit_steps(cfg.physics, d0, 1e-3, cfg.data.image_size)
        smooth = steps == 0
        print(json.dumps({
            "tag": args.tag, "batch": 32, "eps": 1e-3, "max_abs_central_difference": scale,
            "port_max_err_share": float(np.abs(port - diff).max()) / scale,
            "jax_max_err_share": float(np.abs(jgrad - diff).max()) / scale,
            "port_minus_jax_max_share": float(np.abs(port - jgrad).max()) / scale,
            "port_sign_agrees": float(np.mean(np.sign(port) == np.sign(diff))),
            "jax_sign_agrees": float(np.mean(np.sign(jgrad) == np.sign(diff))),
            "samples_whose_difference_crosses_a_band_limit_step": np.nonzero(steps)[0].tolist(),
            "jax_max_err_share_elsewhere": float(np.abs(jgrad - diff)[smooth].max()) / scale,
            "port_max_err_share_elsewhere": float(np.abs(port - diff)[smooth].max()) / scale,
        }))
        return

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
        if args.save and name == next(iter(paths)):
            saved = {**{k: m[k] for k in KEYS}, "batches": n, "psnr_per_batch": m["psnr_per_batch"],
                     "distance_pred_um": m["distance_pred_um"], "torch": torch.__version__,
                     "command": "JAX_PLATFORMS=cpu python scripts/port_domain_eval.py "
                                + " ".join(a for a in sys.argv[1:] if a != "--jax")}
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
    if args.save:
        key = "int8" if args.quant else (prefix.rstrip("_") or "fp32")
        readings = {}
        if os.path.exists(args.save):
            with open(args.save) as f:
                readings = json.load(f)
        readings.setdefault(args.tag, {})[key] = saved
        with open(args.save, "w") as f:
            json.dump(readings, f, indent=1, sort_keys=True)
            f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
