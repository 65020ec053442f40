"""Command-line interface of the port (the JAX package's ``cli.py``, its
``serve`` and ``train`` subcommands so far):

  python -m style_transfer_based_holographic_imaging_tpu_torch.cli serve \\
      --checkpoint checkpoints/fast [--quant] [--refine STEPS] [--fp32] [--cpu]
  python -m style_transfer_based_holographic_imaging_tpu_torch.cli train \\
      --iterations 6000 --bank golden --adv-weight 1 --ema-decay 0.999 --train-encoder [--cpu]

The weights come from the release's ``torch_weights.npz`` (written by
``scripts/port_golden_eval.py --export-npz``), in the checkpoint directory or
its parent; the run config, style vector and int8 scales are looked up
beside the checkpoint in the JAX package's order. Without ``--cpu`` it runs
on the card, and raises when there is none.

``train`` takes the JAX package's flags that the port implements; argparse
refuses the others (mixed precision, the measured-tree sampler, the domain
presets and their banks, the device mesh, TensorBoard) with a message and
exit code 2. Its snapshots are the port's ``iter_<n>/state.pt``
(``train/state.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import (
    ExperimentConfig,
    ModelConfig,
)

_NPZ = "torch_weights.npz"


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--checkpoint", type=str, default=None,
                   help="release directory holding torch_weights.npz, or its orbax "
                        "subdirectory (default: checkpoints/release if present)")
    p.add_argument("--style-vector", type=str, default=None,
                   help=".npz with mean/std arrays (default: alongside checkpoint)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--image-size", type=int, default=128,
                   help="hologram side when no run config is found")
    p.add_argument("--asm-backend", choices=("auto", "torch", "cuda"), default="auto",
                   help="angular-spectrum propagator backend")
    p.add_argument("--quant", nargs="?", const="auto", default=None,
                   metavar="SCALES_JSON",
                   help="serve the int8 conv path (models/quant.py); with no "
                        "value, loads quant_scales.json beside the checkpoint")


def _setup_backend(args) -> torch.device:
    """Apply ``--asm-backend`` and return the device: the card unless
    ``--cpu``. Raises when the card is asked for and there is none."""
    from style_transfer_based_holographic_imaging_tpu_torch.ops.asm import set_asm_backend

    set_asm_backend(args.asm_backend)
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --cpu to run on the CPU")
    return torch.device("cuda")


def _load_quant_scales(args):
    """Resolve --quant into a scales dict (or None for the fp path)."""
    spec = getattr(args, "quant", None)
    if spec is None:
        return None
    from style_transfer_based_holographic_imaging_tpu_torch.models.quant import load_scales

    if spec != "auto":
        return load_scales(spec)
    ckpt = args.checkpoint or _default_ckpt() or "."
    parent = os.path.dirname(ckpt.rstrip("/")) or "."
    base = os.path.basename(ckpt.rstrip("/"))
    cands = [os.path.join(ckpt, "quant_scales.json")]
    if base.endswith("_release"):
        # domain releases live as siblings: rbc_release -> rbc_quant_scales.json
        cands.append(os.path.join(parent, base[: -len("_release")] + "_quant_scales.json"))
    cands.append(os.path.join(parent, "quant_scales.json"))
    for cand in cands:
        if os.path.isfile(cand):
            return load_scales(cand)
    print(
        "warning: --quant requested but no quant_scales.json found beside the "
        "checkpoint (run scripts/calibrate_quant.py); serving fp path",
        file=sys.stderr,
    )
    return None


def _default_ckpt() -> str | None:
    for cand in ("checkpoints/release", "checkpoints"):
        if os.path.isdir(cand):
            return cand
    return None


def _load_params(args):
    """The release's state dict from ``torch_weights.npz`` in the checkpoint
    directory or its parent. A checkpoint directory without one raises (its
    orbax weights cannot be read here); no checkpoint at all gives the random
    init of width 1.0 from ``torch.manual_seed(0)``."""
    from style_transfer_based_holographic_imaging_tpu_torch.interop import load_release_weights
    from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet

    ckpt = args.checkpoint or _default_ckpt()
    if ckpt and os.path.isdir(ckpt):
        parent = os.path.dirname(os.path.abspath(ckpt))
        for cand in (os.path.join(ckpt, _NPZ), os.path.join(parent, _NPZ)):
            if os.path.isfile(cand):
                state = load_release_weights(cand)
                print(f"loaded weights {cand}", file=sys.stderr)
                return state
        raise FileNotFoundError(
            f"{ckpt} holds no {_NPZ} (nor does its parent): the port cannot read orbax "
            f"weights. Write it where JAX runs: python scripts/port_golden_eval.py "
            f"--release <orbax dir> --export-npz {os.path.join(ckpt, _NPZ)}"
        )
    print("no checkpoint found; using random init", file=sys.stderr)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        return StyleTransferNet().state_dict()


def _load_config(args):
    """The run config serialized next to the checkpoint; None when absent."""
    ckpt = getattr(args, "checkpoint", None) or _default_ckpt()
    if not ckpt:
        return None
    base = os.path.basename(ckpt.rstrip("/"))
    parent = os.path.dirname(ckpt.rstrip("/")) or "."
    cands = [os.path.join(ckpt, "config.json")]
    # The parent dir's config.json belongs to the canonical `release`
    # checkpoint only: a sibling like rbc_release must not inherit the MNIST
    # release's physics; domain releases ship theirs as <tag>_config.json.
    if base == "release":
        cands.append(os.path.join(parent, "config.json"))
    elif base.endswith("_release"):
        cands.append(os.path.join(parent, base[: -len("_release")] + "_config.json"))
    for cand in cands:
        if os.path.isfile(cand):
            with open(cand) as f:
                cfg = ExperimentConfig.from_json(f.read())
            print(f"loaded run config {cand}", file=sys.stderr)
            return cfg
    return None


def _load_style(args):
    import numpy as np

    path = args.style_vector
    if path is None:
        ckpt = args.checkpoint or _default_ckpt()
        if ckpt:
            base = os.path.basename(ckpt.rstrip("/"))
            parent = os.path.dirname(ckpt.rstrip("/")) or "."
            cands = [os.path.join(ckpt, "style_vector.npz")]
            if base.endswith("_release") and base != "release":
                # domain releases: rbc_release -> sibling rbc_style_vector.npz
                # (the flagship's style_vector.npz must NOT leak in)
                cands.append(os.path.join(parent, base[: -len("_release")] + "_style_vector.npz"))
            else:
                cands += [
                    os.path.join(parent, "style_vector.npz"),
                    "checkpoints/style_vector.npz",
                ]
            for c in cands:
                if os.path.isfile(c):
                    path = c
                    break
    if path and os.path.isfile(path):
        with np.load(path) as z:
            print(f"loaded style vector {path}", file=sys.stderr)
            return z["mean"], z["std"]
    return None


def cmd_serve(args):
    """Long-lived retrieval server (pipelines/server.py): the weights on the
    card, npz requests over HTTP."""
    device = _setup_backend(args)
    from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet
    from style_transfer_based_holographic_imaging_tpu_torch.pipelines.server import (
        RetrievalService,
        serve_forever,
    )

    state = _load_params(args)
    style = _load_style(args)
    if style is None:
        print("no style vector found — required for serving", file=sys.stderr)
        return 1
    cfg = _load_config(args) or ExperimentConfig(model=ModelConfig(image_size=args.image_size))
    service = RetrievalService(
        StyleTransferNet.from_state_dict(state, cfg.model.width),
        style,
        cfg,
        batch_size=args.batch_size,
        dtype=torch.bfloat16 if args.bf16 else None,
        quant_scales=_load_quant_scales(args),
        refine_steps=args.refine,
        device=device,
    )
    print("warming up ...", file=sys.stderr)
    service.warmup()

    def ready(httpd):
        host, port = httpd.server_address[:2]
        print(f"serving on http://{host}:{port}  " + json.dumps(service.health()),
              file=sys.stderr, flush=True)

    serve_forever(service, args.host, args.port, ready=ready)
    return 0


def cmd_train(args):
    """Train on synthesized holograms on the card (``train/loop.py``)."""
    from style_transfer_based_holographic_imaging_tpu_torch.config import DataConfig, TrainConfig
    from style_transfer_based_holographic_imaging_tpu_torch.data import synth
    from style_transfer_based_holographic_imaging_tpu_torch.models import set_reflect_backend
    from style_transfer_based_holographic_imaging_tpu_torch.train import (
        latest_snapshot,
        restore_checkpoint,
        save_checkpoint,
        train,
    )

    device = _setup_backend(args)
    set_reflect_backend(args.reflect_backend)
    cfg = ExperimentConfig(
        model=ModelConfig(with_phase_decoder=args.phase_decoder),
        data=DataConfig(batch_size=args.batch_size, image_size=args.image_size, seed=args.seed,
                        rotate_deg=args.rotate_deg, elastic_px=args.elastic_px),
        train=TrainConfig(
            iterations=args.iterations, lr=args.lr, checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir, freeze_encoder=not args.train_encoder,
            supervised_weight=args.supervised_weight, physics_weight=args.physics_weight,
            adv_weight=args.adv_weight, perceptual_weight=args.perceptual_weight,
            distance_weight=args.distance_weight, content_weight=args.content_weight,
            style_weight=args.style_weight, log_every=args.log_every,
            grad_accum=args.grad_accum, ema_decay=args.ema_decay,
        ),
    )
    if args.digit_bank:
        if not os.path.isfile(args.digit_bank):
            print(f"--digit-bank {args.digit_bank}: file not found", file=sys.stderr)
            return 1
        bank = synth.load_digit_bank(args.digit_bank)
    elif args.bank == "sklearn":
        bank = synth.sklearn_digit_bank()
    else:
        from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite

        goldens = load_golden_suite()
        bank = (synth.golden_digit_bank(goldens, subset=synth.GOLDEN_TRAIN_DIGITS)
                if args.bank == "golden" else synth.mixed_digit_bank(goldens))

    state = None
    if args.resume:
        snap = latest_snapshot(cfg.train.checkpoint_dir)
        if snap:
            from style_transfer_based_holographic_imaging_tpu_torch.models import (
                PatchDiscriminator,
                init_net_params,
                init_params,
            )
            from style_transfer_based_holographic_imaging_tpu_torch.train import create_train_state

            # train()'s fresh-start construction, discriminator included, as
            # the structure to restore into.
            params = init_net_params(torch.Generator().manual_seed(args.seed),
                                     with_phase_decoder=cfg.model.with_phase_decoder)
            disc_params = None
            if cfg.train.adv_weight:
                disc_params = init_params(PatchDiscriminator(image_size=cfg.data.image_size),
                                          torch.Generator().manual_seed(args.seed + 1))
            state = restore_checkpoint(
                snap, create_train_state(params, cfg.train, disc_params=disc_params, device=device))
            print(f"resumed from {os.path.basename(snap)} (step {state.step})", file=sys.stderr)
        else:
            print("no iter_* snapshot found; training from scratch", file=sys.stderr)

    state = train(cfg, bank=bank, state=state, device=device)
    path = save_checkpoint(state, cfg.train.checkpoint_dir)
    print(f"final checkpoint: {path}")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="style_transfer_based_holographic_imaging_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve", help="HTTP retrieval server (fixed batch shape; npz in/out)")
    _add_common(p)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument("--batch-size", type=int, default=32,
                   help="batch shape of the net; requests are padded/chunked")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bf16 conv path (default on)")
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--refine", type=int, default=0, metavar="STEPS")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("train", help="train on synthesized holograms")
    _add_common(p)
    p.add_argument("--iterations", type=int, default=20000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-every", type=int, default=5000)
    p.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--train-encoder", action="store_true")
    p.add_argument("--phase-decoder", action="store_true",
                   help="train a dedicated decoder_ph head for the phase plane")
    p.add_argument("--rotate-deg", type=float, default=0.0,
                   help="per-sample rotation (+/- deg) of the synthesized phase objects")
    p.add_argument("--elastic-px", type=float, default=0.0,
                   help="elastic-warp amplitude in pixels")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest iter_* snapshot in --checkpoint-dir")
    p.add_argument("--supervised-weight", type=float, default=10.0)
    p.add_argument("--physics-weight", type=float, default=10.0)
    p.add_argument("--adv-weight", type=float, default=0.0)
    p.add_argument("--perceptual-weight", type=float, default=0.0)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches accumulated per optimizer step")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="Polyak-average the generator into the snapshot's ema_params (0 = off)")
    p.add_argument("--distance-weight", type=float, default=20.0)
    p.add_argument("--content-weight", type=float, default=0.1)
    p.add_argument("--style-weight", type=float, default=0.1)
    p.add_argument("--digit-bank", type=str, default=None,
                   help=".npz with a (N,64,64) 'bank' array or an MNIST export (overrides --bank)")
    p.add_argument("--bank", default="mixed", choices=("sklearn", "golden", "mixed"),
                   help="phase-object bank (sklearn and mixed need scikit-learn)")
    p.add_argument("--reflect-backend", choices=("auto", "matpad", "einsum", "cuda"), default="auto",
                   help="border handling of the reflect convs (cuda: the ring kernel)")
    p.set_defaults(fn=cmd_train)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
