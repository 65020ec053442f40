"""Command-line interface of the port (the JAX package's ``cli.py``):

  python -m style_transfer_based_holographic_imaging_tpu_torch.cli eval \\
      --checkpoint checkpoints/fast [--save-dir output --exp-name MNIST_test] [--json]
      [--profile LOGDIR] [--refine STEPS [--refine-distance]] [--quant] [--cpu]
      golden-suite field retrieval: metrics, montages, box plot, metrics.jsonl;
      with --mat-root DIR [--domain D] [--batch-size B] a measured .mat test tree
  python -m style_transfer_based_holographic_imaging_tpu_torch.cli train \\
      --iterations 6000 --bank golden --adv-weight 1 --ema-decay 0.999 --train-encoder [--cpu]
      [--domain D] [--bank bead|rbc] [--mat-root DIR]
      [--devices N [--partition dp|zero1|fsdp|tp|tp_fsdp] [--model-devices M]]
  python -m style_transfer_based_holographic_imaging_tpu_torch.cli extract-style \\
      --checkpoint RUN [--bank sklearn|bead|rbc] [--domain D] [--mat-root DIR] --out sv.npz
  python -m style_transfer_based_holographic_imaging_tpu_torch.cli stream \\
      --checkpoint RUN --root DIR [--domain D] [--batch-size B] [--refine STEPS] [--devices N]
  python -m style_transfer_based_holographic_imaging_tpu_torch.cli autofocus \\
      --golden | --input holos.npz --d-min A --d-max B [--domain D]
  python -m style_transfer_based_holographic_imaging_tpu_torch.cli serve \\
      --checkpoint checkpoints/fast [--quant] [--refine STEPS] [--fp32] [--devices N] [--cpu]
      | --artifact model.hstx [--cpu]
  python -m style_transfer_based_holographic_imaging_tpu_torch.cli export \\
      --checkpoint checkpoints/fast --out model.hstx [--platforms cpu,cuda] [--bf16] [--quant]
      [--asm-backend cuda] [--batch-size B] [--check] [--cpu]
  python -m style_transfer_based_holographic_imaging_tpu_torch.cli sweep \\
      --checkpoint checkpoints/fast [--style-distances 0.2,0.4,0.6,0.8] [--save-dir DIR] [--seed S]
  python -m style_transfer_based_holographic_imaging_tpu_torch.cli synth-bench [--batch-size 512]
  python -m style_transfer_based_holographic_imaging_tpu_torch.cli doctor [--cpu]

The weights: a release's ``torch_weights.npz`` (written by
``scripts/port_golden_eval.py --export-npz``) in the checkpoint directory,
else the newest ``iter_<n>/state.pt`` snapshot of a training directory (its
params, as the JAX package takes a train state's), else the release's file
in the parent directory. The run config, style vector and int8 scales are
looked up beside the checkpoint in the JAX package's order. Without
``--cpu`` every command runs on the card, and raises when there is none
(``doctor`` reports that there is none instead).

``export`` writes a ``torch.export`` artifact (pipelines/export_artifact.py);
``--asm-backend auto`` exports the portable ``torch.fft`` refocus, ``cuda``
the ``asm_const`` kernel (a card-only file), as the JAX command maps
``auto`` to ``xla``. ``serve --artifact`` serves such a file.

Each command takes the JAX package's flags that the port implements and
prints its lines (``train --dtype bfloat16`` is mixed-precision training,
``--tensorboard-dir`` mirrors its scalars). argparse refuses the one left,
``extract-style --pt-out`` (the reference's ``.pt`` layout), with a message
and exit code 2.

The device mesh (``parallel/``): ``train --devices N`` trains in N
processes, one a card (``nccl``; with ``--cpu``, N ``gloo`` ranks on the
CPU), the batch split over them; ``--partition`` picks the state's layout
(``zero1``/``fsdp`` shard the Adam moments / the whole state,
``tp``/``tp_fsdp`` split the layers' output channels over ``--model-devices``
of them, all N by default). ``serve --devices N`` and ``stream --devices N``
split each batch over N cards from one process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import (
    DOMAIN_PRESETS,
    ExperimentConfig,
    ModelConfig,
)

_NPZ = "torch_weights.npz"
_DOMAINS = sorted(set(DOMAIN_PRESETS))


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
    """The weights as a state dict: ``torch_weights.npz`` in the checkpoint
    directory; else, for a training directory (or one snapshot), the params
    of its newest ``iter_<n>/state.pt``; else ``torch_weights.npz`` in the
    parent directory. A checkpoint directory with none of them raises (its
    orbax weights cannot be read here); no checkpoint at all gives the random
    init of width 1.0 from ``torch.manual_seed(0)``."""
    from style_transfer_based_holographic_imaging_tpu_torch.interop import load_release_weights
    from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet
    from style_transfer_based_holographic_imaging_tpu_torch.train import (
        latest_snapshot,
        load_train_params,
    )

    ckpt = args.checkpoint or _default_ckpt()
    if ckpt and os.path.isdir(ckpt):
        own = os.path.join(ckpt, _NPZ)
        snap = ckpt if os.path.isfile(os.path.join(ckpt, "state.pt")) else latest_snapshot(ckpt)
        parent = os.path.join(os.path.dirname(os.path.abspath(ckpt)), _NPZ)
        if not os.path.isfile(own) and snap:
            state = load_train_params(snap, ema=False)
            print(f"loaded checkpoint {snap}", file=sys.stderr)
            return state
        for cand in (own, parent):
            if os.path.isfile(cand):
                state = load_release_weights(cand)
                print(f"loaded weights {cand}", file=sys.stderr)
                return state
        raise FileNotFoundError(
            f"{ckpt} holds no {_NPZ} and no iter_<n>/state.pt (nor does its parent hold "
            f"{_NPZ}): the port cannot read orbax weights. Write it where JAX runs: "
            f"python scripts/port_golden_eval.py --release <orbax dir> "
            f"--export-npz {os.path.join(ckpt, _NPZ)}"
        )
    print("no checkpoint found; using random init", file=sys.stderr)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        return StyleTransferNet().state_dict()


def _net(state, cfg: ExperimentConfig, device: torch.device):
    """The net of ``state`` at the config's width, in eval mode on ``device``."""
    from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet

    return StyleTransferNet.from_state_dict(state, cfg.model.width).to(device)


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


def cmd_eval(args):
    """The golden suite (or, with ``--mat-root``, a measured test tree)
    through field retrieval, with the JAX package's printed lines."""
    import contextlib
    import dataclasses

    device = _setup_backend(args)
    state = _load_params(args)
    style = _load_style(args)
    cfg = _load_config(args) or ExperimentConfig()
    save_dir = os.path.join(args.save_dir, args.exp_name) if args.save_dir else None

    if args.mat_root:
        # The measured test-split protocol.
        from style_transfer_based_holographic_imaging_tpu_torch.pipelines.mat_eval import (
            evaluate_mat_tree,
        )

        if args.domain:
            cfg = DOMAIN_PRESETS[args.domain]()
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, image_size=args.image_size))
        metrics = evaluate_mat_tree(
            _net(state, cfg, device),
            args.mat_root,
            cfg,
            style,
            domain=args.domain,
            batch_size=args.batch_size,
            refine_steps=args.refine,
            refine_distance=args.refine_distance,
            quant_scales=_load_quant_scales(args),
            device=device,
        )
        if "mean_psnr" in metrics:
            print(f"Mean PSNR: {metrics['mean_psnr']:.4f}")
            print(f"Mean MAE: {metrics['mean_mae']:.6f}")
        print(f"R2 score: {metrics['r2']:.6f}")
        print(f"Samples: {metrics['n_samples']} ({metrics['n_gt_scored']} GT-scored)")
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            with open(os.path.join(save_dir, "mat_eval_metrics.json"), "w") as f:
                json.dump(metrics, f, indent=2)
        if args.json:
            keys = ("mean_psnr", "mean_mae", "r2", "n_samples", "n_gt_scored")
            print(json.dumps({k: metrics[k] for k in keys if k in metrics}))
        return metrics

    from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
    from style_transfer_based_holographic_imaging_tpu_torch.pipelines import evaluate_golden_suite

    goldens = load_golden_suite()
    net = _net(state, cfg, device)
    profile_cm = contextlib.nullcontext()
    if args.profile:
        from style_transfer_based_holographic_imaging_tpu_torch.utils.profiling import trace

        profile_cm = trace(args.profile)
        print(f"writing profiler trace to {args.profile}", file=sys.stderr)
    if args.refine_distance and not args.refine:
        print("warning: --refine-distance has no effect without --refine N", file=sys.stderr)
    with profile_cm:
        metrics = evaluate_golden_suite(
            net,
            goldens,
            cfg,
            save_dir=save_dir,
            style_override=style,
            refine_steps=args.refine,
            refine_distance=args.refine_distance,
            quant_scales=_load_quant_scales(args),
            device=device,
        )
    print(f"Mean PSNR: {metrics['mean_psnr']:.4f}")
    print(f"Mean MAE: {metrics['mean_mae']:.6f}")
    print(f"R2 score: {metrics['r2']:.6f}")
    if "heldout_mean_psnr" in metrics:
        print(
            f"Held-out (uncontaminated) PSNR: {metrics['heldout_mean_psnr']:.4f} "
            f"R2: {metrics['heldout_r2']:.6f}"
        )
    if metrics.get("distance_outlier_batches"):
        print(
            f"WARNING: distance outlier batches {metrics['distance_outlier_batches']}"
            f" (max |err| {metrics['distance_max_abs_err_um']:.1f} um)"
        )
    if args.json:
        keys = ("mean_psnr", "mean_mae", "r2",
                "heldout_mean_psnr", "heldout_r2", "distance_outlier_batches")
        print(json.dumps({k: metrics[k] for k in keys if k in metrics}))
    return metrics


def _ready(service):
    """serve_forever's ``ready``: the bound address and the health line."""
    def ready(httpd):
        host, port = httpd.server_address[:2]
        print(f"serving on http://{host}:{port}  " + json.dumps(service.health()),
              file=sys.stderr, flush=True)
    return ready


def _mesh(args, **kw):
    """The mesh over the first ``--devices`` cards, or as many positions on
    the CPU with ``--cpu``."""
    from style_transfer_based_holographic_imaging_tpu_torch.parallel import make_mesh

    return make_mesh(args.devices, devices=["cpu"] * args.devices if args.cpu else None, **kw)


def cmd_serve(args):
    """Long-lived retrieval server (pipelines/server.py): the weights on the
    card, npz requests over HTTP; with ``--artifact`` a frozen export file
    instead of a checkpoint."""
    device = _setup_backend(args)
    from style_transfer_based_holographic_imaging_tpu_torch.pipelines.server import (
        ArtifactService,
        RetrievalService,
        serve_forever,
    )

    if args.artifact:
        # Everything comes from the one file.
        if args.refine or (args.devices and args.devices > 1):
            print("--artifact serving is single-device, network-only "
                  "(--refine/--devices need the live program)", file=sys.stderr)
            return 1
        if args.quant or args.checkpoint or args.style_vector:
            print("--artifact serving takes the program, weights, style vector and "
                  "quantization from the file: drop --quant/--checkpoint/--style-vector "
                  "(use 'export' to change them)", file=sys.stderr)
            return 1
        service = ArtifactService(args.artifact, device)
        if args.batch_size is not None and args.batch_size != service.batch_size:
            print(f"note: --batch-size {args.batch_size} ignored: the artifact was exported "
                  f"at batch {service.batch_size}; requests are padded/chunked to that",
                  file=sys.stderr)
        print("warming up ...", file=sys.stderr)
        service.warmup()
        serve_forever(service, args.host, args.port, ready=_ready(service))
        return 0

    from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet

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
        batch_size=args.batch_size or 32,
        dtype=torch.bfloat16 if args.bf16 else None,
        quant_scales=_load_quant_scales(args),
        refine_steps=args.refine,
        device=device,
        mesh=_mesh(args) if args.devices and args.devices > 1 else None,
    )
    print("warming up ...", file=sys.stderr)
    service.warmup()
    serve_forever(service, args.host, args.port, ready=_ready(service))
    return 0


def cmd_export(args):
    """Freeze the retrieval program into one ``torch.export`` file
    (pipelines/export_artifact.py): weights, style vector and refocus
    distance baked in; it runs with ``torch`` alone on every exported
    device."""
    import numpy as np

    from style_transfer_based_holographic_imaging_tpu_torch.pipelines.export_artifact import (
        export_retrieval,
        load_artifact,
        save_artifact,
    )

    device = _setup_backend(args)
    state = _load_params(args)
    style = _load_style(args)
    if style is None:
        print("no style vector found — required for export", file=sys.stderr)
        return 1
    cfg = _load_config(args) or ExperimentConfig(model=ModelConfig(image_size=args.image_size))
    # '' exports for the command's own device.
    platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip()) or (device.type,)
    blob, meta = export_retrieval(
        _net(state, cfg, device),
        style,
        cfg,
        batch_size=args.batch_size,
        dtype=torch.bfloat16 if args.bf16 else None,
        quant_scales=_load_quant_scales(args),
        style_distance=args.style_distance,
        platforms=platforms,
        # "auto" exports the portable torch.fft refocus; an explicit "cuda"
        # the asm_const kernel (a card-only artifact).
        asm_backend="cuda" if args.asm_backend == "cuda" else "torch",
    )
    save_artifact(args.out, blob, meta)
    summary = {k: meta[k] for k in meta if k != "config"}
    summary["bytes"] = os.path.getsize(args.out)
    print(f"wrote {args.out}  " + json.dumps(summary))

    if args.check:
        if device.type not in meta["platforms"]:
            print(f"--check skipped: artifact targets {meta['platforms']} but this command "
                  f"runs on {device.type!r}", file=sys.stderr)
            return 0
        from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
        from style_transfer_based_holographic_imaging_tpu_torch.pipelines import evaluate_golden_suite

        suite = load_golden_suite()
        # The artifact bakes one refocus plane and drops the per-batch style
        # distance the suite passes: on another plane the scores would not
        # be comparable, so none are given.
        golden_mm = np.unique(np.round(suite.distance_style, 6))
        if len(golden_mm) != 1 or abs(float(golden_mm[0]) - meta["style_distance_mm"]) > 1e-6:
            print(f"--check skipped: artifact bakes a {meta['style_distance_mm']} mm refocus "
                  f"plane but the golden suite is recorded at "
                  f"{[round(float(v), 6) for v in golden_mm]} mm: the scores would not be "
                  f"comparable", file=sys.stderr)
            return 0
        # The written file, not the program in memory.
        art = load_artifact(args.out, device)
        m = evaluate_golden_suite(
            None, suite, cfg, style_override=style, device=device,
            retrieval_fn=lambda net, holo, sm, ss, d: art.retrieve(holo.cpu().numpy()),
        )
        print(json.dumps({k: round(m[k], 4) for k in ("mean_psnr", "mean_mae", "r2")}))
    return 0


def cmd_synth_bench(args):
    """Hologram synthesis throughput: ``holo_forward`` with one distance a
    sample (``asm_dynamic`` on the card), one JSON line."""
    import time

    import numpy as np

    from style_transfer_based_holographic_imaging_tpu_torch.config import PhysicsConfig
    from style_transfer_based_holographic_imaging_tpu_torch.ops import holo_forward

    device = _setup_backend(args)
    physics = PhysicsConfig()
    b, n = args.batch_size, args.image_size
    rng = np.random.default_rng(0)
    amp = torch.full((b, 1, n, n), 0.6, dtype=torch.float32, device=device)
    ph = torch.from_numpy(rng.random((b, 1, n, n), np.float32)).to(device)
    # distance sweep: one distance per sample
    d = torch.linspace(0.2, 0.8, b, device=device).reshape(b, 1, 1, 1)
    with torch.no_grad():
        float(holo_forward(amp, ph, d, physics).sum())
        reps = 50
        t0 = time.perf_counter()
        acc = None
        for _ in range(reps):
            s = holo_forward(amp, ph, d, physics).sum()
            acc = s if acc is None else acc + s
        float(acc)
    dt = time.perf_counter() - t0
    print(json.dumps({"metric": "hologram synthesis (distance sweep)",
                      "value": round(b * reps / dt, 1), "unit": "holograms/sec/chip"}))
    return 0


def cmd_sweep(args):
    """Distance-interpolation sweep (the reference's test_interpolation
    mode): one golden digit re-rendered at every style distance, retrieved,
    and saved as a montage with one row a plane."""
    import numpy as np
    from PIL import Image

    from style_transfer_based_holographic_imaging_tpu_torch.config import DataConfig, PhysicsConfig
    from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite, synth
    from style_transfer_based_holographic_imaging_tpu_torch.eval.report import to_image
    from style_transfer_based_holographic_imaging_tpu_torch.pipelines import retrieval_step
    from style_transfer_based_holographic_imaging_tpu_torch.utils import jax_random

    device = _setup_backend(args)
    style = _load_style(args)
    if style is None:
        print("no style vector found — required for sweep", file=sys.stderr)
        return 1
    state = _load_params(args)
    cfg = _load_config(args) or ExperimentConfig()
    physics = PhysicsConfig()
    distances = tuple(float(x) for x in args.style_distances.split(","))
    bank = torch.from_numpy(synth.golden_digit_bank(load_golden_suite())).to(device)
    batch = synth.synth_interpolation_batch(
        jax_random.key(args.seed), bank, data=DataConfig(style_distances=distances), physics=physics)
    out = retrieval_step(
        _net(state, cfg, device),
        batch["content_holo"] ** 2,  # retrieval_step takes intensity
        style[0], style[1], batch["distance_style"], physics, device=device,
    )
    planes = [batch["content_holo"], out["amp_field"], out["amp_foc"], out["ph_foc"]]
    planes = [p[:, 0].cpu().numpy() for p in planes]
    grid = np.concatenate([np.concatenate([p[i] for p in planes], axis=1)
                           for i in range(len(distances))], axis=0)
    os.makedirs(args.save_dir, exist_ok=True)
    path = os.path.join(args.save_dir, "interpolation_sweep.png")
    Image.fromarray(to_image(grid)).save(path)
    print(f"sweep montage ({len(distances)} planes): {path}")
    return 0


def _repo_root() -> str:
    """The repository root: the port package's parent."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _release_inventory(root: str) -> dict:
    """The JAX doctor's release inventory of ``root`` (``checkpoints/``),
    each release also saying whether the port's weights file, which the
    port loads (``_load_params``), is beside it."""
    def scores(path, keys=("mean_psnr", "r2", "refined_mean_psnr")):
        with open(path) as f:
            m = json.load(f)
        return {k: round(m[k], 4) for k in keys if k in m}

    def torch_weights(release):
        return any(os.path.isfile(os.path.join(d, _NPZ))
                   for d in (release, os.path.dirname(release.rstrip("/"))))

    tiers = {}
    cands = [("flagship", root)] + [
        (n, os.path.join(root, n)) for n in sorted(os.listdir(root))
        if os.path.isdir(os.path.join(root, n, "release"))
    ]
    for name, d in cands:
        if not os.path.isdir(os.path.join(d, "release")):
            continue
        t = {"path": os.path.join(d, "release")}
        gm = os.path.join(d, "golden_metrics.json")
        if os.path.isfile(gm):
            t["golden"] = scores(gm)
        t["int8_scales"] = os.path.isfile(os.path.join(d, "quant_scales.json"))
        t["torch_weights"] = torch_weights(t["path"])
        tiers[name] = t
    for tag in ("rbc", "bead"):
        rel = os.path.join(root, f"{tag}_release")
        if os.path.isdir(rel):
            t = {"path": rel}
            dm = os.path.join(root, f"{tag}_domain_metrics.json")
            if os.path.isfile(dm):
                t["domain"] = scores(dm)
            t["int8_scales"] = os.path.isfile(os.path.join(root, f"{tag}_quant_scales.json"))
            t["torch_weights"] = torch_weights(rel)
            tiers[tag] = t
    return tiers


def cmd_doctor(args):
    """Environment and release diagnostic, one JSON report: the devices,
    the release inventory with its recorded quality, the native libraries
    and the kernels' build cache. Without a card (and without ``--cpu``) it
    says so and computes nothing."""
    from style_transfer_based_holographic_imaging_tpu_torch.kernels import _build

    if args.cpu:
        devices = ["cpu"]
    elif torch.cuda.is_available():
        devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    else:
        devices = "none: no CUDA card (--cpu runs on the CPU)"
    rep = {"devices": devices, "torch": torch.__version__, "cuda": torch.version.cuda}
    root = os.path.join(_repo_root(), "checkpoints")
    rep["scanned"] = root
    rep["releases"] = _release_inventory(root) if os.path.isdir(root) else {}
    native_dir = os.path.join(_repo_root(), "native")
    rep["native_libs"] = sorted(
        f for f in (os.listdir(native_dir) if os.path.isdir(native_dir) else []) if f.endswith(".so"))
    build_dir = _build.BUILD_DIR
    rep["kernel_build"] = {"dir": build_dir, "libs": sorted(
        f for f in (os.listdir(build_dir) if os.path.isdir(build_dir) else []) if f.endswith(".so"))}
    print(json.dumps(rep, indent=2))
    return 0


def cmd_train(args):
    """Train on synthesized holograms, or on a measured ``.mat`` train tree
    (``--mat-root``), on the card (``train/loop.py``); with ``--devices N``
    in N processes over a mesh (``parallel.launch``), rank 0 writing the
    logs and snapshots."""
    if args.partition != "dp" and (not args.devices or args.devices < 2):
        print(f"--partition {args.partition} needs --devices N (N >= 2)", file=sys.stderr)
        return 1
    if not args.devices or args.devices < 2:
        return _train(args)
    from style_transfer_based_holographic_imaging_tpu_torch.parallel import (
        DATA_AXIS,
        MODEL_AXIS,
        launch,
    )

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --cpu to run on the CPU")
    if args.partition in ("tp", "tp_fsdp"):
        # Channel TP needs a model axis: all the devices on it (data=1)
        # unless --model-devices splits them.
        m = args.model_devices or args.devices
        if args.devices % m:
            print(f"--devices {args.devices} must divide by --model-devices {m}", file=sys.stderr)
            return 1
        mesh = _mesh(args, axis_names=(DATA_AXIS, MODEL_AXIS), shape=(args.devices // m, m))
    else:
        mesh = _mesh(args)
    # No deadline for the run (a schedule of any length); each collective
    # keeps its own time limit.
    return launch(_train_rank, mesh, args, mesh, timeout=None)[0]


def _train_rank(rank: int, args, mesh) -> int:
    """One rank of ``cmd_train``'s world."""
    return _train(args, mesh)


def _train(args, mesh=None) -> int:
    """``cmd_train`` in this process: alone, or as one rank of ``mesh``'s
    world (``train()`` reads the rank; rank 0 alone prints and saves)."""
    import dataclasses

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
    rank = 0
    if mesh is not None:
        import torch.distributed as dist

        rank = dist.get_rank()
        device = mesh.device_list[rank]
    set_reflect_backend(args.reflect_backend)
    model_cfg = ModelConfig(dtype=args.dtype, with_phase_decoder=args.phase_decoder)
    train_cfg = TrainConfig(
        iterations=args.iterations, lr=args.lr, checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir, freeze_encoder=not args.train_encoder,
        supervised_weight=args.supervised_weight, physics_weight=args.physics_weight,
        adv_weight=args.adv_weight, perceptual_weight=args.perceptual_weight,
        distance_weight=args.distance_weight, content_weight=args.content_weight,
        style_weight=args.style_weight, log_every=args.log_every,
        grad_accum=args.grad_accum, ema_decay=args.ema_decay,
        tensorboard_dir=args.tensorboard_dir,
    )
    data_kw = dict(batch_size=args.batch_size, image_size=args.image_size, seed=args.seed,
                   rotate_deg=args.rotate_deg, elastic_px=args.elastic_px)
    if args.domain:
        # Inside an experimental domain's preset: its physics and distances.
        preset = DOMAIN_PRESETS[args.domain]()
        cfg = ExperimentConfig(name=preset.name, physics=preset.physics, model=model_cfg,
                               data=dataclasses.replace(preset.data, **data_kw), train=train_cfg)
    else:
        cfg = ExperimentConfig(model=model_cfg, data=DataConfig(**data_kw), train=train_cfg)

    sampler = None
    if args.mat_root:
        from style_transfer_based_holographic_imaging_tpu_torch.data.mat_sampler import (
            MeasuredHologramSampler,
        )

        if args.digit_bank:
            print("--digit-bank and --mat-root are mutually exclusive "
                  "(measured-tree training draws no synthetic objects)", file=sys.stderr)
            return 1
        if args.rotate_deg or args.elastic_px:
            print("--rotate-deg/--elastic-px apply to synthetic-object warps "
                  "and are not implemented by the measured-tree sampler; drop "
                  "them (measured training augments by crop+flip only)", file=sys.stderr)
            return 1
        if cfg.train.supervised_weight:
            # A measured tree has no complex ground truth to supervise on.
            if rank == 0:
                print("note: --mat-root training has no ground truth; forcing "
                      "supervised_weight=0 (physics cycle + style + content + "
                      "distance)", file=sys.stderr)
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, supervised_weight=0.0))
        sampler = MeasuredHologramSampler(args.mat_root, cfg.data, cfg.physics, domain=args.domain)
        if rank == 0:
            print(f"measured train tree: {len(sampler.ds)} frames "
                  f"({sampler.n_content} content / {sampler.n_style} style candidates)",
                  file=sys.stderr)

    bank = None
    if args.digit_bank:
        if not os.path.isfile(args.digit_bank):
            print(f"--digit-bank {args.digit_bank}: file not found", file=sys.stderr)
            return 1
        bank = synth.load_digit_bank(args.digit_bank)
    elif sampler is None:
        if args.bank == "sklearn":
            bank = synth.sklearn_digit_bank()
        elif args.bank == "bead":
            bank = synth.bead_bank()
        elif args.bank == "rbc":
            bank = synth.rbc_bank()
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
            if rank == 0:
                print(f"resumed from {os.path.basename(snap)} (step {state.step})", file=sys.stderr)
        elif rank == 0:
            print("no iter_* snapshot found; training from scratch", file=sys.stderr)

    state = train(cfg, bank=bank, sampler=sampler, state=state, device=device, mesh=mesh,
                  partition=args.partition, log_fn=print if rank == 0 else lambda _: None)
    if rank == 0:
        path = save_checkpoint(state, cfg.train.checkpoint_dir)
        print(f"final checkpoint: {path}", flush=True)
    return 0


def cmd_extract_style(args):
    """A style vector for the checkpoint's encoder: from synthesized
    style-plane holograms of a bank, or from measured style-plane patches
    (``--mat-root``)."""
    import numpy as np

    from style_transfer_based_holographic_imaging_tpu_torch.data import synth
    from style_transfer_based_holographic_imaging_tpu_torch.pipelines.style_vector import (
        extract_style_vector,
        save_style_vector,
        style_vector_from_holograms,
    )

    device = _setup_backend(args)
    state = _load_params(args)
    cfg = DOMAIN_PRESETS[args.domain]() if args.domain else ExperimentConfig()
    net = _net(state, cfg, device)
    if args.mat_root:
        # Encoder statistics averaged over measured style-plane patches.
        from style_transfer_based_holographic_imaging_tpu_torch.data.mat_sampler import (
            MeasuredHologramSampler,
        )

        sampler = MeasuredHologramSampler(args.mat_root, cfg.data, cfg.physics, domain=args.domain)
        ms, ss = zip(*(style_vector_from_holograms(net, patches)
                       for patches in sampler.style_batches(args.n_batches)))
        mean = np.mean(np.concatenate(ms), axis=0, keepdims=True)
        std = np.mean(np.concatenate(ss), axis=0, keepdims=True)
    else:
        bank = {"bead": synth.bead_bank, "rbc": synth.rbc_bank}.get(
            args.bank, synth.sklearn_digit_bank)()
        mean, std = extract_style_vector(net, cfg, bank, n_batches=args.n_batches)
    save_style_vector(mean, std, args.out)
    print(f"style vector written to {args.out}")
    return 0


def cmd_stream(args):
    """Streaming inference over a ``.mat`` hologram tree (the RBC mode): one
    JSON line with the steady-state frames/s."""
    import time

    from style_transfer_based_holographic_imaging_tpu_torch.data.mat_loader import HoloMatDataset
    from style_transfer_based_holographic_imaging_tpu_torch.pipelines.streaming import (
        stream_retrieval,
    )

    device = _setup_backend(args)
    state = _load_params(args)
    style = _load_style(args)
    if style is None:
        print("no style vector found — required for streaming", file=sys.stderr)
        return 1
    cfg = ExperimentConfig()
    preset = DOMAIN_PRESETS.get(args.domain)
    if preset is not None:
        cfg = preset()
    distances = ([float(x) for x in args.distances.split(",")] if args.distances
                 else list(cfg.data.content_distances))
    ds = HoloMatDataset(args.root, args.image_set, distances, domain=args.domain)
    if not len(ds):
        print(f"no .mat records under {args.root}", file=sys.stderr)
        return 1
    print(f"streaming {len(ds)} frames from {args.root}", file=sys.stderr)
    sharding = None
    if args.devices and args.devices > 1:
        from style_transfer_based_holographic_imaging_tpu_torch.parallel import batch_sharding

        if args.batch_size % args.devices:
            print(f"--batch-size {args.batch_size} must divide by --devices {args.devices}",
                  file=sys.stderr)
            return 1
        sharding = batch_sharding(_mesh(args))

    n, n_steady, t_steady, last = 0, 0, None, None
    t_start = time.perf_counter()
    for out in stream_retrieval(
        _net(state, cfg, device),
        ds.batches(args.batch_size),
        style,
        cfg,
        style_distance=args.style_distance,
        refine_steps=args.refine,
        quant_scales=_load_quant_scales(args),
        device=device,
        sharding=sharding,
    ):
        b = int(out["amp_field"].shape[0])
        n += b
        last = out
        if t_steady is None:
            # the first batch pays the warm-up: sync on it, then start the clock
            float(out["amp_field"].sum())
            t_steady = time.perf_counter()
        else:
            n_steady += b
    if last is None:
        return 1
    float(last["amp_field"].sum())  # the stream's work is ordered: the last output bounds it
    if n_steady:
        fps = n_steady / max(time.perf_counter() - t_steady, 1e-9)
    else:
        fps = n / max(t_steady - t_start, 1e-9)
    print(json.dumps({
        "metric": f"{args.domain or 'mat'} streaming retrieval",
        "frames": n,
        "value": round(fps, 1),
        "unit": "frames/sec/chip",
        "note": "steady-state (first batch excluded)" if n_steady
        else "single batch (includes jit compile)",
    }))
    return 0


def cmd_autofocus(args):
    """Network-free distance estimation by refocus sharpness search
    (``pipelines/autofocus.py``) over the golden suite (``--golden``, with R²
    against the true distances) or an ``.npz``/``.npy`` of ``(N, 1, H, W)``
    intensity holograms."""
    import numpy as np

    from style_transfer_based_holographic_imaging_tpu_torch.pipelines.autofocus import autofocus

    device = _setup_backend(args)
    cfg = ExperimentConfig()
    if args.domain:
        preset = DOMAIN_PRESETS.get(args.domain)
        if preset is None:
            print(f"unknown domain {args.domain!r}", file=sys.stderr)
            return 1
        cfg = preset()
    physics = cfg.physics

    d_true = None
    if args.golden:
        from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite

        g = load_golden_suite()
        holo = g.content_holo.reshape((-1,) + g.content_holo.shape[2:])
        d_true = g.distance_content.reshape(-1)
        lo, hi = args.d_min if args.d_min is not None else 0.2, args.d_max or 1.0
    else:
        if not args.input:
            print("need --golden or --input FILE.npz", file=sys.stderr)
            return 1
        z = np.load(args.input)
        holo = z[args.key] if hasattr(z, "files") else z
        if holo.ndim == 3:
            holo = holo[:, None]
        if args.d_min is None or args.d_max is None:
            print("--d-min/--d-max required with --input", file=sys.stderr)
            return 1
        lo, hi = args.d_min, args.d_max

    d_all = []
    for i in range(0, len(holo), args.batch_size):
        d_found, _, _ = autofocus(holo[i : i + args.batch_size], lo, hi, physics,
                                  n_coarse=args.n_coarse, n_fine=args.n_fine, metric=args.metric,
                                  device=device)
        d_all.append(d_found.cpu().numpy())
    d_all = np.concatenate(d_all)

    out = {
        "metric": f"autofocus ({args.metric})",
        "n": int(len(d_all)),
        "d_mean": float(np.mean(d_all)),
        "unit": "network distance units (mm by default)",
    }
    if d_true is not None:
        from style_transfer_based_holographic_imaging_tpu_torch.eval.metrics import r2_score

        out["r2_vs_true"] = float(r2_score(np.asarray(d_true), d_all))
        out["mae_mm"] = float(np.mean(np.abs(d_all - d_true)))
    print(json.dumps(out))
    if args.print_distances:
        for v in d_all.tolist():
            print(f"{v:.4f}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    """Every command with the flags it takes."""
    parser = argparse.ArgumentParser(prog="style_transfer_based_holographic_imaging_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("eval", help="golden-suite field retrieval evaluation")
    _add_common(p)
    p.add_argument("--save-dir", type=str, default="output",
                   help="reports under SAVE_DIR/EXP_NAME ('' writes none)")
    p.add_argument("--exp-name", type=str, default="MNIST_test")
    p.add_argument("--json", action="store_true")
    p.add_argument("--profile", type=str, default=None, metavar="LOGDIR",
                   help="write a torch.profiler Chrome trace of the evaluation into LOGDIR")
    p.add_argument("--refine", type=int, default=0, metavar="STEPS",
                   help="physics-consistent refinement steps per batch (0 = network only)")
    p.add_argument("--refine-distance", action="store_true",
                   help="also refine the predicted distance during refinement")
    p.add_argument("--mat-root", type=str, default=None,
                   help="score a measured .mat test tree (with gt_amplitude/gt_phase) "
                        "instead of the golden suite; --domain picks its layout and physics")
    p.add_argument("--domain", default=None, choices=_DOMAINS,
                   help="experimental-domain preset for --mat-root")
    p.add_argument("--batch-size", type=int, default=4,
                   help="--mat-root batch size (the last batch is padded by repetition)")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("train", help="train on synthesized or measured holograms")
    _add_common(p)
    p.add_argument("--iterations", type=int, default=20000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-every", type=int, default=5000)
    p.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--tensorboard-dir", type=str, default="",
                   help="also mirror the per-log-step scalars to a TensorBoard event dir "
                        "(needs tensorboardX; '' = off)")
    p.add_argument("--train-encoder", action="store_true")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="conv compute dtype; bfloat16 = mixed-precision training "
                        "(fp32 params, optimizer and losses)")
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
    p.add_argument("--bank", default="mixed", choices=("sklearn", "golden", "mixed", "bead", "rbc"),
                   help="phase-object bank: digits (sklearn and mixed need scikit-learn) or "
                        "the synthetic experimental domains (bead, rbc)")
    p.add_argument("--domain", default=None, choices=_DOMAINS,
                   help="experimental-domain preset (physics + distances)")
    p.add_argument("--mat-root", type=str, default=None,
                   help="train from a measured .mat tree (root/train/holography/<distance>/*.mat) "
                        "instead of synthesized holograms; it has no complex ground truth, so "
                        "the supervised loss is forced off")
    p.add_argument("--reflect-backend", choices=("auto", "matpad", "einsum", "cuda"), default="auto",
                   help="border handling of the reflect convs (cuda: the ring kernel)")
    p.add_argument("--devices", type=int, default=0,
                   help="train in one process over each of the first N cards (with --cpu: N "
                        "CPU processes), the batch split along the data mesh axis")
    p.add_argument("--partition", default="dp", choices=("dp", "zero1", "fsdp", "tp", "tp_fsdp"),
                   help="train-state layout on the mesh: whole on every rank (dp), ZeRO-1 "
                        "sharded optimizer moments, FSDP fully sharded state, channel tensor "
                        "parallelism (tp), or TP x FSDP on a 2-D mesh")
    p.add_argument("--model-devices", type=int, default=0,
                   help="with --partition tp/tp_fsdp: size of the 'model' mesh axis "
                        "(default: all of --devices)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("extract-style", help="mint a representative style vector")
    _add_common(p)
    p.add_argument("--out", type=str, default="checkpoints/style_vector.npz")
    p.add_argument("--n-batches", type=int, default=32)
    p.add_argument("--bank", default="sklearn", choices=("sklearn", "bead", "rbc"))
    p.add_argument("--domain", default=None, choices=("mnist", "polystyrene", "red_blood_cell"))
    p.add_argument("--mat-root", type=str, default=None,
                   help="average the encoder statistics over measured style-plane patches of "
                        "this .mat train tree instead of synthesized holograms (overrides --bank)")
    p.set_defaults(fn=cmd_extract_style)

    p = sub.add_parser("synth-bench", help="hologram-synthesis throughput")
    _add_common(p)
    p.add_argument("--batch-size", type=int, default=512)
    p.set_defaults(fn=cmd_synth_bench)

    p = sub.add_parser("sweep", help="distance-interpolation sweep montage")
    _add_common(p)
    p.add_argument("--style-distances", type=str, default="0.2,0.4,0.6,0.8")
    p.add_argument("--save-dir", type=str, default="output/sweep")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("autofocus", help="network-free refocus-sharpness distance search")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--asm-backend", choices=("auto", "torch", "cuda"), default="auto")
    p.add_argument("--golden", action="store_true",
                   help="run on the golden suite and report R² against the true distances")
    p.add_argument("--input", type=str, default=None,
                   help=".npz/.npy of (N, 1, H, W) intensity holograms")
    p.add_argument("--key", type=str, default="holo", help="array key inside the .npz")
    p.add_argument("--domain", type=str, default=None,
                   help="physics preset (mnist/polystyrene/red_blood_cell)")
    p.add_argument("--d-min", type=float, default=None)
    p.add_argument("--d-max", type=float, default=None)
    p.add_argument("--n-coarse", type=int, default=33)
    p.add_argument("--n-fine", type=int, default=17)
    p.add_argument("--metric", choices=("tamura", "grad", "sparsity"), default="tamura")
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--print-distances", action="store_true")
    p.set_defaults(fn=cmd_autofocus)

    p = sub.add_parser("stream", help="streaming .mat-tree inference (RBC mode)")
    _add_common(p)
    p.add_argument("--root", type=str, required=True, help=".mat dataset root")
    p.add_argument("--domain", type=str, default=None,
                   help="generic|polystyrene|tissue|red_blood_cell")
    p.add_argument("--image-set", type=str, default="test")
    p.add_argument("--distances", type=str, default=None, help="comma list, mm")
    p.add_argument("--style-distance", type=float, default=None,
                   help="style-plane distance in mm (default: the domain config's)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--refine", type=int, default=0, metavar="STEPS",
                   help="physics-consistent refinement steps per frame batch")
    p.add_argument("--devices", type=int, default=0,
                   help="batch data-parallel streaming over the first N cards")
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("serve", help="HTTP retrieval server (fixed batch shape; npz in/out)")
    _add_common(p)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument("--batch-size", type=int, default=None,
                   help="batch shape of the net; requests are padded/chunked "
                        "(default 32; fixed by the file with --artifact)")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bf16 conv path (default on)")
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--refine", type=int, default=0, metavar="STEPS")
    p.add_argument("--devices", type=int, default=0,
                   help="batch data-parallel serving over the first N cards")
    p.add_argument("--artifact", type=str, default=None, metavar="HSTX",
                   help="serve a frozen export artifact instead of a checkpoint "
                        "(see the 'export' command)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("export", help="freeze the retrieval program into one torch.export "
                                      "file (runs with torch alone, no model code)")
    _add_common(p)
    p.add_argument("--out", type=str, default="model.hstx")
    p.add_argument("--batch-size", type=int, default=32,
                   help="batch shape baked into the artifact")
    p.add_argument("--bf16", action="store_true", default=False, help="bf16 conv path")
    p.add_argument("--platforms", type=str, default="cpu,cuda",
                   help="comma-separated devices to export for (empty: this command's own)")
    p.add_argument("--style-distance", type=float, default=None,
                   help="refocus style plane in mm (default: the config's)")
    p.add_argument("--check", action="store_true",
                   help="re-load the written file and score it on the golden suite")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("doctor", help="devices and release inventory (JSON)")
    p.add_argument("--cpu", action="store_true", help="report the CPU as the device")
    p.set_defaults(fn=cmd_doctor)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    rc = args.fn(args)
    # eval returns its metrics for a caller in process; only an int is an
    # exit status
    return rc if isinstance(rc, int) else 0


if __name__ == "__main__":
    sys.exit(main())
