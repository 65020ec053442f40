"""Split the refine loss's distance gradient into its two terms, in each
package, against float64 (ROADMAP C.7).

The distance enters the angular-spectrum propagation twice: through the
transfer function ``exp(i d kz)`` and through the global phasor
``exp(i d 2 pi / lambda)``. The loss is a function of ``|field|``, so the
phasor's term is zero in exact arithmetic. This script recomputes each
package's fp32 gradient with the distance held fixed in one of the two
places (each package's own pad, kz grid, band limit and crop, composed as
its ``propagate`` composes them) and prints, as shares of the largest
float64 gradient: each term's distance from float64 (the transfer term
against the whole float64 gradient, the phasor term against zero) and the
sum's; and the distance from float64 of the gradient each package's
refine takes (the port's through the ``asm_dynamic`` op where no band limit
applies). The cases and their inputs are the tests' (``rbc`` and ``bead``
``tests/test_torch_domain.py``'s, the MNIST releases
``tests/test_torch_refine_distance.py``'s), the float64 reference the
latter's.

    JAX_PLATFORMS=cpu python scripts/port_exp_distance_gradient_terms.py [--cases rbc,bead,turbo,balanced]

Prints one JSON line a case (about 20 s each on the CPU).
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _test_module(name: str):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    return importlib.import_module(name)


def case_gradients(case):
    """(inputs, port physics, JAX physics, {port, jax, float64} distance
    gradients, the port's refine path) of a case, from the tests that hold
    it: ``tests/test_torch_domain.py`` for ``rbc`` and ``bead``,
    ``tests/test_torch_refine_distance.py`` for the MNIST releases."""
    refine = _test_module("test_torch_refine_distance")
    if case in ("rbc", "bead"):
        domain = _test_module("test_torch_domain")
        _, _, jcfg, cfg, _, _, _ = domain._release(case)
        inputs, physics, jphysics = domain._distance_stage(case), cfg.physics, jcfg.physics
        port, jgrad, _, _ = domain._distance_gradients(case)
        path = "propagate_torch"
    else:
        inputs, physics, jphysics = refine._distance_stage(case)
        whole = refine._distance_gradients(case)
        port, jgrad, path = whole["port"], whole["jax"], "asm_dynamic op"
    ref = refine.float64_gradients(inputs, physics)[0]
    return inputs, physics, jphysics, {"port": port, "jax": jgrad, "float64": ref}, path


def port_terms(inputs, physics):
    """The port's fp32 gradient (``propagate_torch``'s composition) with the
    distance live in the transfer function alone, then in the phasor alone."""
    import numpy as np
    import torch

    from style_transfer_based_holographic_imaging_tpu_torch.ops import asm

    amp, phase, d0, meas = (torch.tensor(np.asarray(v)) for v in inputs)
    terms = {}
    for live in ("transfer", "phasor"):
        d = d0.clone().requires_grad_(True)
        d_m = physics.to_metres(d)
        d_t, d_p = (d_m, d_m.detach()) if live == "transfer" else (d_m.detach(), d_m)
        obj = torch.complex(amp * torch.cos(phase), amp * torch.sin(phase))
        h, w = obj.shape[-2:]
        field = asm.pad_replicate(obj, h // 2, w // 2)
        kz, fy, fx = asm._make_grids(2 * h, 2 * w, physics.pixel_size, physics.wavelength, field.device)
        transfer = torch.complex(torch.cos(d_t * kz), torch.sin(d_t * kz))
        if physics.band_limit:
            d_abs = d_t.detach().abs()
            fy_lim = 1.0 / (physics.wavelength * torch.sqrt(
                (2.0 * d_abs / float(np.float32(2 * h * physics.pixel_size))) ** 2 + 1.0))
            fx_lim = 1.0 / (physics.wavelength * torch.sqrt(
                (2.0 * d_abs / float(np.float32(2 * w * physics.pixel_size))) ** 2 + 1.0))
            transfer = transfer * ((fy[:, None] <= fy_lim) & (fx[None, :] <= fx_lim)).to(transfer.dtype)
        out = torch.fft.ifft2(transfer * torch.fft.fft2(field))
        g = d_p * float(np.float32(2.0 * math.pi / physics.wavelength))
        out = asm.center_crop(out * torch.complex(torch.cos(g), torch.sin(g)), h, w)
        r = torch.sqrt(torch.clamp(out.abs() ** 2, min=0.0)) - meas
        (grad,) = torch.autograd.grad(torch.mean(r * r), d)
        terms[live] = grad.numpy().ravel().astype(np.float64)
    return terms


def jax_terms(inputs, physics):
    """The same for the JAX package's ``_propagate_xla`` composition, under
    ``jax.grad``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from style_transfer_based_holographic_imaging_tpu.ops import asm

    amp, phase, d0, meas = (jnp.asarray(v) for v in inputs)
    terms = {}
    for live in ("transfer", "phasor"):
        def loss(dist):
            d_m = physics.to_metres(dist)
            d_t, d_p = ((d_m, jax.lax.stop_gradient(d_m)) if live == "transfer"
                        else (jax.lax.stop_gradient(d_m), d_m))
            obj = jax.lax.complex(amp * jnp.cos(phase), amp * jnp.sin(phase))
            h, w = obj.shape[-2:]
            field = asm.pad_replicate(obj, h // 2, w // 2)
            kz = asm._kz_rel_grid(2 * h, 2 * w, pixel_size=physics.pixel_size, wavelength=physics.wavelength)
            transfer = jax.lax.complex(jnp.cos(d_t * kz), jnp.sin(d_t * kz))
            if physics.band_limit:
                fy = jnp.abs(jnp.fft.fftfreq(2 * h, d=physics.pixel_size).astype(jnp.float32))
                fx = jnp.abs(jnp.fft.fftfreq(2 * w, d=physics.pixel_size).astype(jnp.float32))
                d_abs = jnp.abs(d_t)
                fy_lim = 1.0 / (physics.wavelength * jnp.sqrt(
                    (2.0 * d_abs / jnp.float32(2 * h * physics.pixel_size)) ** 2 + 1.0))
                fx_lim = 1.0 / (physics.wavelength * jnp.sqrt(
                    (2.0 * d_abs / jnp.float32(2 * w * physics.pixel_size)) ** 2 + 1.0))
                transfer = transfer * ((fy[:, None] <= fy_lim) & (fx[None, :] <= fx_lim)).astype(transfer.dtype)
            out = jnp.fft.ifft2(transfer * jnp.fft.fft2(field))
            g = d_p * jnp.float32(2.0 * math.pi / physics.wavelength)
            out = asm.center_crop(out * jax.lax.complex(jnp.cos(g), jnp.sin(g)), h, w)
            r = jnp.sqrt(jnp.maximum(jnp.abs(out) ** 2, 0.0)) - meas
            return jnp.mean(r * r)

        terms[live] = np.asarray(jax.grad(loss)(d0)).ravel().astype(np.float64)
    return terms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="rbc,bead,turbo,balanced")
    ap.add_argument("--threads", type=int, default=2, help="torch's CPU threads (the tests' 2)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    torch.set_num_threads(args.threads)
    for case in args.cases.split(","):
        inputs, physics, jphysics, whole, path = case_gradients(case)
        ref = whole["float64"]
        scale = float(np.abs(ref).max())
        out = {"case": case, "float64_max": scale}
        for name, terms in (("port_propagate_torch", port_terms(inputs, physics)),
                            ("jax", jax_terms(inputs, jphysics))):
            out[name] = {
                "transfer_term_err": float(np.abs(terms["transfer"] - ref).max()) / scale,
                "phasor_term": float(np.abs(terms["phasor"]).max()) / scale,
                "sum_err": float(np.abs(terms["transfer"] + terms["phasor"] - ref).max()) / scale,
            }
        # The gradient of each package's refine on the card or the TPU:
        # band-limited, the port's is propagate_torch's autograd; otherwise
        # the asm_dynamic op's adjoint, which takes the phasor's term on the
        # image.
        out["refine_gradient_err"] = {
            "port": float(np.abs(whole["port"] - ref).max()) / scale, "port_path": path,
            "jax": float(np.abs(whole["jax"] - ref).max()) / scale,
        }
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
