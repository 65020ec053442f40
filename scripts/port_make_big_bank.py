"""Build a large offline digit bank with the PyTorch port (no JAX).

The same bank as ``scripts/make_big_bank.py``: the golden-train digits
(0..49) and sklearn's digits widened by affine / strong-elastic /
stroke-thickness morphs (``data/synth.morphed_digit_bank``, the JAX
package's ``jax.random`` stream reproduced in numpy), ``--golden-frac`` of
the bank golden-derived, shuffled by numpy's ``default_rng(seed)``, written
as a uint8 ``.npz`` for ``cli train --digit-bank``. The held-out half of the
golden suite stays unseen. The morphs render on the card unless ``--cpu``;
the sklearn digits need scikit-learn.

Usage:
    python scripts/port_make_big_bank.py --n 20000 --out banks/big_bank_20k.npz [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000, help="total bank size")
    ap.add_argument("--golden-frac", type=float, default=0.5,
                    help="share of the bank derived from golden-train digits")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="banks/big_bank_20k.npz")
    ap.add_argument("--cpu", action="store_true", help="render the morphs on the CPU")
    args = ap.parse_args()

    import numpy as np

    from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
    from style_transfer_based_holographic_imaging_tpu_torch.data.synth import (
        GOLDEN_TRAIN_DIGITS,
        golden_digit_bank,
        morphed_digit_bank,
        sklearn_digit_bank,
    )

    device = "cpu" if args.cpu else "cuda"
    n_golden = int(round(args.n * args.golden_frac))
    n_sklearn = args.n - n_golden

    golden = golden_digit_bank(load_golden_suite(), subset=GOLDEN_TRAIN_DIGITS)
    sk = sklearn_digit_bank()
    print(f"base shapes: sklearn {len(sk)}, golden-train {len(golden)}")

    big_golden = morphed_digit_bank(golden, n_golden, seed=args.seed, device=device)
    big_sklearn = morphed_digit_bank(sk, n_sklearn, seed=args.seed + 1, device=device)
    bank = np.concatenate([big_golden, big_sklearn], axis=0)
    rng = np.random.default_rng(args.seed)
    rng.shuffle(bank, axis=0)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, bank=np.round(bank * 255.0).astype(np.uint8))
    print(f"wrote {args.out}: {bank.shape[0]} digits ({n_golden} golden-derived, "
          f"{n_sklearn} sklearn-derived), {os.path.getsize(args.out) / 1e6:.1f} MB")


if __name__ == "__main__":
    main()
