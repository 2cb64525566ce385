"""Quickstart: the paper in one file (counterpart of
`examples/quickstart.py`).

Trains a small GAN on a 2-D Gaussian mixture three ways — CPOAdam (full
precision), CPOAdam-GQ (8-bit, NO error feedback) and DQGAN (8-bit +
error feedback, the paper's method) — then prints mode coverage and the
synthetic Fréchet distance for each, with each run's strategy:

    PYTHONPATH=src python -m repro_torch.quickstart [--steps 1500] \\
        [--device cuda|cpu]

The full launcher takes the same strategies by preset name or JSON and
logs the wire bytes of each step:

    PYTHONPATH=src python -m repro_torch.launch.train --arch dcgan32 \\
        --smoke --device cpu --steps 50 --preset paper_dqgan
    PYTHONPATH=src python -m repro_torch.strategy   # list/validate presets
"""
import argparse
import sys

import torch

from repro_torch.gan_common import METHOD_STRATEGIES, train_mixture_gan


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.quickstart")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) needs a GPU; 'cpu' runs there")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available (pass "
                 "--device cpu to run on the CPU)")
    print(f"{'method':14s} {'modes':>6s} {'hq_frac':>8s} {'fid':>9s}  "
          f"strategy")
    results = {}
    for method in ("CPOAdam", "CPOAdam-GQ", "DQGAN"):
        final, _, _ = train_mixture_gan(method, steps=args.steps,
                                        device=args.device)
        strat = METHOD_STRATEGIES[method]
        print(f"{method:14s} {final['modes']:>5d}/8 {final['hq_frac']:>8.3f} "
              f"{final['fid']:>9.4f}  {strat.describe()}", flush=True)
        results[method] = final
    print("\nDQGAN (quantized + EF) should match CPOAdam's quality with "
          "1/4 the gradient bytes; CPOAdam-GQ (no EF) degrades.")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
