"""The squiggle match cost and its gradient (ops/squiggle.py) on the card
against the CPU, at train_squiggle's longest signals (4352 samples), on
seeded random parameters: the relative error of the costs and the
gradient's largest error over its largest entry, with each device's
seconds.  Phase 13a of chip_smoke.py holds the same comparison to 1e-4
on a trained net's parameters.

From the root of a checkout (or name one as the argument), on the card:

    python3 probes/squiggle_card.py [CHECKOUT]
"""

import os
import sys
import time

import numpy as np


def main():
    root = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
    sys.path.insert(0, root)
    import torch
    from taiyaki_tpu_torch.ops.squiggle import squiggle_match_cost
    rng = np.random.default_rng(0)
    npos, nbatch, nsample = 500, 8, 4352
    # the spread of the log scales: sharper emissions round more
    for spread in (0.3, 0.5):
        params = rng.normal(size=(npos, nbatch, 3)).astype(np.float32)
        params[:, :, 1] = -np.abs(params[:, :, 1]) * spread
        signals = rng.normal(size=(nsample, nbatch)).astype(np.float32)
        siglens = rng.integers(nsample // 2, nsample + 1,
                               size=nbatch).astype(np.int32)
        siglens[0] = nsample
        out = []
        for dev in ("cuda", "cpu"):
            p = torch.tensor(params, device=dev, requires_grad=True)
            t0 = time.perf_counter()
            cost = squiggle_match_cost(p, torch.tensor(signals, device=dev),
                                       torch.tensor(siglens, device=dev),
                                       0.05)
            (grad,) = torch.autograd.grad(cost.sum(), p)
            out.append((cost.detach().cpu(), grad.cpu(),
                        time.perf_counter() - t0))
        (cc, gc, tc), (cp, gp, tp) = out
        print("{}: log-scale spread {}: costs' relative err {:.3g}, "
              "gradient err {:.3g} of its largest; card {:.2f} s, CPU "
              "{:.2f} s".format(
                  root, spread, ((cc - cp).abs() / cp.abs()).max().item(),
                  ((gc - gp).abs().max() / gp.abs().max()).item(), tc, tp),
              flush=True)


if __name__ == "__main__":
    main()
