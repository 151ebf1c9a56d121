#!/usr/bin/env python3
"""The forward recurrences' launch plans against the card (calibration of
taiyaki_tpu_torch/ops/rnn_plan.py's cost model).  On one NVIDIA card, from
the root of a checkout:

    python3 probes/rec_plans.py [--steps 300] [--sample 40]

For each of the repo's shapes (the LSTM and GRU at H=256, B=128 and 256;
the GRU at H=96, B=128; the LSTM at H=384, B=341) it times the layer
forward (`lstm_fwd` / `gru_fwd`, the gate GEMM included; CUDA events,
mean of 2 calls after one warm-up) on the plan `rec_plan` chooses, on a
seeded sample of the other cluster plans with the same number of waves,
and on the forced L2 instance, and prints them beside the model's cycles a
step.  Random weights from numpy seed 0; f32, TF32 off.
"""

import argparse
import os
import random
import sys

import numpy as np

SHAPES = (("lstm", 256, 128), ("lstm", 256, 256), ("gru", 96, 128),
          ("gru", 256, 128), ("gru", 256, 256), ("lstm", 384, 341))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--sample", type=int, default=40)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("rec_plans.py: no CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from taiyaki_tpu_torch.ops import gru, lstm, rnn_plan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    per_wave = lstm.clusters_per_wave(torch.cuda.current_device())
    print("clusters a wave of {} ranks: {}".format(
        rnn_plan.CLUSTER_SIZES, per_wave), flush=True)

    def ms(fn, reps=2):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def forced(fwd, plan, *a):
        """fwd on `plan`, whatever rec_plan would choose."""
        chosen = rnn_plan.rec_plan
        rnn_plan.rec_plan = lambda *_a, **_k: plan
        try:
            return fwd(*a)
        finally:
            rnn_plan.rec_plan = chosen

    for cell, H, B in SHAPES:
        G = 4 if cell == "lstm" else 3
        fwd = lstm.lstm_fwd if cell == "lstm" else gru.gru_fwd
        rng = np.random.default_rng(0)
        x, iW, b, sW = (torch.from_numpy(a.astype(np.float32)).to(dev)
                        for a in (rng.normal(size=(args.steps, B, H)),
                                  rng.normal(size=(G * H, H)) / np.sqrt(H),
                                  0.5 * rng.normal(size=G * H),
                                  rng.normal(size=(G * H, H)) / np.sqrt(H)))
        best = rnn_plan.rec_plan(G, H, B, per_wave)
        nwave = rnn_plan.waves(best.C, B, best.BT, per_wave)
        others = [p for p in rnn_plan.cluster_plans(G, H)
                  if per_wave[rnn_plan.CLUSTER_SIZES.index(p[0])]
                  and rnn_plan.waves(p[0], B, p[1], per_wave) == nwave
                  and p != tuple(best[1:5])]
        random.seed(0)
        sample = random.sample(others, min(args.sample, len(others)))
        rows = []
        for C, BT, RB, KS in [tuple(best[1:5])] + sample:
            plan = rnn_plan.Plan("cluster", C, BT, RB, KS,
                                 rnn_plan.cluster_smem(H, C, BT, KS))
            rows.append((ms(lambda: forced(fwd, plan, x, iW, b, sW)),
                         (C, BT, RB, KS),
                         rnn_plan.step_cycles(G, H, C, BT, RB, KS)))
        l2 = ms(lambda: fwd(x, iW, b, sW, instance="l2"))
        print("{} H={} B={} T={}: plan {} {:.3f} ms ({} model cycles a "
              "step); l2 {:.3f} ms; sample of {} other plans with {} "
              "wave(s), fastest first (ms, (C, BT, RB, KS), model cycles): "
              "{}".format(cell, H, B, args.steps, tuple(best[1:5]),
                          rows[0][0], rows[0][2], l2, len(sample), nwave[0],
                          sorted((round(r[0], 3), r[1], r[2])
                                 for r in rows[1:])), flush=True)


if __name__ == "__main__":
    main()
