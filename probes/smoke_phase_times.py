"""chip_smoke.py's phase 2 (every kernel against its twin) one check at a
time, each with its seconds, then phase 19 (the scans' bf16 instances,
19a, and the scans under TAIYAKI_TPU_BF16_STREAMS=1, 19b): where phase
2's time goes, to choose what to cut when a phase is added, and phase 19
alone.  With --phase 20, phase 20 alone instead (the score-stream
route's bf16 instances, 20a; its steps under the switch, 20b; the
basecall under the switch, 20c, on a seeded mLstm checkpoint and 9
synthetic reads called first in f32).  From the root of a checkout, on
the card (~6 min with the build; ~4 min with --phase 20):

    python3 probes/smoke_phase_times.py [--phase 20]

Prints "TIME <check> <seconds>" a check, "PHASE2 TOTAL", and phase 19's
lines (or phase 20's); stops at the first failed check, as chip_smoke.py
does.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np


def phase20(torch, cs, dev, rng, timed):
    """Phase 20's three checks, each timed, with the counters run() gives
    them."""
    from taiyaki_tpu_torch.cli import basecall
    from taiyaki_tpu_torch.ops import crf, gemm, logz, lstm
    rows = timed("20a", cs.check_bf16_stream_kernels, torch, dev, rng)
    print(json.dumps(rows), flush=True)
    f32 = {"crf_fwd": crf.crf_fwd, "crf_bwd": crf.crf_bwd,
           "crf_fwd_streams": crf.crf_fwd_streams,
           "crf_grad_streams": crf.crf_grad_streams,
           "logz_fwd": logz.logz_fwd, "logz_posteriors": logz.logz_posteriors}
    inst = {name: getattr(f32[base], name[:-1].split("[")[1])
            for name, base, _ in cs.BF16_ROWS
            if name in cs.SCORE_BF16 + cs.STREAM_BF16}
    print(json.dumps(timed("20b", cs.bf16_stream_steps, torch, dev, 1,
                           dict(f32, **inst))[1]), flush=True)
    work = tempfile.mkdtemp(prefix="phase20_")
    try:
        ckpt = cs.seeded_checkpoint(work, 1, cs.MLSTM)
        reads = os.path.join(work, "reads_mLstm")
        os.makedirs(reads)
        cs.write_reads(os.path.join(reads, "reads.fast5"),
                       ["read{}".format(i) for i in range(9)],
                       [20000 + 4000 * i for i in range(9)], rng)
        basecall.main(["--output", os.path.join(work, "mLstm.fa"),
                       "--quiet", reads, ckpt])
        counters = {"lstm_fwd": lstm.lstm_fwd,
                    "gate_gemm": gemm.gate_gemm,
                    "logz_fwd": logz.logz_fwd,
                    "logz_posteriors": logz.logz_posteriors,
                    "logz_fwd[mixed]": inst["logz_fwd[mixed]"],
                    "logz_posteriors[mixed]": inst["logz_posteriors[mixed]"]}
        idle = {k: inst[k] for k in cs.SCORE_BF16}
        print(json.dumps(timed("20c", cs.bf16_stream_basecall, torch, dev,
                               work, ckpt, reads, counters, idle)[1]),
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phase", type=int, choices=(2, 20), default=2,
                        help="2: phase 2's checks then phase 19; 20: "
                        "phase 20 alone")
    args = parser.parse_args()
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from taiyaki_tpu_torch.ops import cuda_lib, gemm, gru, lstm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.build_all()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    times = {}

    def timed(name, fn, *args, **kw):
        t0 = time.time()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        times[name] = time.time() - t0
        print("TIME", name, round(times[name], 1), flush=True)
        return out

    if args.phase == 20:
        phase20(torch, cs, dev, rng, timed)
        return 0

    timed("check_lstm", cs.check_lstm, torch, dev, rng)
    timed("check_logz", cs.check_logz, torch, dev, rng)
    timed("check_lstm_train", cs.check_lstm_train, torch, dev, rng)
    timed("check_crf", cs.check_crf, torch, dev, rng)
    timed("check_crf long", cs.check_crf, torch, dev, rng, cs.LT, cs.LB,
          cs.LL, g_tol=3e-4)
    timed("check_gru", cs.check_gru, torch, dev, rng)
    timed("check_gru_train", cs.check_gru_train, torch, dev, rng)
    timed("check_crf_streams", cs.check_crf_streams, torch, dev, rng)
    timed("check_crf SC", cs.check_crf, torch, dev, rng, s=cs.SC)
    timed("check_crf_streams TRAIN_L", cs.check_crf_streams, torch, dev, rng,
          tl=cs.TRAIN_L)
    timed("check_crf_streams TL-3", cs.check_crf_streams, torch, dev, rng,
          tl=cs.TL - 3)
    scan_rows = timed("check_scan", cs.check_scan, torch, dev, rng)
    timed("check_l2_512", cs.check_l2_512, torch, dev, rng)
    timed("check_defaults_fwd", cs.check_defaults_fwd, torch, dev, rng)
    timed("check_bwd_shapes", cs.check_bwd_shapes, torch, dev, rng)
    timed("check_gemms", cs.check_gemms, torch, dev)
    timed("check_offset_views", cs.check_offset_views, torch, dev, rng)
    print("PHASE2 TOTAL", round(sum(times.values()), 1), json.dumps(
        {k: round(v, 1) for k, v in times.items()}), flush=True)
    rows = timed("19a", cs.check_bf16_scan_kernels, torch, dev, rng,
                 {r["name"]: r for r in scan_rows})
    print(json.dumps(rows))
    counters = {}
    for name in ("lstm_scan_fwd", "lstm_scan_bwd", "gru_scan_fwd",
                 "gru_scan_bwd"):
        fn = getattr(lstm if name.startswith("lstm") else gru, name)
        counters.update({name: fn, name + "[cluster]":
                         fn.by_instance["cluster"], name + "[bf16]": fn.bf16})
    counters.update({"atb_gemm": gemm.atb_gemm,
                     "atb_gemm[tc]": gemm.atb_gemm.by_instance["tc"],
                     "atb_gemm[bf16]": gemm.atb_gemm.bf16})
    print(json.dumps(timed("19b", cs.bf16_scan_path, torch, dev, rng,
                           counters)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
