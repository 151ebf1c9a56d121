"""chip_smoke.py's phase 2 (every kernel against its twin) one check at a
time, each with its seconds, then phase 19 (the scans' bf16 instances,
19a, and the scans under TAIYAKI_TPU_BF16_STREAMS=1, 19b): where phase
2's time goes, to choose what to cut when a phase is added, and phase 19
alone.  From the root of a checkout, on the card (~6 min with the build):

    python3 probes/smoke_phase_times.py

Prints "TIME <check> <seconds>" a check, "PHASE2 TOTAL", and phase 19's
lines; stops at the first failed check, as chip_smoke.py does.
"""

import json
import os
import sys
import time

import numpy as np


def main():
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
