"""The LSTM kernels' f32 instances (rows 1, 4, 11, 12, 14 and 15) on
seeded inputs, saved so that two checkouts' outputs can be compared bit
for bit: a change that adds instances beside the f32 ones (the scans'
bf16 streams) must leave every f32 launch as it was.  Only csrc/lstm.cu
is built.  probes/gru_bitwise.py does the same for the GRU's rows.

From the root of each checkout, on the card:

    python3 probes/lstm_bitwise.py --save /tmp/lstm_new.pt
    (cd other_checkout && python3 /path/to/probes/lstm_bitwise.py \\
        --save /tmp/lstm_old.pt)
    python3 probes/lstm_bitwise.py --compare /tmp/lstm_old.pt /tmp/lstm_new.pt

--compare prints each output's name with "equal" or its largest |diff|,
and exits 1 unless every output is equal.
"""

import os
import sys

import numpy as np

# (T, B, D, H): simt GEMMs, the mLstm width, the L2 instance
SHAPES = ((37, 13, 7, 16), (50, 24, 64, 256), (20, 16, 64, 512))


def outputs():
    """{name: tensor on the host} of every f32 LSTM wrapper at SHAPES, both
    directions."""
    import torch
    sys.path.insert(0, os.getcwd())
    from taiyaki_tpu_torch.ops import cuda_lib
    cuda_lib.SOURCES = ("lstm",)
    from taiyaki_tpu_torch.ops import lstm
    dev = torch.device("cuda", 0)
    out = {}
    for T, B, D, H in SHAPES:
        rng = np.random.default_rng(T + B + D + H)

        def t(*shape, scale=1.0):
            return torch.from_numpy((scale * rng.normal(size=shape)).astype(
                np.float32)).to(dev)
        x, iW, b = t(T, B, D), t(4 * H, D, scale=D ** -0.5), t(4 * H)
        sW, dh = t(4 * H, H, scale=H ** -0.5), t(T, B, H)
        for rev in (False, True):
            key = "T{} B{} D{} H{} rev{} ".format(T, B, D, H, int(rev))
            res = {"lstm_fwd h": lstm.lstm_fwd(x, iW, b, sW, reverse=rev)}
            h, c, acts, tc = lstm.lstm_fwd(x, iW, b, sW, reverse=rev,
                                           emit="acts")
            pre = lstm.lstm_fwd(x, iW, b, sW, reverse=rev, emit="pre")[2]
            res.update({"acts h": h, "c": c, "acts": acts, "tc": tc,
                        "pre": pre})
            cp = lstm.prev_state(c, rev)
            for name, got in (
                    ("acts", lstm.lstm_bwd_acts(dh, acts, tc, cp, h, x, sW,
                                                iW, reverse=rev)),
                    ("fusedw", lstm.lstm_bwd_fusedw(dh, pre, c, cp, h, x, sW,
                                                    iW, reverse=rev)),
                    ("recompute", lstm.lstm_bwd_recompute(
                        dh, c, h, x, sW, iW, b, reverse=rev))):
                for k, v in zip(("d_x", "d_sW", "d_iW", "d_b"), got):
                    res["{} {}".format(name, k)] = v
            gx = torch.matmul(x, iW.t()) + b
            hs, cs, ps = lstm.lstm_scan_fwd(gx, sW, reverse=rev,
                                            residuals=True)
            res.update({"scan h": hs, "scan c": cs, "scan pre": ps,
                        "scan h alone": lstm.lstm_scan_fwd(gx, sW,
                                                           reverse=rev)})
            for k, v in zip(("dpre", "d_x"), lstm.lstm_scan_bwd(
                    dh, ps, cs, lstm.prev_state(cs, rev), sW, reverse=rev,
                    iW=iW)):
                res["scan " + k] = v
            torch.cuda.synchronize()
            out.update({key + k: v.cpu() for k, v in res.items()})
    return out


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gru_bitwise
    sys.exit(gru_bitwise.main(outputs, __doc__))
