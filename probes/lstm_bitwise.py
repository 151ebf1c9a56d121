"""The LSTM kernels' f32 instances (rows 1, 4, 11, 12, 14 and 15) and the
bf16 instances of its chains (rows 4, 11, 12 and 15 under the layers' and
the scans' mixed precision, on the bf16 forwards' residuals) on seeded
inputs, saved so that two checkouts' outputs can be compared bit for
bit: a change that adds instances beside the f32 ones, or moves how a
chain reads its inputs (the bf16 chains' ring), must leave every output
as it was.  Only csrc/lstm.cu is built.  probes/gru_bitwise.py does the
same for the GRU's rows.

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
# the bf16 chains: plans whose bf16 ring copies are 16 bytes (H=256), 8
# (H=96, C=8), 4 (H=100, C=2) and 8 on a ragged last rank (H=124, C=8)
BF16_SHAPES = ((50, 24, 64, 256), (40, 16, 96, 96), (20, 128, 32, 100),
               (12, 40, 32, 124))
# (x, h, dh) of the layers' bf16 chains: a later layer, the first layer,
# TAIYAKI_TPU_F32_GATES with F32_GRADS, F32_GATES alone
BF16_DTYPES = (("bf16", "bf16", "bf16"), ("f32", "bf16", "bf16"),
               ("f32", "f32", "f32"), ("f32", "f32", "bf16"))


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
    out.update(bf16_outputs(torch, lstm, dev))
    return out


def bf16_outputs(torch, lstm, dev):
    """{name: tensor on the host} of the bf16 chains at BF16_SHAPES, both
    directions: rows 4, 11 and 12 in each case of BF16_DTYPES, row 15
    with its gates and dh each bf16 or f32."""
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    bf = torch.bfloat16
    out = {}
    for T, B, D, H in BF16_SHAPES:
        rng = np.random.default_rng(T + B + D + H)

        def t(*shape, scale=1.0):
            return torch.from_numpy((scale * rng.normal(size=shape)).astype(
                np.float32)).to(dev)
        x, iW, b = t(T, B, D), t(4 * H, D, scale=D ** -0.5), t(4 * H)
        sW, dh = t(4 * H, H, scale=H ** -0.5), t(T, B, H)
        gx = torch.matmul(x, iW.t()) + b
        for rev in (False, True):
            key = "bf16 T{} B{} D{} H{} rev{} ".format(T, B, D, H, int(rev))
            res = {}
            for xd, hd, dhd in BF16_DTYPES:
                xx, d = x.to(dts[xd]), dh.to(dts[dhd])
                kw = dict(reverse=rev, h_dtype=dts[hd], res_dtype=bf)
                h, c, acts, tc = lstm.lstm_fwd(xx, iW, b, sW, emit="acts",
                                               **kw)
                pre = lstm.lstm_fwd(xx, iW, b, sW, emit="pre", **kw)[2]
                cp = lstm.prev_state(c, rev)
                case = "x {} h {} dh {} ".format(xd, hd, dhd)
                for name, got in (
                        ("acts", lstm.lstm_bwd_acts(d, acts, tc, cp, h, xx,
                                                    sW, iW, reverse=rev)),
                        ("fusedw", lstm.lstm_bwd_fusedw(d, pre, c, cp, h, xx,
                                                        sW, iW,
                                                        reverse=rev)),
                        ("recompute", lstm.lstm_bwd_recompute(
                            d, c, h, xx, sW, iW, b, reverse=rev))):
                    for k, v in zip(("d_x", "d_sW", "d_iW", "d_b"), got):
                        res["{}{} {}".format(case, name, k)] = v
            for gd in ("bf16", "f32"):
                _, cs, ps = lstm.lstm_scan_fwd(gx.to(dts[gd]), sW,
                                               reverse=rev, residuals=True,
                                               res_dtype=bf)
                for dd in ("bf16", "f32"):
                    for k, v in zip(("dpre", "d_x"), lstm.lstm_scan_bwd(
                            dh.to(dts[dd]), ps, cs, lstm.prev_state(cs, rev),
                            sW, reverse=rev, iW=iW)):
                        res["scan gx {} dh {} {}".format(gd, dd, k)] = v
            torch.cuda.synchronize()
            out.update({key + k: v.cpu() for k, v in res.items()})
    return out


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gru_bitwise
    sys.exit(gru_bitwise.main(outputs, __doc__))
