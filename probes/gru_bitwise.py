"""The GRU kernels' f32 instances (rows 7, 8, 13, 16 and 17) and the bf16
instances of its chains (rows 8, 13 and 17 under the layers' and the
scans' mixed precision, on the bf16 forwards' residuals) on seeded
inputs, saved so that two checkouts' outputs can be compared bit for
bit: a change that adds instances beside the f32 ones, or moves how a
chain reads its inputs (the bf16 chains' ring), must leave every output
as it was.  Only csrc/gru.cu is built.

From the root of each checkout, on the card:

    python3 probes/gru_bitwise.py --save /tmp/gru_new.pt
    (cd other_checkout && python3 /path/to/probes/gru_bitwise.py \
        --save /tmp/gru_old.pt)
    python3 probes/gru_bitwise.py --compare /tmp/gru_old.pt /tmp/gru_new.pt

--compare prints each output's name with "equal" or its largest |diff|,
and exits 1 unless every output is equal.
"""

import argparse
import os
import sys

import numpy as np

# (T, B, D, H): simt GEMMs, the mGru width, train_abinitio's, the L2
# instance
SHAPES = ((37, 13, 7, 16), (50, 24, 64, 256), (40, 16, 96, 96),
          (20, 16, 64, 512))
# the bf16 chains: plans whose bf16 ring copies are 16 bytes (H=256), 8
# (H=96, C=8), 4 (H=100, C=2) and 8 on a ragged last rank (H=124, C=8);
# a cluster of 16 at H=512
BF16_SHAPES = ((50, 24, 64, 256), (40, 16, 96, 96), (20, 128, 32, 100),
               (12, 40, 32, 124), (20, 16, 64, 512))
# (x, h, dh) of the layers' bf16 chains, as probes/lstm_bitwise.py's
BF16_DTYPES = (("bf16", "bf16", "bf16"), ("f32", "bf16", "bf16"),
               ("f32", "f32", "f32"), ("f32", "f32", "bf16"))


def outputs():
    """{name: tensor on the host} of every f32 GRU wrapper at SHAPES, both
    directions."""
    import torch
    sys.path.insert(0, os.getcwd())
    from taiyaki_tpu_torch.ops import cuda_lib
    cuda_lib.SOURCES = ("gru",)
    from taiyaki_tpu_torch.ops import gru
    dev = torch.device("cuda", 0)
    out = {}
    for T, B, D, H in SHAPES:
        rng = np.random.default_rng(T + B + D + H)

        def t(*shape, scale=1.0):
            return torch.from_numpy((scale * rng.normal(size=shape)).astype(
                np.float32)).to(dev)
        x, iW, b = t(T, B, D), t(3 * H, D, scale=D ** -0.5), t(3 * H)
        sW, dh = t(3 * H, H, scale=H ** -0.5), t(T, B, H)
        for rev in (False, True):
            key = "T{} B{} D{} H{} rev{} ".format(T, B, D, H, int(rev))
            h = gru.gru_fwd(x, iW, b, sW, reverse=rev)
            hr, gh, gx = gru.gru_fwd(x, iW, b, sW, reverse=rev,
                                     emit_residuals=True)
            res = {"gru_fwd h": h, "gru_fwd(res) h": hr, "gh": gh, "gx": gx}
            for k, v in zip(("d_x", "d_sW", "d_iW", "d_b"),
                            gru.gru_bwd_recompute(dh, h, x, sW, iW, b,
                                                  reverse=rev)):
                res["recompute " + k] = v
            hp = gru.prev_state(h, rev)
            for k, v in zip(("d_x", "d_sW", "d_iW", "d_b"),
                            gru.gru_bwd_fusedw(dh, gx, gh, hp, x, sW, iW,
                                               reverse=rev)):
                res["fusedw " + k] = v
            hs, ghs = gru.gru_scan_fwd(gx, sW, reverse=rev, residuals=True)
            res["scan h"], res["scan gh"] = hs, ghs
            for k, v in zip(("dgx", "dgh", "d_x"), gru.gru_scan_bwd(
                    dh, gx, ghs, hp, sW, reverse=rev, iW=iW)):
                res["scan " + k] = v
            torch.cuda.synchronize()
            out.update({key + k: v.cpu() for k, v in res.items()})
    out.update(bf16_outputs(torch, gru, dev))
    return out


def bf16_outputs(torch, gru, dev):
    """{name: tensor on the host} of the bf16 chains at BF16_SHAPES, both
    directions: rows 8 (on its f32 instance where every stream is f32)
    and 13 in each case of BF16_DTYPES, row 17 with gates_x and dh each
    bf16 or f32."""
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    bf = torch.bfloat16
    out = {}
    for T, B, D, H in BF16_SHAPES:
        rng = np.random.default_rng(T + B + D + H)

        def t(*shape, scale=1.0):
            return torch.from_numpy((scale * rng.normal(size=shape)).astype(
                np.float32)).to(dev)
        x, iW, b = t(T, B, D), t(3 * H, D, scale=D ** -0.5), t(3 * H)
        sW, dh = t(3 * H, H, scale=H ** -0.5), t(T, B, H)
        gx32 = torch.matmul(x, iW.t()) + b
        for rev in (False, True):
            key = "bf16 T{} B{} D{} H{} rev{} ".format(T, B, D, H, int(rev))
            res = {}
            for xd, hd, dhd in BF16_DTYPES:
                xx, d = x.to(dts[xd]), dh.to(dts[dhd])
                h, gh, gx = gru.gru_fwd(xx, iW, b, sW, reverse=rev,
                                        emit_residuals=True,
                                        h_dtype=dts[hd], res_dtype=bf)
                case = "x {} h {} dh {} ".format(xd, hd, dhd)
                for name, got in (
                        ("recompute", gru.gru_bwd_recompute(
                            d, h, xx, sW, iW, b, reverse=rev)),
                        ("fusedw", gru.gru_bwd_fusedw(
                            d, gx, gh, gru.prev_state(h, rev), xx, sW, iW,
                            reverse=rev))):
                    for k, v in zip(("d_x", "d_sW", "d_iW", "d_b"), got):
                        res["{}{} {}".format(case, name, k)] = v
            for gd in ("bf16", "f32"):
                g = gx32.to(dts[gd])
                hs, ghs = gru.gru_scan_fwd(g, sW, reverse=rev,
                                           residuals=True, res_dtype=bf)
                for dd in ("bf16", "f32"):
                    for k, v in zip(("dgx", "dgh", "d_x"), gru.gru_scan_bwd(
                            dh.to(dts[dd]), g, ghs, gru.prev_state(hs, rev),
                            sW, reverse=rev, iW=iW)):
                        res["scan gx {} dh {} {}".format(gd, dd, k)] = v
            torch.cuda.synchronize()
            out.update({key + k: v.cpu() for k, v in res.items()})
    return out


def main(outputs=outputs, doc=__doc__):
    """--save the `outputs()` of this checkout, or --compare two saved
    sets (probes/lstm_bitwise.py runs it on the LSTM's)."""
    parser = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    parser.add_argument("--save", metavar="PATH")
    parser.add_argument("--compare", nargs=2, metavar="PATH")
    args = parser.parse_args()
    import torch
    if args.save:
        torch.save(outputs(), args.save)
        return 0
    a, b = (torch.load(p) for p in args.compare)
    ok = sorted(a) == sorted(b)
    for k in sorted(a):
        same = k in b and torch.equal(a[k], b[k])
        ok = ok and same
        print("{}: {}".format(k, "equal" if same else (
            (a[k] - b[k]).abs().max().item() if k in b else "missing")))
    print("all {} outputs bitwise equal: {}".format(len(a), ok))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
