"""The GRU kernels' f32 instances (rows 7, 8, 13, 16 and 17) on seeded
inputs, saved so that two checkouts' outputs can be compared bit for
bit: a change that adds instances beside the f32 ones (the bf16 streams)
must leave every f32 launch as it was.  Only csrc/gru.cu is built.

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
