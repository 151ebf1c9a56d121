"""The f32 instances of the CRF and logZ kernels (rows 2, 3, 5, 6, 9 and
10) on seeded inputs, and the losses, logZ, their gradients and
make_trans through the port's ops with TAIYAKI_TPU_BF16_STREAMS unset
(the CRF on each route), saved so that two checkouts' outputs can be
compared bit for bit: a change that adds instances beside the f32 ones
(the bf16 score streams) must leave every f32 launch as it was.  Only
csrc/logz.cu and csrc/crf.cu are built.

From the root of each checkout, on the card:

    python3 probes/score_bitwise.py --save /tmp/score_new.pt
    (cd other_checkout && python3 /path/to/probes/score_bitwise.py \
        --save /tmp/score_old.pt)
    python3 probes/score_bitwise.py --compare /tmp/score_old.pt \
        /tmp/score_new.pt

--compare prints each output's name with "equal" or its largest |diff|,
and exits 1 unless every output is equal.
"""

import argparse
import os
import sys

import numpy as np

# the CRF's (T, B, L, mod columns): an odd L and T B L (4-byte copies, the
# lattice's last value alone), cat_mod, the training shape, each of the
# forward's bands past 2048 and 4096 positions; the streams alone past
# the fused kernels' 8192
CRF_SHAPES = ((37, 5, 13, 0), (60, 5, 45, 6), (800, 64, 512, 0),
              (300, 3, 2049, 3), (200, 2, 4097, 0), (120, 2, 9000, 0))
# logZ's (T, B, nbase): one segment, nbase 1 to 8, the basecall shape
LOGZ_SHAPES = ((17, 3, 4), (50, 5, 3), (41, 3, 1), (33, 3, 8),
               (1000, 128, 4))


def _crf_inputs(torch, dev, T, B, L, nmod, rng):
    from taiyaki_tpu_torch import flipflopfings
    from taiyaki_tpu_torch.ops import flipflop
    S = 40 + (1 + nmod if nmod else 0)
    lp = torch.from_numpy(rng.normal(size=(T, B, S)).astype(np.float32))
    seqlens = rng.integers(1, min(L, T) + 1, size=B).astype(np.int32)
    seqlens[0] = min(L, T)
    seqs = np.zeros((B, L), np.int32)
    for i in range(B):
        seqs[i, :seqlens[i]] = flipflopfings.flipflop_code(
            rng.integers(0, 4, size=seqlens[i]))
    stay, move = flipflop.make_seq_indices(torch.from_numpy(seqs), 4)
    mm = mf = None
    if nmod:
        mm = torch.from_numpy(rng.integers(40, S, size=(B, L - 1)).astype(
            np.int32))
        mf = torch.from_numpy(rng.uniform(0.1, 4.0, size=(B, L - 1)).astype(
            np.float32))
    idx = flipflop._lattice_inputs(stay, move, torch.from_numpy(seqlens), S,
                                   mm, mf)
    return lp.to(dev), [t.to(dev) for t in idx]


def outputs():
    """{name: tensor on the host} of every f32 CRF and logZ wrapper at
    CRF_SHAPES and LOGZ_SHAPES."""
    import torch
    sys.path.insert(0, os.getcwd())
    from taiyaki_tpu_torch.ops import cuda_lib
    cuda_lib.SOURCES = ("logz", "crf")
    from taiyaki_tpu_torch.ops import crf, flipflop, logz
    dev = torch.device("cuda", 0)
    out = {}
    for T, B, L, nmod in CRF_SHAPES:
        rng = np.random.default_rng(T + B + L + nmod)
        lp, (sidx, midx, mmidx, mfact, valid, last) = _crf_inputs(
            torch, dev, T, B, L, nmod, rng)
        key = "crf T{} B{} L{} mod{} ".format(T, B, L, nmod)
        res = {}
        if L <= crf.MAX_L:
            f, s, lat = crf.crf_fwd(lp, sidx, midx, mmidx, mfact, valid)
            g = crf.crf_bwd(lp, sidx, midx, mmidx, mfact, lat, valid, last)
            res.update({"fused fwd": f, "fused score": s,
                        "fused lattice": lat, "fused d lp": g})
        stay, move = flipflop._select_streams(
            lp, sidx, midx, *((mmidx, mfact) if nmod else (None, None)))
        f, s, lat = crf.crf_fwd_streams(stay, move, valid)
        ps, pm = crf.crf_bwd_posteriors(stay, move, lat, valid, last)
        g = crf.crf_grad_streams(stay, move, lat, valid, last, sidx, midx,
                                 mmidx, mfact, lp.shape[2])
        res.update({"streams fwd": f, "streams score": s,
                    "streams lattice": lat, "post stay": ps,
                    "post move": pm, "streams d lp": g})
        torch.cuda.synchronize()
        out.update({key + k: v.cpu() for k, v in res.items()})
    for T, B, nbase in LOGZ_SHAPES:
        rng = np.random.default_rng(T + B + nbase)
        S = 2 * nbase * (nbase + 1)
        s = torch.from_numpy((5.0 * np.tanh(rng.normal(size=(T, B, S))))
                             .astype(np.float32)).to(dev)
        f, z, lat = logz.logz_fwd(s)
        post = logz.logz_posteriors(s, lat)
        torch.cuda.synchronize()
        key = "logz T{} B{} nbase{} ".format(T, B, nbase)
        out.update({key + k: v.cpu() for k, v in (
            ("fwd", f), ("logZ", z), ("lattice", lat), ("posteriors",
                                                        post))})
    out.update(route_outputs(torch, dev))
    return out


def route_outputs(torch, dev):
    """The CRF loss (fused, and on the streams route), the cat_mod loss on
    the streams route, logZ, their gradients, and make_trans, with the
    switches unset but the route's."""
    from taiyaki_tpu_torch import flipflopfings
    from taiyaki_tpu_torch.ops import decode, flipflop
    for k in ("TAIYAKI_TPU_BF16_STREAMS", "TAIYAKI_TPU_F32_SCORES",
              "TAIYAKI_TPU_NO_SCORE_FUSE"):
        os.environ.pop(k, None)
    rng = np.random.default_rng(23)
    T, B, L = 300, 16, 61
    x = rng.normal(size=(T, B, 46)).astype(np.float32)
    seqlens = rng.integers(20, L + 1, size=B).astype(np.int32)
    seqs = np.zeros((B, L), np.int32)
    cats = np.zeros((B, L), np.int32)
    for i in range(B):
        bases = rng.integers(0, 4, size=seqlens[i])
        seqs[i, :seqlens[i]] = flipflopfings.flipflop_code(bases)
        cats[i, :seqlens[i]] = np.where(bases < 2, rng.integers(
            0, 2, size=seqlens[i]), 0)
    t_seqs, t_lens, t_cats = (torch.from_numpy(a).to(dev)
                              for a in (seqs, seqlens, cats))
    out = {}
    for route in ("fused", "streams"):
        if route == "streams":
            os.environ["TAIYAKI_TPU_NO_SCORE_FUSE"] = "1"
        tx = torch.from_numpy(x[:, :, :40]).to(dev).requires_grad_()
        loss = flipflop.crf_flipflop_loss(tx, t_seqs, t_lens, 1.5)
        (g,) = torch.autograd.grad(loss.sum(), tx)
        out["route crf loss " + route] = loss.detach()
        out["route crf d lp " + route] = g
    tx = torch.from_numpy(x).to(dev).requires_grad_()
    loss = flipflop.cat_mod_flipflop_loss(
        tx, t_seqs, t_lens, t_cats, np.array([0, 2, 4, 5, 6]),
        rng.uniform(0.5, 2.0, size=6).astype(np.float32), 1.5)
    (g,) = torch.autograd.grad(loss.sum(), tx)
    out.update({"route cat_mod loss streams": loss.detach(),
                "route cat_mod d lp streams": g})
    os.environ.pop("TAIYAKI_TPU_NO_SCORE_FUSE")
    ts = torch.from_numpy(x[:, :, :40]).to(dev).requires_grad_()
    z = flipflop.flipflop_logz(ts)
    (g,) = torch.autograd.grad(z.sum(), ts)
    out.update({"route logZ": z.detach(), "route d logZ": g,
                "route make_trans": decode.flipflop_make_trans(
                    ts.detach())})
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
