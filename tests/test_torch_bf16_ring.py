"""The fill of the backward chains' bf16 ring (csrc/rec_cluster.cuh, "The
bf16 chains' ring"), on the CPU: its Python restatement,
`rnn_plan.ring_copies` (the list of cp.async copies as `rec_ring_word`
deals them) and `rnn_plan.ring_width` (the width each copy takes), at the
repo's widths (16, 96, 256, 384), at H=100 and at widths whose last rank
is ragged (H % C != 0), on batches that are not a multiple of the tile,
at the first, a middle and the last step of both directions, for every
case of the LSTM's and the GRU's words (bf16 or f32 dh, h_prev and gx;
the recompute's f32 gates; c_prev and h_prev one step away).  Checked:
every (word, row, unit < H) of the tile is written exactly once, from
its own source unit; no copy reads past its row's units or its stream;
zero-fill exactly where c_prev or h_prev falls outside [0, T) and where a
unit is past H; rows past B are not written; each copy is as wide as the
alignment allows; the copies are dealt evenly over the threads.  Then the
plans of the bf16 instances (`bwd_plan` with `ring16`) and the wrappers'
copy of a misaligned view (`ring_ready`).
"""

import collections

import pytest
import torch

from taiyaki_tpu_torch.ops import rnn_plan

H100 = (132, 66, 30, 15, 7)
RW = rnn_plan.RingWord
# stream bases: 16-byte aligned, far apart
BASE = 1 << 24


def _lstm_words(H, dh_es, gates_es, cshift):
    """The LSTM bf16 instance's seven words: four gates (bf16, or the
    recompute's f32 pre), tc or c, c_prev (bf16) and dh."""
    return ([RW(gates_es, 4 * H, g * H, 0, BASE) for g in range(4)]
            + [RW(2, H, 0, 0, 2 * BASE), RW(2, H, 0, cshift, 3 * BASE),
               RW(dh_es, H, 0, 0, 4 * BASE)])


def _gru_words(H, dh_es, hp_es, gx_es, gh_es, hshift):
    """The GRU bf16 instance's eight words: gx and gh (3 each), h_prev and
    dh."""
    return ([RW(gx_es, 3 * H, q * H, 0, BASE) for q in range(3)]
            + [RW(gh_es, 3 * H, q * H, 0, 2 * BASE) for q in range(3)]
            + [RW(hp_es, H, 0, hshift, 3 * BASE),
               RW(dh_es, H, 0, 0, 4 * BASE)])


# (name, words(H, shift)): the bf16 instances' cases
CASES = [
    ("lstm stored", lambda H, s: _lstm_words(H, 2, 2, 0)),
    ("lstm stored, dh f32", lambda H, s: _lstm_words(H, 4, 2, 0)),
    ("lstm recompute", lambda H, s: _lstm_words(H, 2, 4, s)),
    ("lstm recompute, dh f32", lambda H, s: _lstm_words(H, 4, 4, s)),
    ("gru recompute", lambda H, s: _gru_words(H, 2, 2, 4, 4, s)),
    ("gru recompute, h f32", lambda H, s: _gru_words(H, 2, 4, 4, 4, s)),
    ("gru stored", lambda H, s: _gru_words(H, 2, 2, 2, 2, 0)),
    ("gru scan, gx and dh f32", lambda H, s: _gru_words(H, 4, 2, 4, 2, 0)),
]
# H with a plan of ranks whose last is ragged: 30 (C=4, U=8), 124 (C=16,
# U=8), 100 (C=2, U=50: even)
WIDTHS = [16, 96, 100, 256, 384, 30, 124]
T = 7


def _plans(gates, H):
    """A few cluster plans of H for the bf16 instance: the ones bwd_plan
    takes at the repo's batches, and one of each other cluster size."""
    out = {rnn_plan.bwd_plan(gates, H, B, H100, ring16=True)
           for B in (8, 64, 256)}
    out = {(p.C, p.BT, p.RB, p.KS) for p in out if p.instance == "cluster"}
    by_c = {}
    for plan in rnn_plan.bwd_cluster_plans(gates, H, True):
        by_c.setdefault(plan[0], plan)
    return sorted(out | set(by_c.values()))


def _cases():
    for name, words in CASES:
        gates = 4 if name.startswith("lstm") else 3
        for H in WIDTHS:
            for plan in _plans(gates, H):
                yield name, words, gates, H, plan


def _check_fill(words, H, C, BT, B, t, threads):
    """Every check of the module's docstring on one step of one tile
    layout, for every rank and the first and last tile."""
    U = -(-H // C)
    for q in range(C):
        u0 = q * U
        nu = min(U, H - u0)
        for tile in sorted({0, (B - 1) // BT}):
            b0 = tile * BT
            nrow = min(BT, B - b0)
            copies = rnn_plan.ring_copies(words, T, B, t, b0, nrow, BT, H, U,
                                          u0, threads)
            written = collections.Counter()
            for x, w, dst, src, W, nbytes in copies:
                wd = words[w]
                es = wd.es
                region = 4 * BT * U * w
                # the widest width the alignment allows
                a = es * H | es * U | wd.base
                assert W == rnn_plan.ring_width(es, H, U)
                assert W in (4, 8, 16) and a % W == 0
                assert W == 16 or a % (2 * W) != 0
                assert dst % W == 0 and (src is None or src % W == 0)
                assert region <= dst < region + nrow * U * es
                row, ub = divmod(dst - region, U * es)
                tr = t + wd.shift
                ok = 0 <= tr < T
                assert nbytes == (min(max(es * nu - ub, 0), W) if ok else 0)
                if nbytes:
                    first = ((tr * B + b0 + row) * wd.pitch + wd.col + u0)
                    assert src == wd.base + first * es + ub
                    # inside the row's own units and the stream
                    assert src + nbytes <= wd.base + (first + nu) * es
                    assert src + nbytes <= wd.base + T * B * wd.pitch * es
                else:
                    assert src is None
                for k in range(0, W, es):
                    written[(w, row, (ub + k) // es)] += 1
                    # zero-fill exactly past H or outside [0, T)
                    assert (k < nbytes) == (ok and (ub + k) // es < nu)
            want = {(w, r, u) for w in range(len(words)) for r in range(nrow)
                    for u in range(U)}
            assert set(written) == want
            assert set(written.values()) == {1}
            per = collections.Counter(c[0] for c in copies)
            assert max(per.values()) - min(per.get(x, 0)
                                           for x in range(threads)) <= 1


@pytest.mark.parametrize("name, words, gates, H, plan",
                         list(_cases()),
                         ids=["{} H{} C{} BT{} RB{} KL{}".format(
                             c[0], c[3], *c[4]) for c in _cases()])
def test_ring_fill(name, words, gates, H, plan):
    C, BT, RB, KL = plan
    threads = 32 * rnn_plan.bwd_warps(H, BT, RB, KL)
    for shift in (-1, 1):
        ws = words(H, shift)
        # B past one tile and not a multiple of it
        B = BT + max(1, BT // 2) if BT > 1 else 3
        for t in (0, T // 2, T - 1):
            _check_fill(ws, H, C, BT, B, t, threads)


def test_ring_width_takes_the_base():
    """The width of a shape, cut by an address that is only 8, 4 or 2
    bytes aligned; a ring 8 bytes aligned copies 8 bytes at a time, and a
    stream whose base is not aligned to the shape's width (16 bytes here)
    has no fill (the wrappers copy it first)."""
    assert rnn_plan.ring_width(2, 256, 32) == 16
    assert rnn_plan.ring_width(2, 256, 32, 8) == 8
    assert rnn_plan.ring_width(2, 256, 32, 4) == 4
    assert rnn_plan.ring_width(2, 256, 32, 2) == 0
    assert rnn_plan.ring_width(2, 96, 12) == 8
    assert rnn_plan.ring_width(2, 100, 50) == 4
    assert rnn_plan.ring_width(2, 100, 13) == 0
    assert rnn_plan.ring_width(2, 17, 17) == 0
    assert rnn_plan.ring_width(4, 17, 17) == 4
    words = [RW(2, 256, 0, 0, BASE)]
    copies = rnn_plan.ring_copies(words, 2, 4, 0, 0, 4, 4, 256, 32, 0, 64,
                                  ring=8)
    assert {c[4] for c in copies} == {8} and len(copies) == 4 * 8
    for off in (2, 8):
        with pytest.raises(ValueError, match="no cp.async"):
            rnn_plan.ring_copies([RW(2, 256, 0, 0, BASE + off)], 2, 4, 0, 0,
                                 4, 4, 256, 32, 0, 64)


@pytest.mark.parametrize("gates", [3, 4])
def test_ring16_plans(gates):
    """The bf16 instance's plans (ring16) are cluster plans whose bf16
    words take a cp.async, else the L2 instance; they drop only the f32
    plans whose bf16 words would not, and at the repo's widths equal
    them."""
    for H in range(1, 513):
        for B in (1, 8, 37, 128, 256):
            f32 = rnn_plan.bwd_plan(gates, H, B, H100)
            b16 = rnn_plan.bwd_plan(gates, H, B, H100, ring16=True)
            if b16.instance == "cluster":
                assert rnn_plan.ring_width(2, H, -(-H // b16.C)) >= 4
            elif H % 2 == 0 and f32.instance == "cluster":
                # even H: some cluster size gives an even U where the
                # instance fits at all, or the L2 instance takes it
                assert not any(
                    rnn_plan.ring_width(2, H, -(-H // p[0]))
                    for p in rnn_plan.bwd_cluster_plans(gates, H))
            if H % 2:
                assert b16.instance == "l2"
            if f32.instance == "cluster" and rnn_plan.ring_width(
                    2, H, -(-H // f32.C)):
                assert b16 == f32
    for H in (16, 96, 256, 384):
        for B in (8, 64, 128, 256, 341):
            assert rnn_plan.bwd_plan(gates, H, B, H100, ring16=True) == \
                rnn_plan.bwd_plan(gates, H, B, H100)


def test_ring_ready_copies_a_misaligned_view():
    """On the cluster plan of a bf16 instance, a stream (bf16, or an f32
    dh) at an offset that cuts its ring width is copied (equal values, its
    own storage); an aligned one, and every stream of the f32 instance or
    the L2 plan, are passed as they are."""
    H, B = 256, 4
    plan = rnn_plan.bwd_plan(4, H, B, H100, ring16=True)
    assert plan.instance == "cluster"
    buf = torch.arange(40 * B * H, dtype=torch.float32).to(torch.bfloat16)
    aligned = buf[:10 * B * H].view(10, B, H)
    assert aligned.data_ptr() % 16 == 0
    odd = buf[1:1 + 10 * B * H].view(10, B, H)
    eight = buf[4:4 + 10 * B * H].view(10, B, H)
    f32 = torch.zeros(10 * B * H + 1)[1:].view(10, B, H)
    got = rnn_plan.ring_ready(plan, H, True, aligned, odd, eight, f32, None)
    assert got[0] is aligned and got[4] is None
    for g, v in zip(got[1:4], (odd, eight, f32)):
        assert g is not v and torch.equal(g, v)
        assert g.data_ptr() % 16 == 0
    l2 = rnn_plan.bwd_plan(4, 512, B, H100, ring16=True)
    assert l2.instance == "l2"
    for p, bf in ((plan, False), (l2, True)):
        got = rnn_plan.ring_ready(p, H, bf, odd, eight, f32)
        assert got[0] is odd and got[1] is eight and got[2] is f32
