"""The launch plan of the forward recurrences (taiyaki_tpu_torch/ops/
rnn_plan.py) and the forward wrappers' `instance=` keyword on the CPU.

The plan is pure Python, fixed by shape before the launch; these tests
hold it to the cluster instance's layout (csrc/rec_cluster.cuh) over a
sweep of gates in {3, 4}, H in 1..512 and B in {1, 7, 8, 128, 256, 341}:
the shared memory of a CTA within 232,448 bytes and C <= 16, the hidden
units covered exactly once by the ranks, every batch row by a tile, the
fewest waves and then the most SMs busy (on the clusters a wave that an
H100 SXM reports, and on a smaller card's), and the L2 instance exactly
where no cluster plan fits.  The repo's own shapes get their plans named
(on the H100 SXM).  On
the CPU the wrappers run their plain twins whatever `instance=` says, and
raise on an unknown instance name.
"""

import functools

import numpy as np
import pytest
import torch

from taiyaki_tpu_torch.ops import gru, lstm, rnn_plan
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse)

LIMIT = 232448
SWEEP_B = (1, 7, 8, 128, 256, 341)
SIZES = (1, 2, 4, 8, 16)
# clusters of 1, 2, 4, 8 and 16 CTAs a card runs at once, one CTA an SM
# (what the wrappers read with cudaOccupancyMaxActiveClusters): an H100
# SXM (132 SMs; its GPCs hold 15 clusters of 8 and 7 of 16, not 132 / C),
# and a card of 66 SMs that runs no cluster of 16
H100 = (132, 66, 30, 15, 7)
SMALL = (66, 33, 15, 7, 0)


def smem_bytes(H, C, BT, KS):
    """rec_cluster_smem of csrc/rec_cluster.cuh, restated: two mbarriers,
    the sW^T slice [H][U][4], h [2][C U][BT], the gate ring [2][BT][U][4]
    and the partial sums [KS][BT][U][4], f32."""
    U = -(-H // C)
    return 16 + 16 * H * U + 8 * C * U * BT + 32 * BT * U + 16 * KS * BT * U


def takes(H, C, BT, RB, KS):
    """rec_cluster_check of csrc/rec_cluster.cuh, restated: RB of 1, 2, 4,
    5, 6 or 9 rows a lane (the kernels' instances) dividing BT <= 32, KS of 1..H k slices, no empty rank, at
    most 512 threads and 4 cells a thread, a rank's h block a multiple of
    16 bytes, the shared memory within the limit."""
    if not (RB in (1, 2, 4, 5, 6, 9) and RB <= BT <= 32 and BT % RB == 0
            and 1 <= KS <= H):
        return False
    U = -(-H // C)
    threads = 32 * KS * -(-U // 32) * (BT // RB)
    return (-(-H // U) == C and threads <= 512 and U * BT <= 4 * threads
            and U * BT % 4 == 0 and smem_bytes(H, C, BT, KS) <= LIMIT)


@functools.lru_cache(maxsize=None)
def options(H, card=H100):
    """Every plan of the cluster instance for H units, at the cluster
    sizes the plan tries (1, 2, 4, 8, 16) that `card` runs."""
    return [(C, BT, RB, KS) for C in SIZES if card[SIZES.index(C)]
            for RB in range(1, 11) for BT in range(RB, 33, RB)
            for KS in range(1, 17) if takes(H, C, BT, RB, KS)]


def waves(C, B, BT, card=H100):
    n = -(-B // BT)
    per_wave = card[SIZES.index(C)]
    return -(-n // per_wave), min(n, per_wave) * C


@pytest.mark.parametrize("card", [H100, SMALL], ids=["h100", "small"])
@pytest.mark.parametrize("B", SWEEP_B)
@pytest.mark.parametrize("gates", [3, 4])
def test_plan_sweep(gates, B, card):
    for H in range(1, 513):
        plan = rnn_plan.rec_plan(gates, H, B, card)
        if not options(H, card):
            assert plan == ("l2", 1, 8, 1, 1, 8 * H * 8), (gates, H, B)
            continue
        assert plan.instance == "cluster", (gates, H, B)
        assert plan.C <= 16 and plan.smem <= LIMIT
        assert plan.smem == smem_bytes(H, plan.C, plan.BT, plan.KS)
        assert tuple(plan[1:5]) in options(H, card)
        # the units as the kernels cut them (rank q: [q U, min(H, q U +
        # U))): contiguous, each rank non-empty, 0..H-1 once, the last
        # rank's slice ragged
        U = -(-H // plan.C)
        ranks = [(q * U, min(H, (q + 1) * U)) for q in range(plan.C)]
        assert [u for a, b in ranks for u in range(a, b)] == list(range(H))
        assert all(b > a for a, b in ranks)
        # every batch row in one tile of at most BT rows (tile i: rows
        # [i BT, min(B, i BT + BT)))
        ntile = -(-B // plan.BT)
        rows = [r for i in range(ntile)
                for r in range(i * plan.BT, min(B, (i + 1) * plan.BT))]
        assert rows == list(range(B))
        # the fewest waves, then the most SMs busy
        best = min((waves(C, B, BT, card)[0], -waves(C, B, BT, card)[1])
                   for C, BT, _, _ in options(H, card))
        got = waves(plan.C, B, plan.BT, card)
        assert (got[0], -got[1]) == best, (gates, H, B, plan)


def test_l2_exactly_past_the_cluster_instance():
    """The widths the cluster instance cannot take are those at the top of
    MAX_HIDDEN: every width of the repo's models is below them."""
    l2 = [H for H in range(1, 513) if not options(H)]
    assert l2 and min(l2) > 384 and 512 in l2
    assert all(rnn_plan.rec_plan(g, H, 128, H100).instance == "l2"
               for g in (3, 4) for H in l2)


def test_small_card_keeps_to_its_clusters():
    """On a card that runs no cluster of 16, the JAX trainer's default
    width (384) fits no smaller cluster: the L2 instance; H=256 keeps
    clusters of 8 and fills the card's 7 of them."""
    assert all(rnn_plan.rec_plan(g, 384, B, SMALL).instance == "l2"
               for g in (3, 4) for B in SWEEP_B)
    plan = rnn_plan.rec_plan(4, 256, 128, SMALL)
    assert plan.C == 8 and waves(8, 128, plan.BT, SMALL) == (1, 56)


@pytest.mark.parametrize("gates,H,B,C,BT,RB,KS", [
    (4, 256, 128, 8, 9, 9, 12), (4, 256, 256, 8, 18, 6, 4),
    (4, 384, 128, 16, 20, 5, 1), (4, 384, 256, 16, 20, 5, 1),
    (3, 96, 128, 2, 2, 2, 4), (3, 96, 256, 2, 4, 4, 4),
    (3, 256, 128, 8, 9, 9, 12), (3, 256, 256, 8, 18, 9, 4),
    (3, 384, 128, 16, 20, 5, 1), (3, 384, 256, 16, 20, 5, 1)])
def test_named_plans(gates, H, B, C, BT, RB, KS):
    """The repo's widths: mLstm (256) and the JAX trainer's default size
    (384), mGru (256) and the shipped remap model (96), at the basecall
    batch (128 chunks) and the training batch (256)."""
    plan = rnn_plan.rec_plan(gates, H, B, H100)
    assert plan == ("cluster", C, BT, RB, KS, smem_bytes(H, C, BT, KS))


@pytest.mark.parametrize("gates", [3, 4])
def test_basecall_shape_fills_the_card(gates):
    plan = rnn_plan.rec_plan(gates, 256, 128, H100)
    assert waves(plan.C, 128, plan.BT)[0] == 1
    assert waves(plan.C, 128, plan.BT)[1] >= 96


@pytest.mark.parametrize("gates", [3, 4])
def test_forced_instances(gates):
    assert rnn_plan.rec_plan(gates, 96, 128, H100, "l2") == \
        ("l2", 1, 8, 1, 1, 96 * 64)
    assert rnn_plan.rec_plan(gates, 96, 128, H100, "cluster") \
        == rnn_plan.rec_plan(gates, 96, 128, H100)
    assert rnn_plan.rec_plan(gates, 512, 128, H100).instance == "l2"
    with pytest.raises(ValueError, match="does not fit"):
        rnn_plan.rec_plan(gates, 512, 128, H100, "cluster")
    with pytest.raises(ValueError, match="does not fit"):
        rnn_plan.rec_plan(gates, 384, 128, SMALL, "cluster")
    with pytest.raises(ValueError, match="instance"):
        rnn_plan.rec_plan(gates, 96, 128, H100, "L2")
    with pytest.raises(ValueError, match="hidden size"):
        rnn_plan.rec_plan(gates, 513, 128, H100)
    with pytest.raises(ValueError, match="gates"):
        rnn_plan.rec_plan(5, 96, 128, H100)
    with pytest.raises(ValueError, match="per_wave"):
        rnn_plan.rec_plan(gates, 96, 128, H100[:4])


@pytest.mark.parametrize("C", SIZES)
def test_clusters_per_wave_asks_a_plan_the_kernels_take(C):
    """The card's count of each cluster size is read at a plan the C side
    takes, one warp and one row, so that any card can answer it."""
    H, plan = rnn_plan.probe_plan(C)
    assert plan.C == C and takes(H, *plan[1:5])
    assert plan.smem == smem_bytes(H, C, plan.BT, plan.KS)
    asked = []

    def occupancy(h, p):
        asked.append((h, p))
        return 100 // p.C

    assert rnn_plan.clusters_per_wave(occupancy) == tuple(
        100 // c for c in SIZES)
    assert asked == [rnn_plan.probe_plan(c) for c in SIZES]


def test_c_args_and_describe():
    plan = rnn_plan.rec_plan(4, 256, 128, H100)
    assert rnn_plan.c_args(plan) == (1, 8, 9, 9, 12,
                                     smem_bytes(256, 8, 9, 12))
    assert rnn_plan.c_args(rnn_plan.rec_plan(4, 512, 8, H100)) == \
        (0, 1, 8, 1, 1, 32768)
    line = rnn_plan.describe(plan, 256, 128, H100)
    assert "C=8" in line and "120 SMs busy" in line


def test_step_model_orders_the_measured_plans():
    """The cost model prefers, at the shipped remap model's width, the plan
    the card ran fastest among those probes/rec_plans.py timed (C=2 over
    C=1), and at the basecall shape of H=256 the split product over one
    chain a lane."""
    assert rnn_plan.step_cycles(3, 96, 2, 2, 2, 3) < \
        rnn_plan.step_cycles(3, 96, 1, 1, 1, 4)
    assert rnn_plan.step_cycles(4, 256, 8, 9, 9, 12) < \
        rnn_plan.step_cycles(4, 256, 8, 9, 3, 1)


def _inputs(T, B, D, H, G, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(T, B, D)), rng.normal(size=(G * H, D)) / np.sqrt(D),
        0.5 * rng.normal(size=G * H), rng.normal(size=(G * H, H)) / np.sqrt(H))]


def _forwards():
    """(wrapper, its plain twin, gates, keyword of the residuals)."""
    return [(lstm.lstm_fwd, lstm.lstm_fwd_plain, 4, "emit", "acts"),
            (gru.gru_fwd, gru.gru_fwd_plain, 3, "emit_residuals", True),
            (lstm.lstm_scan_fwd, lstm.lstm_scan_fwd_plain, 4, "residuals",
             True),
            (gru.gru_scan_fwd, gru.gru_scan_fwd_plain, 3, "residuals", True)]


@pytest.mark.parametrize("instance", [None, "cluster", "l2"])
@pytest.mark.parametrize("which", range(4))
def test_cpu_wrappers_take_plain_twin(which, instance):
    fn, plain, G, key, res = _forwards()[which]
    x, iW, b, sW = _inputs(9, 5, 7, 12, G, seed=which)
    args = (x, iW, b, sW) if "scan" not in fn.__name__ else (
        torch.matmul(x, iW.t()) + b, sW)
    n = fn.launches
    counts = {k: c.launches for k, c in fn.by_instance.items()}
    for reverse in (False, True):
        got = fn(*args, reverse=reverse, instance=instance, **{key: res})
        want = plain(*args, reverse=reverse, **{key: res})
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert fn.launches == n
    assert {k: c.launches for k, c in fn.by_instance.items()} == counts


@pytest.mark.parametrize("which", range(4))
def test_wrappers_reject_unknown_instance(which):
    fn, _, G, _, _ = _forwards()[which]
    x, iW, b, sW = _inputs(3, 2, 4, 8, G, seed=0)
    args = (x, iW, b, sW) if "scan" not in fn.__name__ else (
        torch.matmul(x, iW.t()) + b, sW)
    with pytest.raises(ValueError, match="instance"):
        fn(*args, instance="shared")
