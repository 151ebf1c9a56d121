"""The launch plan of the forward recurrences (kernel 2 of csrc/lstm.cu and
csrc/gru.cu): which of their two instances runs a layer of `gates` gate
rows per hidden unit (4 for the LSTM, 3 for the GRU), H units and B batch
rows, and on how many CTAs.  The plan is fixed by the shape and by how
many clusters of each size the card runs at once (read from the card once,
`clusters_per_wave`), before the launch; nothing on the path changes it
after a failure.

The instances compute the same values (csrc/rec_cluster.cuh):
- "cluster": a thread-block cluster of C CTAs walks each tile of BT batch
  rows; each CTA keeps the sW^T slice of its ceil(H / C) units in shared
  memory for the whole launch and receives h from the others through
  distributed shared memory.  Taken wherever the slice, the h buffers and
  the gate ring fit in one CTA's 232,448 bytes with C <= 16: every width
  the repo's models and tests use (16, 96, 256, 384) and odd widths up to
  about 450.
- "l2": one block per tile of 8 rows, sW^T read again from L2 at every
  step: for the rest (up to MAX_HIDDEN = 512, where an LSTM needs 4 MB of
  sW^T, 262 KB a CTA even at C = 16).

Among the cluster plans that fit (C ranks, BT rows a tile, RB rows a
lane in the product, KS slices of its sum over k): one CTA per SM, the
fewest waves of clusters (as many clusters of each size as the card runs
at once, `per_wave`, which the wrappers read from the card), then the
most SMs busy, then the least modelled step time (`step_cycles`), then
the smaller cluster.
"""

import collections
import functools

SMEM_LIMIT = 232448            # dynamic shared memory a CTA may use
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_BATCH_TILE = 32
# rows a lane in the product: the kernels are instantiated for these alone
# (rec_with_rb of csrc/rec_cluster.cuh), the values the plans of the
# repo's shapes take and 1
ROWS_A_LANE = (1, 2, 4, 5, 6, 9)
MAX_WARPS = 16                 # 512 threads a CTA
MAX_CELLS = 4                  # (unit, row) cells a thread
MAX_HIDDEN = 512               # the L2 instance: one thread per unit
L2_BATCH_TILE = 8
# the C side's numbers of the instances (csrc/rec_cluster.cuh)
INSTANCES = ("l2", "cluster")
# the cost model's constants, in cycles, from the phase probe of the
# step (probes/rec_phases.cu on the H100): the latency of one input k of a
# warp's product (plus one a row); the exchange with the fence and
# barrier before it and the wait for the slowest rank, EXCHANGE_CYCLES + C
# EXCHANGE_RANK_CYCLES; the top of a step (the gate copies); one
# __syncthreads; and one cell (activations and stores) of a thread, LSTM
# and GRU
LATENCY_CYCLES = 24
EXCHANGE_CYCLES = 150
EXCHANGE_RANK_CYCLES = 100
TOP_CYCLES = 450
SYNC_CYCLES = 100
CELL_CYCLES = {4: 1150, 3: 950}

Plan = collections.namedtuple("Plan", "instance C BT RB KS smem")


def cluster_smem(H, C, BT, KS):
    """Bytes of shared memory of one CTA of the cluster instance: two
    mbarriers, the sW^T slice [H][U][4] (gates padded to four), h
    [2][C U][BT], the gate ring [2][BT][U][4] and the partial sums
    [KS][BT][U][4], U = ceil(H / C)."""
    U = -(-H // C)
    return (16 + 16 * H * U + 8 * C * U * BT + 32 * BT * U
            + 16 * KS * BT * U)


def warps(H, C, BT, RB, KS):
    """Warps of a CTA: one a k slice, unit group of 32 and row group of RB
    rows."""
    U = -(-H // C)
    return KS * -(-U // 32) * (BT // RB)


def cluster_fits(H, C, BT, RB, KS):
    """Whether the cluster instance takes C ranks, BT rows a tile, RB rows
    a lane and KS k slices for H units: every rank owns a unit, RB one
    of ROWS_A_LANE, BT a multiple of RB, at most 16 warps and 4 cells a
    thread, a rank's block of h a multiple of 16 bytes (U BT of 4), the
    shared memory within SMEM_LIMIT."""
    if H < 1 or C not in CLUSTER_SIZES or RB not in ROWS_A_LANE \
            or not RB <= BT <= MAX_BATCH_TILE or BT % RB or not 1 <= KS <= H:
        return False
    U = -(-H // C)
    nw = warps(H, C, BT, RB, KS)
    return (-(-H // U) == C and nw <= MAX_WARPS
            and U * BT <= MAX_CELLS * 32 * nw and U * BT % 4 == 0
            and cluster_smem(H, C, BT, KS) <= SMEM_LIMIT)


def step_cycles(gates, H, C, BT, RB, KS):
    """Modelled cycles of one step of a cluster plan on one SM
    (csrc/rec_cluster.cuh): the product, (a) its instruction issue and (b)
    its shared-memory reads overlapping only in part, or its latency where
    too few warps hide it; then (c) the exchange, (d) the cells, and the
    step's top and barrier."""
    U = -(-H // C)
    nw = warps(H, C, BT, RB, KS)
    hk = -(-H // KS)
    issue = hk * (gates * RB + 1 + RB) * -(-nw // 4)
    # the float4 of wS: one cycle per 8 active lanes of a warp
    reads = nw * hk * (-(-min(U, 32) // 8) + RB)
    latency = hk * (LATENCY_CYCLES + RB)
    exchange = EXCHANGE_CYCLES + C * EXCHANGE_RANK_CYCLES
    cells = CELL_CYCLES[gates] * -(-(U * BT) // (32 * nw))
    return (max(issue, reads, latency) + min(issue, reads) // 2 + exchange
            + cells + TOP_CYCLES + SYNC_CYCLES)


def waves(C, B, BT, per_wave):
    """(waves, SMs busy in the first wave) of a cluster plan at one CTA per
    SM; per_wave[i] clusters of CLUSTER_SIZES[i] ranks run at once."""
    n = -(-max(B, 1) // BT)
    pw = per_wave[CLUSTER_SIZES.index(C)]
    return -(-n // pw), min(n, pw) * C


def probe_plan(C):
    """The smallest cluster plan of C ranks (4 units a rank, one row, one
    warp).  A CTA of any plan takes a whole SM (the launch reserves over
    half of its shared memory), so the card runs as many clusters of this
    plan at once as of any other plan of C ranks: `clusters_per_wave`
    counts with it."""
    return 4 * C, Plan("cluster", C, 1, 1, 1, cluster_smem(4 * C, C, 1, 1))


def clusters_per_wave(occupancy):
    """per_wave of the current card: occupancy(H, plan), a wrapper's
    cudaOccupancyMaxActiveClusters, at probe_plan(C) for each cluster size
    (0 where the card runs none, as a small partition may)."""
    return tuple(occupancy(*probe_plan(C)) for C in CLUSTER_SIZES)


@functools.lru_cache(maxsize=None)
def cluster_plans(gates, H):
    """Every (C, BT, RB, KS) the cluster instance takes for H units."""
    return tuple((C, BT, RB, KS) for C in CLUSTER_SIZES
                 for RB in ROWS_A_LANE
                 for BT in range(RB, MAX_BATCH_TILE + 1, RB)
                 for KS in range(1, MAX_WARPS + 1)
                 if cluster_fits(H, C, BT, RB, KS))


@functools.lru_cache(maxsize=None)
def rec_plan(gates, H, B, per_wave, instance=None):
    """The plan of a forward recurrence: Plan(instance, C, BT, RB, KS,
    smem), on a card that runs per_wave[i] clusters of CLUSTER_SIZES[i]
    ranks at once (`clusters_per_wave`; sizes it runs none of are left
    out).  `instance` None takes the cluster instance wherever it fits,
    else the L2 one; "cluster" or "l2" forces one (tests and chip_smoke.py
    only, to time the two at one shape), raising ValueError where it
    cannot run."""
    check_instance(instance)
    if gates not in (3, 4):
        raise ValueError("rec_plan: gates must be 3 (GRU) or 4 (LSTM)")
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError("rec_plan: hidden size {} is not in 1..{}".format(
            H, MAX_HIDDEN))
    if len(per_wave) != len(CLUSTER_SIZES):
        raise ValueError("rec_plan: per_wave needs a count for each of the "
                         "cluster sizes {}".format(CLUSTER_SIZES))
    if instance in (None, "cluster"):
        best = None
        for C, BT, RB, KS in cluster_plans(gates, H):
            if per_wave[CLUSTER_SIZES.index(C)] < 1:
                continue
            nwave, busy = waves(C, B, BT, per_wave)
            key = (nwave, -busy,
                   nwave * step_cycles(gates, H, C, BT, RB, KS), C, BT, RB,
                   KS)
            if best is None or key < best[0]:
                best = (key, Plan("cluster", C, BT, RB, KS,
                                  cluster_smem(H, C, BT, KS)))
        if best is not None:
            return best[1]
    if instance == "cluster":
        raise ValueError("rec_plan: the cluster instance does not fit H={} "
                         "(shared memory over {} bytes at every cluster "
                         "size the card runs)".format(H, SMEM_LIMIT))
    return Plan("l2", 1, L2_BATCH_TILE, 1, 1, 8 * H * L2_BATCH_TILE)


def check_instance(instance):
    if instance is not None and instance not in INSTANCES:
        raise ValueError("instance must be None, 'cluster' or 'l2', not "
                         "{!r}".format(instance))


def c_args(plan):
    """The plan as the C functions take it: (instance, C, BT, RB, KS,
    smem)."""
    return (INSTANCES.index(plan.instance), plan.C, plan.BT, plan.RB,
            plan.KS, plan.smem)


def describe(plan, H, B, per_wave):
    """One line for a log: instance, cluster, tiles, CTAs and bytes."""
    if plan.instance == "l2":
        return "l2 (one block per {} rows: {} blocks, sW^T from L2)".format(
            plan.BT, -(-B // plan.BT))
    nwave, busy = waves(plan.C, B, plan.BT, per_wave)
    return ("cluster C={} BT={} RB={} KS={} ({} units, {} warps a CTA): {} "
            "CTAs, {} SMs busy, {} wave(s), {} B shared memory a CTA".format(
                plan.C, plan.BT, plan.RB, plan.KS, -(-H // plan.C),
                warps(H, plan.C, plan.BT, plan.RB, plan.KS),
                plan.C * -(-B // plan.BT), busy, nwave, plan.smem))


class Launches:
    """The launch count of one instance of a kernel (`launches`, as the
    wrappers' own counters)."""

    def __init__(self):
        self.launches = 0


def instance_counters():
    """{instance: Launches()}, one counter per instance."""
    return {k: Launches() for k in INSTANCES}
