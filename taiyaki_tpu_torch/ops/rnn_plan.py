"""The launch plans of the recurrences (kernels 2 and 3 of csrc/lstm.cu
and csrc/gru.cu): which of their two instances runs a layer of `gates`
gate rows per hidden unit (4 for the LSTM, 3 for the GRU), H units and B
batch rows, and on how many CTAs; `rec_plan` for the forward, `bwd_plan`
for the backward chain.  A plan is fixed by the shape and by how many
clusters of each size the card runs at once (read from the card once,
`clusters_per_wave`), before the launch; nothing on the path changes it
after a failure.

The instances compute the same values (csrc/rec_cluster.cuh):
- "cluster": a thread-block cluster of C CTAs walks each tile of BT batch
  rows; each CTA keeps the sW slice of its ceil(H / C) units in shared
  memory for the whole launch and exchanges h (forward) or its partial
  dh_prev (backward) with the others through distributed shared memory.
  Taken wherever the slice, the exchange buffers and the ring fit in one
  CTA's 232,448 bytes with C <= 16: every width the repo's models and
  tests use (16, 96, 256, 384) and odd widths up to about 450.
- "l2": one block per tile of 8 rows, sW read again from L2 at every
  step: for the rest (up to MAX_HIDDEN = 512, where an LSTM needs 4 MB of
  sW, 262 KB a CTA even at C = 16).

The bf16 instances of both cells (TAIYAKI_TPU_BF16_STREAMS=1,
ops/rnn.py; the scans' too) keep the f32 instances' shared memory: h,
the exchange and the partial sums stay f32, the forward's gate ring too
(a bf16 gate stream goes through registers and is widened into it), and
the backward's ring keeps its f32 bytes, laid out word-major with each
word in its stream's type ([R][BT][U]) and filled by cp.async of whole
runs of U units (csrc/rec_cluster.cuh, the bf16 chains' ring; `ring_width`
and `ring_copies` restate its fill).  So `cluster_smem` and `bwd_smem`
count both instances.  A bf16 word takes cp.async only where H and U are
even (a copy is 4 bytes at least): `bwd_plan` with `ring16` takes no other
cluster plan, and a plan holds for either instance wherever that does.
Their registers are held to the same launch bounds (512 threads, one CTA
an SM); what does not fit spills, which the build reports (`-Xptxas -v`).

Among the cluster plans that fit (C ranks, BT rows a tile, RB rows a
lane in the product, and KS slices of the forward's sum over k, or KL
output units a lane of the backward's product): one CTA per SM, the
fewest waves of clusters (as many clusters of each size as the card runs
at once, `per_wave`, which the wrappers read from the card), then the
most SMs busy, then the least modelled step time (`step_cycles`,
`bwd_step_cycles`), then the smaller cluster.
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
# the backward's, from the same probe: one cell of a thread (its
# activations' derivatives and stores, LSTM and GRU), each rank's partial
# its sum reads, and the top of a step (the wait for the ring)
BWD_CELL_CYCLES = {4: 600, 3: 1000}
SUM_RANK_CYCLES = 25
BWD_TOP_CYCLES = 100
# the stall a unit of a warp's product costs beside its instructions where
# too few warps hide it (the probe: ~120 cycles a unit at 2 warps)
BWD_LATENCY_CYCLES = 55
# output units a lane in the backward's product: the kernels are
# instantiated for these (rec_with_rb_kl of csrc/rec_cluster.cuh)
UNITS_A_LANE = (1, 2)
# words of a cell's inputs in the backward's ring (acts or pre, tc or c,
# c_prev and dh; gx, gh, h_prev and dh)
BWD_RING = {4: 7, 3: 8}

# a backward plan's KS field holds KL, the output units a lane of its
# product (the backward does not split its sum)
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


def bwd_smem(gates, H, C, BT):
    """Bytes of shared memory of one CTA of the backward's cluster
    instance: two mbarriers, the own cells' gate gradients [BT][U][4], the
    partials received [2][C][U][BT] and made [2][C U][BT], the own gate
    rows of sW [U][gates][H] and the ring of the next step's inputs
    [BT][U][BWD_RING], U = ceil(H / C)."""
    U = -(-H // C)
    return (16 + 16 * BT * U + 16 * C * U * BT + 4 * gates * H * U
            + 4 * BWD_RING[gates] * BT * U)


def bwd_warps(H, BT, RB, KL):
    """Warps of a backward CTA: one a group of 32 KL output units and row
    group of RB rows."""
    return -(-H // (32 * KL)) * (BT // RB)


def bwd_cluster_fits(gates, H, C, BT, RB, KL):
    """Whether the backward's cluster instance takes C ranks, BT rows a
    tile, RB rows and KL output units a lane for H units: the forward's
    rules, with the backward's warps and shared memory."""
    if H < 1 or C not in CLUSTER_SIZES or RB not in ROWS_A_LANE \
            or KL not in UNITS_A_LANE or not RB <= BT <= MAX_BATCH_TILE \
            or BT % RB:
        return False
    U = -(-H // C)
    nw = bwd_warps(H, BT, RB, KL)
    return (-(-H // U) == C and nw <= MAX_WARPS
            and U * BT <= MAX_CELLS * 32 * nw and U * BT % 4 == 0
            and bwd_smem(gates, H, C, BT) <= SMEM_LIMIT)


def bwd_step_cycles(gates, H, C, BT, RB, KL):
    """Modelled cycles of one backward step of a cluster plan on one SM
    (csrc/rec_cluster.cuh): the product over the own U units, its issue
    (KL G weight loads, RB dS loads and KL G RB fmaf a unit, ceil(nw / 4)
    warps a scheduler) plus its shared-memory reads (KL G wavefronts of
    weights and RB broadcasts a unit of each warp): probes/rec_phases.cu
    finds the two barely overlap.  With few warps the product is
    latency-bound instead: a unit of one warp's instructions plus
    BWD_LATENCY_CYCLES each.  Then the exchange, the cells with their sums
    over C partials, the step's top and two barriers."""
    U = -(-H // C)
    nw = bwd_warps(H, BT, RB, KL)
    per_unit = KL * gates + RB + KL * gates * RB
    issue = U * per_unit * -(-nw // 4)
    reads = nw * U * (KL * gates + RB)
    latency = U * (BWD_LATENCY_CYCLES + per_unit)
    exchange = EXCHANGE_CYCLES + C * EXCHANGE_RANK_CYCLES
    cells = ((BWD_CELL_CYCLES[gates] + C * SUM_RANK_CYCLES)
             * -(-(U * BT) // (32 * nw)))
    return (max(issue + reads, latency) + exchange + cells + BWD_TOP_CYCLES
            + 2 * SYNC_CYCLES)


@functools.lru_cache(maxsize=None)
def cluster_plans(gates, H):
    """Every (C, BT, RB, KS) the cluster instance takes for H units."""
    return tuple((C, BT, RB, KS) for C in CLUSTER_SIZES
                 for RB in ROWS_A_LANE
                 for BT in range(RB, MAX_BATCH_TILE + 1, RB)
                 for KS in range(1, MAX_WARPS + 1)
                 if cluster_fits(H, C, BT, RB, KS))


@functools.lru_cache(maxsize=None)
def bwd_cluster_plans(gates, H, ring16=False):
    """Every (C, BT, RB, KL) the backward's cluster instance takes for H
    units; with `ring16` (a bf16 word in the chain's ring) only those
    whose ring a cp.async fills (`ring_width` of 2-byte units)."""
    return tuple((C, BT, RB, KL) for C in CLUSTER_SIZES
                 for RB in ROWS_A_LANE
                 for BT in range(RB, MAX_BATCH_TILE + 1, RB)
                 for KL in UNITS_A_LANE
                 if bwd_cluster_fits(gates, H, C, BT, RB, KL)
                 and (not ring16 or ring_width(2, H, -(-H // C))))


def ring_width(es, H, U, base=0):
    """The bytes of each cp.async of a word of the bf16 chains' ring
    (csrc/rec_cluster.cuh `rec_ring_width`): the widest of 16, 8 and 4
    that divides a stream row's H units and a run's U units of es bytes
    and the address `base` (the ring's; a stream's base must be aligned
    to the width of the shape alone); 0 where none does."""
    v = es * H | es * U | base | 16
    w = v & -v
    return w if w >= 4 else 0


# One word of the bf16 chains' ring as `ring_copies` reads it: es bytes a
# unit, rows of `pitch` units, the word at unit `col` of a row, read at
# time row t + shift, the stream at address `base`
RingWord = collections.namedtuple("RingWord", "es pitch col shift base")


def ring_copies(words, T, B, t, b0, nrow, BT, H, U, u0, nt, ring=0):
    """The cp.async copies of one step's fill of the bf16 chains' ring, as
    csrc/rec_cluster.cuh `rec_ring_geo` and `rec_ring_word` deal them
    over nt threads: a list of (thread, word, ring byte, source address or
    None, W, bytes) for the words (RingWord) of tile rows b0 .. b0 + nrow
    - 1 at time row t, rank units u0 .. u0 + U - 1; word w's region
    starts at ring byte 4 BT U w (`ring` the ring's address); `bytes` < W
    zero-fills the rest of a copy, and a copy reading nothing (source
    None) reads from the stream's base.  Raises ValueError where no
    cp.async takes a word or its stream's base (`rec_ring_check`)."""
    out = []
    nxt = list(range(nt))
    for w, wd in enumerate(words):
        region = 4 * BT * U * w
        W = ring_width(wd.es, H, U, ring)
        if not W or wd.base % ring_width(wd.es, H, U):
            raise ValueError("ring_copies: no cp.async takes word {} "
                             "({} bytes a unit at {:#x}, H={}, U={})".format(
                                 w, wd.es, wd.base, H, U))
        run = wd.es * U
        per = run // W
        n = nrow * per
        tr = t + wd.shift
        ok = 0 <= tr < T
        have = wd.es * min(U, H - u0) if ok else 0
        row0 = ((tr * B + b0) * wd.pitch + wd.col + u0) * wd.es if ok else 0
        for x in range(nt):
            i = nxt[x]
            while i < n:
                r, c = divmod(i, per)
                off = c * W
                nbytes = min(max(have - off, 0), W)
                src = (wd.base + row0 + r * wd.pitch * wd.es + off
                       if nbytes else None)
                out.append((x, w, region + r * run + off, src, W, nbytes))
                i += nt
            nxt[x] = i - n
    return out


def _pick(what, gates, H, B, per_wave, instance, plans, cost, smem,
          l2_smem):
    """The plan among `plans` (C, BT, RB, KS) on the fewest waves, then
    the most SMs busy, then the least nwave * cost(C, BT, RB, KS), then
    the smaller cluster; else the L2 instance (l2_smem bytes)."""
    check_instance(instance)
    if gates not in (3, 4):
        raise ValueError(what + ": gates must be 3 (GRU) or 4 (LSTM)")
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError("{}: hidden size {} is not in 1..{}".format(
            what, H, MAX_HIDDEN))
    if len(per_wave) != len(CLUSTER_SIZES):
        raise ValueError("{}: per_wave needs a count for each of the "
                         "cluster sizes {}".format(what, CLUSTER_SIZES))
    if instance in (None, "cluster"):
        best = None
        for C, BT, RB, KS in plans:
            if per_wave[CLUSTER_SIZES.index(C)] < 1:
                continue
            nwave, busy = waves(C, B, BT, per_wave)
            key = (nwave, -busy, nwave * cost(C, BT, RB, KS), C, BT, RB, KS)
            if best is None or key < best[0]:
                best = (key, Plan("cluster", C, BT, RB, KS,
                                  smem(C, BT, KS)))
        if best is not None:
            return best[1]
    if instance == "cluster":
        raise ValueError("{}: the cluster instance does not fit H={} "
                         "(shared memory over {} bytes at every cluster "
                         "size the card runs)".format(what, H, SMEM_LIMIT))
    return Plan("l2", 1, L2_BATCH_TILE, 1, 1, l2_smem)


@functools.lru_cache(maxsize=None)
def rec_plan(gates, H, B, per_wave, instance=None):
    """The plan of a forward recurrence: Plan(instance, C, BT, RB, KS,
    smem), on a card that runs per_wave[i] clusters of CLUSTER_SIZES[i]
    ranks at once (`clusters_per_wave`; sizes it runs none of are left
    out).  `instance` None takes the cluster instance wherever it fits,
    else the L2 one; "cluster" or "l2" forces one (tests and chip_smoke.py
    only, to time the two at one shape), raising ValueError where it
    cannot run."""
    return _pick("rec_plan", gates, H, B, per_wave, instance,
                 cluster_plans(gates, H) if gates in (3, 4) else (),
                 lambda C, BT, RB, KS: step_cycles(gates, H, C, BT, RB, KS),
                 lambda C, BT, KS: cluster_smem(H, C, BT, KS),
                 8 * H * L2_BATCH_TILE)


@functools.lru_cache(maxsize=None)
def bwd_plan(gates, H, B, per_wave, instance=None, ring16=False):
    """The plan of a backward chain, as `rec_plan` (the same keys and
    `instance`), with the backward's footprint (`bwd_smem`) and step model
    (`bwd_step_cycles`); its KS field holds KL, the output units a lane
    (1 for the L2 instance).  The L2 instance keeps its gate gradients of
    8 rows double-buffered: 8 gates H 8 bytes.  d_b comes back as
    ceil(B / BT) partials.  `ring16`: the chain's bf16 instance with a
    bf16 word in its ring, which takes only the cluster plans of even H
    and U (`bwd_cluster_plans`), else the L2 instance."""
    return _pick("bwd_plan", gates, H, B, per_wave, instance,
                 bwd_cluster_plans(gates, H, ring16) if gates in (3, 4)
                 else (),
                 lambda C, BT, RB, KL: bwd_step_cycles(gates, H, C, BT, RB,
                                                       KL),
                 lambda C, BT, KL: bwd_smem(gates, H, C, BT),
                 8 * gates * H * L2_BATCH_TILE)


def ring_ready(plan, H, bf16, *tensors):
    """The streams of a backward chain as its ring's fill takes them: with
    `bf16` (the chain's bf16 instance) on the cluster instance, a copy of
    each tensor whose base address is not aligned to its `ring_width` (a
    view at an offset), else the tensor itself (None stays None);
    csrc/rec_cluster.cuh `rec_ring_check` refuses the views this would
    leave.  Returns a list in the order given."""
    if not bf16 or plan.instance != "cluster":
        return list(tensors)
    U = -(-H // plan.C)

    def ready(t):
        w = ring_width(t.element_size(), H, U)
        return t if not w or t.data_ptr() % w == 0 else t.clone()
    return [t if t is None else ready(t) for t in tensors]


def check_instance(instance):
    if instance is not None and instance not in INSTANCES:
        raise ValueError("instance must be None, 'cluster' or 'l2', not "
                         "{!r}".format(instance))


def c_args(plan):
    """The plan as the C functions take it: (instance, C, BT, RB, KS,
    smem)."""
    return (INSTANCES.index(plan.instance), plan.C, plan.BT, plan.RB,
            plan.KS, plan.smem)


def describe(plan, H, B, per_wave, backward=False):
    """One line for a log: instance, cluster, tiles, CTAs and bytes (of a
    backward plan with `backward`)."""
    if plan.instance == "l2":
        return "l2 (one block per {} rows: {} blocks, sW from L2)".format(
            plan.BT, -(-B // plan.BT))
    nwave, busy = waves(plan.C, B, plan.BT, per_wave)
    nw = (bwd_warps(H, plan.BT, plan.RB, plan.KS) if backward
          else warps(H, plan.C, plan.BT, plan.RB, plan.KS))
    return ("cluster C={} BT={} RB={} {}={} ({} units, {} warps a CTA): {} "
            "CTAs, {} SMs busy, {} wave(s), {} B shared memory a CTA".format(
                plan.C, plan.BT, plan.RB, "KL" if backward else "KS",
                plan.KS, -(-H // plan.C), nw, plan.C * -(-B // plan.BT),
                busy, nwave, plan.smem))


class Launches:
    """The launch count of one instance of a kernel (`launches`, as the
    wrappers' own counters)."""

    def __init__(self):
        self.launches = 0


def instance_counters():
    """{instance: Launches()}, one counter per instance."""
    return {k: Launches() for k in INSTANCES}


def count(fn, plan, bf16=False):
    """One launch of the wrapper `fn` (its `launches` and `by_instance`
    counters), on `plan`'s instance; with `bf16`, of its bf16 instance
    (also its `bf16` and `bf16_by_instance` counters)."""
    fn.launches += 1
    fn.by_instance[plan.instance].launches += 1
    if bf16:
        fn.bf16.launches += 1
        fn.bf16_by_instance[plan.instance].launches += 1
