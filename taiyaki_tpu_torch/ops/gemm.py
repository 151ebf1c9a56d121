"""The two f32 GEMMs under the recurrent layers (csrc/gemm.cuh), their
plan, their plain twins and standalone entry points.

- `gate_gemm`: C[M, N] = A[M, K] . W[N, K]^T (+ bias) (+ C): the input
  product of the layer forwards, d_x of the backwards and the gate streams
  the recomputing backwards rebuild.  The TPU kernels form these products
  inside their bodies (taiyaki_tpu/ops/pallas_rnn.py:805-817 `_fused_gates`;
  :590 and :1267 for the rebuilt streams; d_x at :299-305, :367-373,
  :608-614, :1168-1174, :1299-1306).
- `atb_gemm`: the weight gradients d_iW = dgates^T x and d_sW = dgates^T
  h_prev, as partials over slices of the T*B rows (h_prev read by a row
  shift), which the caller adds up in order.

Each has two instances on the card that compute the same function:
- "tc": 3xTF32 on Hopper's tensor cores (wgmma), its operands brought by
  TMA into a ring of shared-memory stages (csrc/gemm_tc.cuh), on a
  persistent grid of at most one CTA an SM;
- "simt": the f32 FMA kernels of the port's first slices.
`gemm_plan` picks one by shape before the launch: "tc" wherever TMA can
take every operand it loads (rows a multiple of 4 floats: 16-byte
strides), "simt" for ragged widths.  No launch falls back from one to the
other; the C entry points check each plan and refuse one the shape cannot
take.  TMA also needs each operand's base address 16-byte aligned, which a
contiguous view at an odd float offset (`buf[1:].view(...)`) is not: the
wrappers pass their operands through `tma_ready`, which copies such a
view, so that the plan stays a function of shapes alone.  The layers'
wrappers (ops/lstm.py, ops/gru.py) pass the plans of their products and
count them here, by instance: `gate_gemm.by_instance` and
`atb_gemm.by_instance` count every GEMM of every path.

On a CPU tensor the plain twin runs; on a CUDA tensor the kernel launches,
or the wrapper raises.
"""

import collections
import ctypes
import functools

import torch

from taiyaki_tpu_torch.ops import cuda_lib
from taiyaki_tpu_torch.ops.rnn_plan import Launches

GATE, ATB = "gate", "atb"
INSTANCES = ("simt", "tc")      # the C side's GEMM_SIMT, GEMM_TC
# the tc instance's tile: rows and columns of an output tile, and k of a
# stage (a slice of an atb product is a multiple of it)
TC_BM = TC_BN = 128
TC_BK = 32
# the atb slices: at most MAX_SPLIT, each at least MIN_SLICE rows (a
# tile's k loop well beyond its fixed costs), the fewest whose tiles fill
# WAVE_FILL of the waves they take on the card's SMs
MAX_SPLIT = 64
MIN_SLICE = 2048
WAVE_FILL = 0.9
# the simt instance's slices: the first slices' rule
SIMT_MAX_SPLIT = 32
SIMT_MIN_SLICE = 2048
SMS_H100 = 132

# a plan as the C side takes it (`c_args`): kind (GATE or ATB), instance,
# slices and rows a slice of an atb product (gate: 1, 0), persistent CTAs
# of the tc instance (0 for simt)
GemmPlan = collections.namedtuple("GemmPlan",
                                  "kind instance nsplit kslice ctas")
_P, _I = cuda_lib.P, cuda_lib.I
_SIGNATURES = {"tt_gate_gemm": [_P] * 4 + [_I] * 4 + [_P, _P],
               "tt_atb_gemm": [_P] * 3 + [_I] * 4 + [_P, _P]}


def tc_takes(kind, M, N, K):
    """Whether TMA takes every operand of the product: the gate product's
    A [M, K] and W [N, K] need K % 4 == 0, the atb product's A [K, M] and
    B [K, N] need M % 4 == 0 and N % 4 == 0."""
    return K % 4 == 0 if kind == GATE else M % 4 == 0 and N % 4 == 0


def tc_tiles(M, N):
    return -(-M // TC_BM) * -(-N // TC_BN)


def tc_slices(K, nsplit):
    """(slices, rows a slice) of the tc instance for `nsplit` slices asked
    of K rows: the length rounded up to a k tile, so no tile straddles two
    slices, and no slice left empty."""
    rows = -(-K // nsplit)
    kslice = max(TC_BK, -(-rows // TC_BK) * TC_BK)
    return max(1, -(-K // kslice)), kslice


def _tc_nsplit(K, tiles, sms):
    """The fewest slices of K rows whose tiles (tiles a slice) fill
    WAVE_FILL of the waves they take on `sms` SMs, each slice at least
    MIN_SLICE rows long; else the fill's best."""
    best = None
    for n in range(1, MAX_SPLIT + 1):
        n_eff, kslice = tc_slices(K, n)
        if n_eff != n or (n > 1 and kslice < MIN_SLICE):
            continue
        work = tiles * n
        fill = work / (-(-work // sms) * sms)
        if fill >= WAVE_FILL:
            return n
        if best is None or fill > best[0]:
            best = (fill, n)
    return best[1] if best else 1


def simt_nsplit(K):
    """The simt instance's slices of K rows: enough blocks to fill the
    card, each slice at least SIMT_MIN_SLICE rows long."""
    return max(1, min(SIMT_MAX_SPLIT, K // SIMT_MIN_SLICE))


@functools.lru_cache(maxsize=None)
def gemm_plan(M, N, K, kind, sms=SMS_H100, instance=None, nsplit=None):
    """The plan of a product: GemmPlan(kind, instance, nsplit, kslice,
    ctas).  kind GATE: C[M, N] = A[M, K] W[N, K]^T; kind ATB: the partials
    of A[K, M]^T B[K, N] (K the reduction's rows).  "tc" wherever
    `tc_takes`, else "simt"; `instance` forces one (tests and
    chip_smoke.py), raising ValueError where TMA cannot take the operands.
    `nsplit` asks for that many atb slices (the tc instance may merge some:
    its slices are whole k tiles); None takes the plan's.  `sms` is the
    card's SM count: the tc instance runs min(tiles, sms) persistent CTAs,
    and its atb slices fill them."""
    if kind not in (GATE, ATB):
        raise ValueError("gemm_plan: kind must be {!r} or {!r}".format(
            GATE, ATB))
    check_instance(instance)
    if min(M, N, K) < 0 or sms < 1 or (nsplit is not None and nsplit < 1):
        raise ValueError("gemm_plan: bad shape or counts")
    takes = tc_takes(kind, M, N, K)
    if instance == "tc" and not takes:
        raise ValueError("gemm_plan: the tc instance needs rows of a "
                         "multiple of 4 floats ({} M={} N={} K={})".format(
                             kind, M, N, K))
    inst = instance or ("tc" if takes else "simt")
    if kind == GATE:
        return GemmPlan(GATE, inst, 1, 0, max(1, min(tc_tiles(M, N), sms))
                        if inst == "tc" else 0)
    if inst == "simt":
        kslice = max(1, -(-K // (nsplit or simt_nsplit(K))))
        return GemmPlan(ATB, "simt", max(1, -(-K // kslice)), kslice, 0)
    n, kslice = tc_slices(K, nsplit or _tc_nsplit(K, tc_tiles(M, N), sms))
    return GemmPlan(ATB, "tc", n, kslice,
                    max(1, min(tc_tiles(M, N) * n, sms)))


def tma_aligned(t):
    """Whether TMA takes the base address of tensor `t` (16-byte aligned),
    as the tc instance needs for every operand it loads (csrc/gemm.cuh
    `gemm_tma_takes`)."""
    return t.data_ptr() % 16 == 0


def tma_ready(*tensors):
    """The operands of a product as the tc instance takes them: each tensor
    as it is where `tma_aligned`, else an aligned copy of it (None stays
    None).  Returns a list in the order given."""
    return [t if t is None or tma_aligned(t) else t.clone()
            for t in tensors]


def check_instance(instance):
    if instance is not None and instance not in INSTANCES:
        raise ValueError("instance must be None, 'simt' or 'tc', not "
                         "{!r}".format(instance))


def c_args(plans):
    """The plans as the C entry points take them: an array of 4 ints a
    plan (instance, nsplit, kslice, ctas), csrc/gemm.cuh `GemmPlan`."""
    flat = [v for p in plans for v in (INSTANCES.index(p.instance),
                                       p.nsplit, p.kslice, p.ctas)]
    return (ctypes.c_int * len(flat))(*flat)


@functools.lru_cache(maxsize=None)
def card_sms(index):
    """The SM count of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def plans_for(device, *shapes):
    """The plans of the products (M, N, K, kind) on `device`."""
    sms = card_sms(device.index if device.index is not None
                   else torch.cuda.current_device())
    return [gemm_plan(M, N, K, kind, sms) for M, N, K, kind in shapes]


def chain_plans(device, M, G, D, H):
    """The plans of a backward's three products after its chain, in the
    order the C side runs them: d_x [M, D] = dgates [M, G] . iW, d_iW
    partials [G, D] and d_sW partials [G, H]."""
    return plans_for(device, (M, D, G, GATE), (G, D, M, ATB),
                     (G, H, M, ATB))


def count(plans):
    """One launch of each plan's kernel: its kind's `launches` and its
    instance's counter."""
    for p in plans:
        fn = gate_gemm if p.kind == GATE else atb_gemm
        fn.launches += 1
        fn.by_instance[p.instance].launches += 1


def gate_gemm_plain(A, W, bias=None, C=None):
    """Plain PyTorch C[M, N] = A[M, K] . W[N, K]^T (+ bias [N]) (+ C)."""
    out = torch.matmul(A, W.t())
    if bias is not None:
        out = out + bias
    return out if C is None else out + C


def shifted(B, shift):
    """Rows k + shift of B [K, N] for k in [0, K), zero outside [0, K)."""
    K = B.shape[0]
    out = torch.zeros_like(B)
    lo, hi = max(0, -shift), min(K, K - shift)
    if hi > lo:
        out[lo:hi] = B[lo + shift:hi + shift]
    return out


def atb_gemm_plain(A, B, shift=0, nsplit=1, kslice=None):
    """Plain PyTorch partials [nsplit, N1, N2] of A[K, N1]^T B[K, N2]
    shifted by `shift` rows (rows of B outside [0, K) read as zero): slice
    z sums the rows [z kslice, (z + 1) kslice) (kslice ceil(K / nsplit) by
    default)."""
    K = A.shape[0]
    kslice = kslice or max(1, -(-K // nsplit))
    Bs = shifted(B, shift)
    return torch.stack([torch.matmul(A[z * kslice:(z + 1) * kslice].t(),
                                     Bs[z * kslice:(z + 1) * kslice])
                        for z in range(nsplit)])


def _check(what, device, specs):
    for name, t, shape in specs:
        if t.device != device or t.dtype != torch.float32 \
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                "{}: {} must be a contiguous float32 tensor of shape {} on "
                "{} (got {} {} {})".format(what, name, tuple(shape), device,
                                           t.dtype, tuple(t.shape), t.device))


def gate_gemm(A, W, bias=None, C=None, instance=None):
    """C[M, N] = A[M, K] . W[N, K]^T (+ bias) (+ C), on `gemm_plan`'s
    instance or the forced `instance`; with C the product is added to it
    in place on the card (the recomputing LSTM backward's second product)
    and C returned.  On the CPU, `gate_gemm_plain` whatever `instance`
    says."""
    check_instance(instance)
    if A.device.type == "cpu":
        return gate_gemm_plain(A, W, bias, C)
    cuda_lib.check_cuda(A, "gate_gemm")
    M, K = A.shape
    N = W.shape[0]
    specs = [("A", A, (M, K)), ("W", W, (N, K))]
    if bias is not None:
        specs.append(("bias", bias, (N,)))
    if C is not None:
        specs.append(("C", C, (M, N)))
    _check("gate_gemm", A.device, specs)
    A, W = tma_ready(A, W)
    plan = gemm_plan(M, N, K, GATE, card_sms(A.device.index), instance)
    lib = cuda_lib.load("gemm", _SIGNATURES)
    with torch.cuda.device(A.device):
        out = C if C is not None else torch.empty(M, N, device=A.device)
        err = lib.tt_gate_gemm(
            cuda_lib.ptr(A), cuda_lib.ptr(W), cuda_lib.ptr(bias),
            cuda_lib.ptr(out), M, N, K, int(C is not None), c_args([plan]),
            cuda_lib.stream(A.device))
        count([plan])
    cuda_lib.check(lib, err, "gate_gemm kernel")
    return out


def atb_gemm(A, B, shift=0, nsplit=None, instance=None):
    """Partials [nsplit, N1, N2] of A[K, N1]^T B[K, N2] shifted by `shift`
    rows, on `gemm_plan`'s instance and slices (or the forced `instance`,
    and `nsplit` asked for); the caller sums them.  On the CPU,
    `atb_gemm_plain` on the slices the plan gives (at 132 SMs) whatever
    `instance` says."""
    check_instance(instance)
    K, N1 = A.shape
    N2 = B.shape[1]
    if A.device.type == "cpu":
        plan = gemm_plan(N1, N2, K, ATB, SMS_H100, instance, nsplit)
        return atb_gemm_plain(A, B, shift, plan.nsplit, plan.kslice)
    cuda_lib.check_cuda(A, "atb_gemm")
    _check("atb_gemm", A.device, (("A", A, (K, N1)), ("B", B, (K, N2))))
    A, B = tma_ready(A, B)
    plan = gemm_plan(N1, N2, K, ATB, card_sms(A.device.index), instance,
                     nsplit)
    lib = cuda_lib.load("gemm", _SIGNATURES)
    with torch.cuda.device(A.device):
        out = torch.empty(plan.nsplit, N1, N2, device=A.device)
        err = lib.tt_atb_gemm(
            cuda_lib.ptr(A), cuda_lib.ptr(B), cuda_lib.ptr(out), K, N1, N2,
            int(shift), c_args([plan]), cuda_lib.stream(A.device))
        count([plan])
    cuda_lib.check(lib, err, "atb_gemm kernel")
    return out


for _fn in (gate_gemm, atb_gemm):
    _fn.launches = 0
    _fn.by_instance = {k: Launches() for k in INSTANCES}
