"""The two GEMMs under the recurrent layers (taiyaki_tpu_torch/ops/
gemm.py): their plain twins and their plan, on the CPU.

- `gate_gemm_plain` (C = A W^T + bias + C) and `atb_gemm_plain` (the
  partials of A^T B shifted by -B, 0 or +B rows, over 1 or several
  slices) against a numpy f64 product and against `jnp.dot(...,
  precision=HIGHEST)` on the same seeded inputs, at ragged shapes;
- `gemm_plan` at every shape the layers give it at the repo's cells
  (mLstm and mGru training, the trainer defaults at size 384, the
  basecall batch, the remap model's H=96) and at the CUDA tests' ragged
  widths, against the C side's rule restated (csrc/gemm.cuh
  `gate_plan_check` / `atb_plan_check`): "tc" exactly where TMA takes the
  operands, slices whole k tiles that fill the card's SMs, none empty;
- the wrappers' `instance=` on the CPU: the plain twin whatever it says,
  no launch counted; unknown names raise.

Tolerances: the twins are f32 products; against f64, 1e-5 of the largest
|output| (K up to a few hundred rows a product here), against XLA's
HIGHEST-precision f32 product the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu_torch.ops import gemm
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
# the layers' products at the repo's cells: (M, N, K) of gate products
# (input products, d_x, rebuilt gate streams) and (N1, N2, K rows) of atb
# products (d_iW, d_sW), as ops/lstm.py and ops/gru.py ask for them
CELLS = {
    "mLstm training (T=800, B=256, H=D=256)": (
        [(204800, 1024, 256), (204800, 256, 1024), (204600, 1024, 256)],
        [(1024, 256, 204800)]),
    "mGru training (T=2000, B=256)": (
        [(512000, 768, 256), (512000, 256, 768), (511744, 768, 256)],
        [(768, 256, 512000)]),
    "trainer defaults (341 x 600, size 384)": (
        [(204600, 1536, 384), (204600, 384, 1536)],
        [(1536, 384, 204600)]),
    "basecall batch (T=1000, B=128)": ([(128000, 1024, 256)], []),
    "remap model (H=96, T=1000, B=256)": (
        [(256000, 384, 96), (256000, 96, 384), (256000, 288, 96)],
        [(384, 96, 256000), (288, 96, 256000)]),
    # the CUDA tests' ragged widths (D = 7, H = 17) beside tc ones
    "ragged (T=37, B=13, D=7, H=16)": (
        [(481, 64, 7), (481, 7, 64), (468, 64, 16)],
        [(64, 7, 481), (64, 16, 481)]),
    "ragged (T=20, B=5, D=12, H=17)": (
        [(100, 68, 12), (100, 12, 68), (100, 51, 17)],
        [(68, 12, 100), (68, 17, 100), (51, 17, 100)]),
}


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _gate_inputs(M, N, K, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(M, K)).astype(np.float32)
    W = (rng.normal(size=(N, K)) / np.sqrt(K)).astype(np.float32)
    bias = rng.normal(size=N).astype(np.float32)
    C = rng.normal(size=(M, N)).astype(np.float32)
    return A, W, bias, C


@pytest.mark.parametrize("M,N,K", [(37, 13, 7), (129, 96, 100),
                                   (200, 300, 64)])
@pytest.mark.parametrize("with_bias,with_c", [(False, False), (True, False),
                                              (True, True)])
def test_gate_twin_against_f64_and_jax(M, N, K, with_bias, with_c):
    A, W, bias, C = _gate_inputs(M, N, K, M + N + K)
    want = A.astype(np.float64) @ W.astype(np.float64).T
    jx = jnp.dot(jnp.asarray(A), jnp.asarray(W).T,
                 precision="highest")
    if with_bias:
        want = want + bias
        jx = jx + jnp.asarray(bias)
    if with_c:
        want = want + C
        jx = jx + jnp.asarray(C)
    got = gemm.gate_gemm_plain(
        torch.from_numpy(A), torch.from_numpy(W),
        torch.from_numpy(bias) if with_bias else None,
        torch.from_numpy(C) if with_c else None)
    assert got.shape == (M, N) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL
    assert _rel(got.numpy(), np.asarray(jx, np.float64)) < TOL


def _atb_want(A, B, shift, nsplit, kslice):
    K = A.shape[0]
    Bs = np.zeros_like(B, dtype=np.float64)
    lo, hi = max(0, -shift), min(K, K - shift)
    Bs[lo:hi] = B[lo + shift:hi + shift]
    A = A.astype(np.float64)
    return np.stack([A[z * kslice:(z + 1) * kslice].T
                     @ Bs[z * kslice:(z + 1) * kslice]
                     for z in range(nsplit)])


@pytest.mark.parametrize("K,N1,N2,B", [(91, 28, 7, 13), (300, 64, 17, 5),
                                       (481, 40, 36, 37)])
@pytest.mark.parametrize("sign", [-1, 0, 1])
@pytest.mark.parametrize("nsplit", [1, 3, 7])
def test_atb_twin_against_f64_and_jax(K, N1, N2, B, sign, nsplit):
    rng = np.random.default_rng(K + N1 + N2 + nsplit)
    A = rng.normal(size=(K, N1)).astype(np.float32)
    Bm = rng.normal(size=(K, N2)).astype(np.float32)
    shift = sign * B
    kslice = -(-K // nsplit)
    got = gemm.atb_gemm_plain(torch.from_numpy(A), torch.from_numpy(Bm),
                              shift, nsplit, kslice)
    want = _atb_want(A, Bm, shift, nsplit, kslice)
    assert got.shape == (nsplit, N1, N2)
    assert _rel(got.numpy(), want) < TOL
    # the slices add up to the whole product, which XLA forms at HIGHEST
    Bj = jnp.roll(jnp.asarray(Bm), -shift, axis=0)
    keep = (jnp.arange(K) + shift >= 0) & (jnp.arange(K) + shift < K)
    Bj = jnp.where(keep[:, None], Bj, 0.0)
    jx = jnp.dot(jnp.asarray(A).T, Bj, precision="highest")
    assert _rel(got.sum(0).numpy(), np.asarray(jx, np.float64)) < TOL


def test_atb_twin_slices_follow_the_plan():
    """The CPU wrapper slices as the tc plan does: whole k tiles, partials
    that add up to the product."""
    rng = np.random.default_rng(5)
    K, N1, N2 = 1000, 16, 12
    A = rng.normal(size=(K, N1)).astype(np.float32)
    Bm = rng.normal(size=(K, N2)).astype(np.float32)
    got = gemm.atb_gemm(torch.from_numpy(A), torch.from_numpy(Bm), shift=-4,
                        nsplit=3)
    plan = gemm.gemm_plan(N1, N2, K, gemm.ATB, nsplit=3)
    assert plan.instance == "tc" and plan.kslice % gemm.TC_BK == 0
    assert got.shape == (plan.nsplit, N1, N2)
    want = _atb_want(A, Bm, -4, plan.nsplit, plan.kslice)
    assert _rel(got.numpy(), want) < TOL


def _c_side_takes(plan, kind, M, N, K):
    """gate_plan_check / atb_plan_check of csrc/gemm.cuh, restated (the
    pointers' 16-byte alignment aside: the wrappers' tensors and offsets
    keep it wherever rows are a multiple of 4 floats)."""
    if plan.ctas < 0:
        return False
    if kind == gemm.GATE:
        if plan.nsplit != 1 or plan.kslice != 0:
            return False
        if plan.instance == "simt":
            return True
        return plan.instance == "tc" and plan.ctas >= 1 and K % 4 == 0
    n, ks = plan.nsplit, plan.kslice
    if n < 1 or ks < 1 or n * ks < K or (K > 0 and (n - 1) * ks >= K):
        return False
    if plan.instance == "simt":
        return ks == max(1, -(-K // n))
    return (plan.instance == "tc" and plan.ctas >= 1 and ks % 32 == 0
            and M % 4 == 0 and N % 4 == 0)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_at_the_cells(cell, sms):
    gates, atbs = CELLS[cell]
    for M, N, K in gates:
        plan = gemm.gemm_plan(M, N, K, gemm.GATE, sms)
        assert plan.instance == ("tc" if K % 4 == 0 else "simt"), (M, N, K)
        assert _c_side_takes(plan, gemm.GATE, M, N, K)
        if plan.instance == "tc":
            tiles = -(-M // 128) * -(-N // 128)
            assert plan.ctas == min(tiles, sms)
    for N1, N2, K in atbs:
        plan = gemm.gemm_plan(N1, N2, K, gemm.ATB, sms)
        tc = N1 % 4 == 0 and N2 % 4 == 0
        assert plan.instance == ("tc" if tc else "simt"), (N1, N2, K)
        assert _c_side_takes(plan, gemm.ATB, N1, N2, K)
        if not tc:
            continue
        tiles = -(-N1 // 128) * -(-N2 // 128)
        work = tiles * plan.nsplit
        assert plan.ctas == min(work, sms)
        # at the cells' long reductions the slices fill 90% of their waves
        if K >= 100000:
            assert work / (-(-work // sms) * sms) >= gemm.WAVE_FILL
            assert plan.kslice >= gemm.MIN_SLICE


def test_plan_names_the_cells():
    """The plans of the repo's training cells, on the H100 SXM's 132 SMs."""
    def atb(N1, N2, K):
        p = gemm.gemm_plan(N1, N2, K, gemm.ATB)
        return p.instance, p.nsplit, p.kslice, p.ctas
    assert atb(1024, 256, 204800) == ("tc", 8, 25600, 128)
    assert atb(768, 256, 512000) == ("tc", 10, 51200, 120)
    assert atb(1536, 384, 204600) == ("tc", 7, 29248, 132)
    assert atb(384, 96, 256000) == ("tc", 40, 6400, 120)
    assert gemm.gemm_plan(204800, 1024, 256, gemm.GATE) == gemm.GemmPlan(
        gemm.GATE, "tc", 1, 0, 132)
    assert atb(64, 7, 481)[:2] == ("simt", 1)


def test_plan_sweep_against_the_c_rule():
    for kind in (gemm.GATE, gemm.ATB):
        for M in (1, 4, 7, 16, 96, 130):
            for N in (1, 3, 4, 17, 128, 300):
                for K in (0, 1, 4, 31, 32, 33, 2048, 5000, 70001):
                    for nsplit in (None, 1, 3, 64):
                        plan = gemm.gemm_plan(M, N, K, kind, 132,
                                              nsplit=nsplit)
                        assert _c_side_takes(plan, kind, M, N, K), \
                            (kind, M, N, K, nsplit, plan)
                        assert plan.instance == (
                            "tc" if gemm.tc_takes(kind, M, N, K)
                            else "simt")


def test_plan_forced_instances():
    assert gemm.gemm_plan(100, 7, 64, gemm.GATE,
                          instance="simt").instance == "simt"
    assert gemm.gemm_plan(64, 16, 481, gemm.ATB,
                          instance="simt").nsplit == 1
    with pytest.raises(ValueError):
        gemm.gemm_plan(100, 64, 7, gemm.GATE, instance="tc")
    with pytest.raises(ValueError):
        gemm.gemm_plan(64, 7, 481, gemm.ATB, instance="tc")
    with pytest.raises(ValueError):
        gemm.gemm_plan(64, 8, 100, gemm.GATE, instance="cuda")
    with pytest.raises(ValueError):
        gemm.gemm_plan(64, 8, 100, "gemv")


@pytest.mark.parametrize("instance", [None, "simt", "tc"])
def test_wrappers_take_the_twin_on_the_cpu(instance):
    A, W, bias, C = _gate_inputs(50, 24, 12, 3)
    counts = [(fn.launches, {k: v.launches for k, v in
                             fn.by_instance.items()})
              for fn in (gemm.gate_gemm, gemm.atb_gemm)]
    t = [torch.from_numpy(a) for a in (A, W, bias, C)]
    got = gemm.gate_gemm(*t, instance=instance)
    assert torch.equal(got, gemm.gate_gemm_plain(*t))
    B = torch.from_numpy(np.ascontiguousarray(A[:, :8]))
    got = gemm.atb_gemm(t[0], B, shift=5, nsplit=1, instance=instance)
    assert torch.equal(got, gemm.atb_gemm_plain(t[0], B, 5))
    assert counts == [(fn.launches, {k: v.launches for k, v in
                                     fn.by_instance.items()})
                      for fn in (gemm.gate_gemm, gemm.atb_gemm)]
    with pytest.raises(ValueError):
        gemm.gate_gemm(*t, instance="cuda")
    with pytest.raises(ValueError):
        gemm.atb_gemm(t[0], B, instance="l2")
