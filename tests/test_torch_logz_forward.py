"""The arithmetic of the redesigned logZ forward kernels, on the CPU.

Row 2 (`logz_fwd`, csrc/logz.cu) cuts T into segments: the transfer of
every segment but the last, a serial pass over the segments for each
one's start vector, each segment rerun from it, logZ the segments' sums
added in segment order.  Its plain mirror `ops.logz.logz_fwd_segmented`
is held against the port's twin `logz_fwd_plain` and against the TPU
kernel `pallas_logz.logz_forward` in interpret mode: nbase 1, 2, 4 and 8
(at 8 the 144 transitions exceed the TPU kernel's 128 lanes, so its logZ
is held against the JAX package's scan, `flipflop_logz` less log 8);
T of one step, of one segment and one step past it, many segments; and a
row with no path (-inf scores), which keeps -inf where the TPU kernel's
padding gives -1e30.

Same seeded numpy inputs for every package.  Tolerances: logZ 1e-3 +
1e-5 |logZ| (a sum of T renormalisers in f32, in another order);
lattice and fwd_final atol 1e-4."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu.ops import flipflop as jff
from taiyaki_tpu.ops import pallas_logz
from taiyaki_tpu_torch.ops import logz
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse)


def _scores(T, B, nbase, seed, no_path=None):
    rng = np.random.default_rng(seed)
    S = 2 * nbase * (nbase + 1)
    s = (5.0 * np.tanh(rng.normal(size=(T, B, S)))).astype(np.float32)
    if no_path is not None:
        s[:, no_path] = -np.inf
    return s


@functools.lru_cache(maxsize=None)
def _jax_forward(T, B, nbase, seed, no_path):
    """The TPU kernel's (fwd_final, logZ, lattice) in interpret mode,
    sliced back from its lane and time padding (computed once a case);
    past its 128 lanes (nbase 8) (None, the JAX scan's logZ without the
    log(nbase) term, None)."""
    s = _scores(T, B, nbase, seed, no_path)
    if s.shape[2] > pallas_logz.LANES:
        z = np.asarray(jff.flipflop_logz(jnp.asarray(s))) - math.log(nbase)
        return None, z, None
    bt = pallas_logz.DEFAULT_BLOCK_T
    scores_p = jff._logz_pad_scores(jnp.asarray(s), bt, dtype=jnp.float32)
    fwd_p, logz_p, lattice_p = pallas_logz.logz_forward(
        scores_p, nbase, block_t=bt, interpret=True)
    nff = 2 * nbase
    return (np.asarray(fwd_p)[:, :nff], np.asarray(logz_p),
            np.asarray(lattice_p)[:T, :, :nff])


def _close_logz(got, want):
    ok = np.isfinite(want)
    assert (np.isfinite(got) == ok).all()
    tol = 1e-3 + 1e-5 * np.abs(want[ok]).max(initial=0.0)
    assert np.abs(got[ok] - want[ok]).max(initial=0.0) <= tol


def _close_states(got, want):
    """States within 1e-4; -inf in the port where the TPU kernel holds
    -1e30 (or -inf)."""
    got = np.maximum(got, -1e30)
    want = np.maximum(want, -1e30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# (nbase, T, segment): T of one step, of one segment, one segment and one
# step more, for each nbase; then many segments, T not a multiple of one
SEGMENTED = [(1, 1, 4), (1, 4, 4), (1, 5, 4), (2, 1, 4), (2, 4, 4),
             (2, 5, 4), (4, 1, 16), (4, 16, 16), (4, 17, 16), (8, 1, 3),
             (8, 3, 3), (8, 4, 3), (4, 37, 8), (2, 40, 7), (8, 23, 5)]


@pytest.mark.parametrize("nbase,T,segment", SEGMENTED)
def test_segmented_forward_matches_twin_and_pallas(nbase, T, segment):
    B = 5
    seed = 7 * T + nbase
    s = torch.from_numpy(_scores(T, B, nbase, seed))
    f0, z0, l0 = logz.logz_fwd_plain(s, nbase)
    f1, z1, l1 = logz.logz_fwd_segmented(s, nbase, segment)
    _close_logz(z1.numpy(), z0.numpy())
    torch.testing.assert_close(l1, l0, rtol=0, atol=1e-4)
    torch.testing.assert_close(f1, f0, rtol=0, atol=1e-4)
    fp, zp, lp = _jax_forward(T, B, nbase, seed, None)
    _close_logz(z1.numpy(), zp)
    if lp is not None:
        _close_states(l1.numpy(), lp)
        _close_states(f1.numpy(), fp)


@pytest.mark.parametrize("nbase,T,segment", [(4, 37, 8), (2, 20, 3),
                                             (8, 9, 4)])
def test_segmented_forward_no_path_row(nbase, T, segment):
    """A row of -inf scores: logZ and every state -inf, no NaN; the other
    rows as the twin's and the TPU kernel's."""
    B = 4
    seed = 7 * T + nbase
    s = torch.from_numpy(_scores(T, B, nbase, seed, no_path=2))
    f0, z0, l0 = logz.logz_fwd_plain(s, nbase)
    f1, z1, l1 = logz.logz_fwd_segmented(s, nbase, segment)
    assert z1[2] == -math.inf
    assert (f1[2] == -math.inf).all()
    assert not torch.isnan(l1).any() and not torch.isnan(z1).any()
    _close_logz(z1.numpy(), z0.numpy())
    _close_states(l1.numpy(), l0.numpy())
    _close_states(f1.numpy(), f0.numpy())
    keep = [0, 1, 3]
    fp, zp, lp = _jax_forward(T, B, nbase, seed, 2)
    _close_logz(z1.numpy()[keep], zp[keep])
    if lp is not None:
        _close_states(l1.numpy()[:, keep], lp[:, keep])
        _close_states(f1.numpy()[keep], fp[keep])


def test_segmented_forward_without_lattice():
    """The same fwd_final and logZ, bitwise, with and without the
    lattice, as the kernels give them."""
    s = torch.from_numpy(_scores(30, 3, 4, seed=3))
    f1, z1, l1 = logz.logz_fwd_segmented(s, 4, 7)
    f2, z2, none = logz.logz_fwd_segmented(s, 4, 7, emit_lattice=False)
    assert none is None and l1.shape == (30, 3, 8)
    assert torch.equal(f1, f2) and torch.equal(z1, z2)


def test_segmented_forward_empty_sequence():
    """T = 0: the start vector and logZ 0, as the twin."""
    s = torch.zeros(0, 3, 40)
    f1, z1, l1 = logz.logz_fwd_segmented(s, 4, 16)
    f0, z0, _ = logz.logz_fwd_plain(s, 4)
    assert torch.equal(f1, f0) and torch.equal(z1, z0)
    assert l1.shape == (0, 3, 8)
