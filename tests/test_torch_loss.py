"""The port's reference losses (loss.py) against the JAX package's
(taiyaki_tpu/loss.py), values and autograd gradients against jax.grad,
with sharpening; and the port's flipflop_loss against its own
kernel-route CRF loss (ops/flipflop.crf_flipflop_loss), as the JAX
package's tests/test_loss_reference.py holds its pair.

Tolerances: values 1e-5 relative, gradients 1e-4 of their largest (f32
loops over the same recursion); the kernel route 1e-4 relative + 1e-5
(its lattice in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu import loss as jloss
from taiyaki_tpu_torch import flipflopfings, loss
from taiyaki_tpu_torch.ops import flipflop as ffops
# one_torch_thread is an autouse fixture
from test_torch_cli import one_torch_thread  # noqa: F401


def _flipflop_case(seed, T=12, B=3, L=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, 40)).astype(np.float32)
    seqs = np.stack([flipflopfings.flipflop_code(rng.integers(0, 4, size=L))
                     for _ in range(B)])
    move_idx = np.stack([flipflopfings.move_indices(s) for s in seqs])
    stay_idx = np.stack([flipflopfings.stay_indices(s) for s in seqs])
    seqlens = np.array([L, L - 2, 1][:B], dtype=np.int32)
    return x, seqs, move_idx, stay_idx, seqlens


def _ctc_case(seed, T=10, B=3, L=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, 5)).astype(np.float32)
    seqs = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    seqlens = np.array([L, 2, 0][:B], dtype=np.int32)
    return x, seqs, seqlens


def _port(fn, x, *args, sharp):
    xt = torch.tensor(x, requires_grad=True)
    cost = fn(xt, *(torch.from_numpy(np.asarray(a)) for a in args),
              sharp=sharp)
    (grad,) = torch.autograd.grad(cost.sum(), xt)
    return cost.detach().numpy(), grad.numpy()


def _jax(fn, x, *args, sharp):
    args = [jnp.asarray(a) for a in args]
    cost = fn(x, *args, sharp=sharp)
    grad = jax.grad(lambda v: jnp.sum(fn(v, *args, sharp=sharp)))(
        jnp.asarray(x))
    return np.asarray(cost), np.asarray(grad)


def _match(got, want):
    (cost, grad), (jcost, jgrad) = got, want
    np.testing.assert_allclose(cost, jcost, rtol=1e-5)
    assert np.abs(grad - jgrad).max() <= 1e-4 * np.abs(jgrad).max()


@pytest.mark.parametrize("sharp", [1.0, 2.0])
def test_flipflop_loss_matches_jax(sharp):
    x, _, move_idx, stay_idx, seqlens = _flipflop_case(0)
    args = (move_idx, stay_idx, seqlens)
    _match(_port(loss.flipflop_loss, x, *args, sharp=sharp),
           _jax(jloss.flipflop_loss, x, *args, sharp=sharp))


@pytest.mark.parametrize("sharp", [1.0, 2.0])
def test_ctc_loss_matches_jax(sharp):
    x, seqs, seqlens = _ctc_case(1)
    _match(_port(loss.ctc_loss, x, seqs, seqlens, sharp=sharp),
           _jax(jloss.ctc_loss, x, seqs, seqlens, sharp=sharp))


def test_sharpening_scales_the_scores():
    x, _, move_idx, stay_idx, seqlens = _flipflop_case(2, T=8, B=2, L=4)
    args = [torch.from_numpy(a) for a in (move_idx, stay_idx, seqlens)]
    a = loss.flipflop_loss(torch.from_numpy(x), *args, sharp=2.0)
    b = loss.flipflop_loss(torch.from_numpy(2.0 * x), *args) / 2.0
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)


def test_flipflop_loss_matches_the_kernel_route():
    """The numerator of the port's CRF loss (its kernels' plain twins on
    the CPU) equals the reference loop's."""
    x, seqs, move_idx, stay_idx, seqlens = _flipflop_case(3, B=3)
    seqlens[:] = seqs.shape[1]
    ref = loss.flipflop_loss(torch.from_numpy(x), torch.from_numpy(move_idx),
                             torch.from_numpy(stay_idx),
                             torch.from_numpy(seqlens))
    fast = ffops.crf_flipflop_loss(torch.from_numpy(x),
                                   torch.from_numpy(seqs),
                                   torch.from_numpy(seqlens))
    np.testing.assert_allclose(ref.numpy(), fast.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_ctc_needs_five_features():
    with pytest.raises(ValueError, match="5 features"):
        loss.ctc_loss(torch.zeros(3, 1, 4), np.zeros((1, 2), np.int32),
                      np.ones(1, np.int32))
