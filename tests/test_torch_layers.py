"""The port's layers, LSTM and GRU against the JAX package on the CPU, same
seeded numpy inputs and weights.  Tolerances: 1e-5 for one layer (f32, the
same arithmetic in another order), 1e-4 for a whole network."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu import layers as jlayers
from taiyaki_tpu.models import mGru_flipflop as jgru_model
from taiyaki_tpu.models import mLstm_flipflop as jmodel
from taiyaki_tpu.ops import pallas_rnn
from taiyaki_tpu.ops import rnn as jrnn
from taiyaki_tpu_torch import activation as tact
from taiyaki_tpu_torch import layers as tlayers
from taiyaki_tpu_torch.convert import (load_jax_params, params_from_jax,
                                       params_to_jax)
from taiyaki_tpu_torch.models import mGru_flipflop as tgru_model
from taiyaki_tpu_torch.models import mLstm_flipflop as tmodel
from taiyaki_tpu_torch.ops import lstm as tlstm
from taiyaki_tpu_torch.ops import rnn as trnn


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _run(jlayer, tlayer, x, seed=1):
    params = jlayer.init(np.random.default_rng(seed))
    load_jax_params(tlayer, params)
    want = np.asarray(jlayer.apply(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = tlayer(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("stride", [1, 5])
@pytest.mark.parametrize("winlen", [5, 19])
def test_convolution_matches_jax(stride, winlen):
    x = _x((53, 3, 4))
    got, want = _run(jlayers.Convolution(4, 6, winlen, stride=stride),
                     tlayers.Convolution(4, 6, winlen, stride=stride), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_convolution_swish_no_bias_even_winlen():
    x = _x((40, 2, 3))
    got, want = _run(
        jlayers.Convolution(3, 5, 4, fun=jax.nn.swish, has_bias=False),
        tlayers.Convolution(3, 5, 4, fun=tact.swish, has_bias=False), x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_matches_cpu_scan(reverse):
    x = _x((50, 8, 12))
    jl, tl = jlayers.Lstm(12, 16), tlayers.Lstm(12, 16)
    if reverse:
        jl, tl = jlayers.Reverse(jl), tlayers.Reverse(tl)
    got, want = _run(jl, tl, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_matches_pallas_kernel(reverse):
    """Port's LSTM against the TPU kernel itself in interpret mode, time
    padded to its block and sliced back."""
    rng = np.random.default_rng(7)
    T, B, D, H = 45, 8, 12, 16
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    iW = (0.3 * rng.normal(size=(4 * H, D))).astype(np.float32)
    b = rng.normal(size=(4 * H,)).astype(np.float32)
    sW = (0.3 * rng.normal(size=(4 * H, H))).astype(np.float32)
    xp = jrnn._pad_time(jnp.asarray(x), 8)
    h, _ = pallas_rnn.lstm_fused_fwd(
        xp, jnp.asarray(iW), jnp.asarray(b), jnp.asarray(sW), block_t=8,
        interpret=True, reverse=reverse, true_len=T, emit=None)
    got = tlstm.lstm_fwd(*map(torch.from_numpy, (x, iW, b, sW)),
                         reverse=reverse).numpy()
    np.testing.assert_allclose(got, np.asarray(h)[:T], rtol=1e-5,
                               atol=1e-5)


def test_lstm_layer_equals_wrapper_and_no_bias():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(20, 3, 5)).astype(np.float32))
    tl = tlayers.Lstm(5, 4, has_bias=False)
    load_jax_params(tl, jlayers.Lstm(5, 4, has_bias=False).init(rng))
    assert not tl.b.any()
    got = tl(x)
    want = trnn.lstm_layer(x, tl.iW, tl.b, tl.sW)
    assert torch.equal(got, want)


@pytest.mark.parametrize("reverse", [False, True])
def test_grumod_matches_cpu_scan(reverse):
    x = _x((50, 8, 12))
    jl, tl = jlayers.GruMod(12, 17), tlayers.GruMod(12, 17)
    if reverse:
        jl, tl = jlayers.Reverse(jl), tlayers.Reverse(tl)
    got, want = _run(jl, tl, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_grumod_init_draws_the_jax_weights():
    """iW, sW, then b, from one numpy Generator, as the JAX layer draws
    them; has_bias=False draws no b and keeps it zero."""
    for has_bias in (True, False):
        jp = jlayers.GruMod(7, 9, has_bias).init(np.random.default_rng(2))
        tp = tlayers.GruMod(7, 9, has_bias).init(np.random.default_rng(2))
        assert sorted(jp) == sorted(tp) == ["b", "iW", "sW"]
        for k in jp:
            assert tp[k].dtype == jp[k].dtype == np.float32
            np.testing.assert_array_equal(tp[k], jp[k])


def test_mgru_flipflop_matches_net_apply():
    x = _x((300, 4, 1), seed=6)
    jnet = jgru_model.network(size=16, stride=2, winlen=19)
    tnet = tgru_model.network(size=16, stride=2, winlen=19)
    got, want = _run(jnet, tnet, x, seed=12)
    assert tnet.stride == jnet.stride == 2
    assert got.shape == want.shape == (150, 4, 40)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ckpt", [
    "taiyaki_tpu/models/mGru_flipflop_remapping_model_r9_DNA.checkpoint",
    "RESULTS/train_remap_samref/model_final.checkpoint"])
def test_gru_checkpoints_load_and_match_jax(ckpt):
    """The repo's trained GRU checkpoints (the stride-4 remap model of
    size 96, and a stride-2 size-17 model the JAX trainer wrote) load into
    the port, fit its network and give the JAX package's outputs."""
    import os
    from taiyaki_tpu.utils import helpers as jhelpers
    from taiyaki_tpu_torch.utils import helpers as thelpers
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ckpt)
    jnet, jparams, *_ = jhelpers.load_model(path)
    tnet, tparams, *_ = thelpers.load_model(path)
    load_jax_params(tnet, tparams)
    assert tnet.stride == jnet.stride
    assert isinstance(tnet.sublayers[2], tlayers.GruMod)
    x = _x((400, 3, 1), seed=13)
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x)))
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_global_norm_flipflop_matches_jax():
    x = _x((30, 4, 16))
    got, want = _run(jlayers.GlobalNormFlipFlop(16, 4),
                     tlayers.GlobalNormFlipFlop(16, 4), x)
    assert got.shape == (30, 4, 40)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mlstm_flipflop_matches_net_apply():
    x = _x((600, 4, 1), seed=5)
    jnet = jmodel.network(size=16, stride=5, winlen=19)
    tnet = tmodel.network(size=16, stride=5, winlen=19)
    got, want = _run(jnet, tnet, x, seed=11)
    assert tnet.stride == jnet.stride == 5
    assert got.shape == want.shape == (120, 4, 40)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_run_model_matches_jax():
    """basecall_helpers.run_model: chunk, forward, stitch (atol 1e-4)."""
    from taiyaki_tpu import basecall_helpers as jbh
    from taiyaki_tpu_torch import basecall_helpers as tbh
    signal = _x((2300,), seed=8)
    jnet = jmodel.network(size=8, stride=5, winlen=9)
    tnet = tmodel.network(size=8, stride=5, winlen=9)
    params = jnet.init(np.random.default_rng(6))
    load_jax_params(tnet, params)
    want = jbh.run_model(signal, jnet, params, chunk_size=100, overlap=20,
                         max_concur_chunks=3)
    got = tbh.run_model(signal, tnet, chunk_size=100, overlap=20,
                        max_concur_chunks=3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_init_draws_the_jax_weights():
    jp = jmodel.network(size=16).init(np.random.default_rng(4))
    tp = tmodel.network(size=16).init(np.random.default_rng(4))
    jl, jt = jax.tree_util.tree_flatten(jp)
    tl, tt = jax.tree_util.tree_flatten(tp)
    assert jt == tt
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)


def test_params_round_trip():
    net = tmodel.network(size=8)
    params = net.init(np.random.default_rng(2))
    state = params_from_jax(net, params)
    assert list(state) == list(net.state_dict())
    load_jax_params(net, params)
    back = params_to_jax(net)
    jl, jt = jax.tree_util.tree_flatten(params)
    bl, bt = jax.tree_util.tree_flatten(back)
    assert jt == bt
    for a, b in zip(jl, bl):
        np.testing.assert_array_equal(a, b)


def test_params_mismatch_raises():
    net = tmodel.network(size=8)
    params = tmodel.network(size=16).init(np.random.default_rng(0))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(net, params)
    del params["sublayers"][0]["b"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(net, params)


@pytest.mark.parametrize("name", ["FeedForward", "CudnnGru", "Parallel",
                                  "GlobalNormFlipFlopCatMod"])
def test_unported_layer_raises(name):
    with pytest.raises(NotImplementedError, match=name):
        getattr(tlayers, name)(4, 4)


def test_reverse_of_non_recurrent_layer_flips():
    x = _x((21, 2, 3))
    got, want = _run(jlayers.Reverse(jlayers.Convolution(3, 4, 5)),
                     tlayers.Reverse(tlayers.Convolution(3, 4, 5)), x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
