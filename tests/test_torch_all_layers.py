"""Every layer of taiyaki_tpu/layers.py against the port's on the CPU, same
numpy-seeded weights (put through `params_from_jax`) and inputs: forward
(1e-5), gradients against `jax.grad` for each layer with parameters (1e-5
of each one's largest), the JSON export (`json.dumps` equal strings), the
weights `init` draws; a network of every layer (chip_smoke.py's
ALL_LAYERS_SOURCE) through a training step's output, loss and gradients;
`guess_model_stride` and `is_delta_model`."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu import activation as jact
from taiyaki_tpu import alphabet as jalphabet
from taiyaki_tpu import layers as jlayers
from taiyaki_tpu import train as jtrain
from taiyaki_tpu.models import mLstm_flipflop as jmodel
from taiyaki_tpu.utils import helpers as jhelpers
from taiyaki_tpu.utils.json import JsonEncoder as JJsonEncoder
from taiyaki_tpu_torch import activation as tact
from taiyaki_tpu_torch import alphabet as talphabet
from taiyaki_tpu_torch import layers as tlayers
from taiyaki_tpu_torch import train as ttrain
from taiyaki_tpu_torch.convert import (flat_params, leaf_names,
                                       load_jax_params)
from taiyaki_tpu_torch.models import mLstm_flipflop as tmodel
from taiyaki_tpu_torch.utils import helpers as thelpers
from taiyaki_tpu_torch.utils.json import JsonEncoder as TJsonEncoder

# one_torch_thread is an autouse fixture
from test_torch_cli import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, NB, D = 24, 3, 8
MODALPHABET = ("AYCZGT", "AACCGT", ["6mA", "5mC"])


def _both(make):
    """make(layers, activation, alphabet) for each package: (JAX layer,
    port layer)."""
    return (make(jlayers, jact, jalphabet), make(tlayers, tact, talphabet))


def _ff(L, m=5, **kw):
    return L.FeedForward(D, m, **kw)


# name: (make(layers, activation, alphabet), input shape)
CASES = {
    "FeedForward": (lambda L, A, _: L.FeedForward(D, 6, fun=A.tanh),
                    (T, NB, D)),
    "FeedForward_no_bias": (lambda L, A, _: L.FeedForward(
        D, 6, has_bias=False), (T, NB, D)),
    "Softmax": (lambda L, A, _: L.Softmax(D, 6), (T, NB, D)),
    "Softmax_no_bias": (lambda L, A, _: L.Softmax(D, 6, has_bias=False),
                        (T, NB, D)),
    "TimeLinear": (lambda L, A, _: L.TimeLinear(T, 10, fun=A.tanh),
                   (T, NB, D)),
    "TimeLinear_no_bias": (lambda L, A, _: L.TimeLinear(
        T, 10, has_bias=False), (T, NB, D)),
    "Identity": (lambda L, A, _: L.Identity(A.swish), (T, NB, D)),
    "Studentise": (lambda L, A, _: L.Studentise(), (T, NB, D)),
    "DeltaSample": (lambda L, A, _: L.DeltaSample(), (T, NB, D)),
    "Window": (lambda L, A, _: L.Window(5), (T, NB, D)),
    "UpSample": (lambda L, A, _: L.UpSample(2), (T, NB, D)),
    "DownSample": (lambda L, A, _: L.DownSample(3), (T, NB, D)),
    "Parallel": (lambda L, A, _: L.Parallel([
        _ff(L, m=3), L.Softmax(D, 4), L.Identity()]), (T, NB, D)),
    "Product": (lambda L, A, _: L.Product([
        _ff(L, fun=A.sigmoid), _ff(L, has_bias=False)]), (T, NB, D)),
    "Residual": (lambda L, A, _: L.Residual(L.Lstm(D, D)), (T, NB, D)),
    "GatedResidual": (lambda L, A, _: L.GatedResidual(
        L.CudnnGru(D, D), gate_init=0.7), (T, NB, D)),
    "SoftChoice": (lambda L, A, _: L.SoftChoice([
        _ff(L, m=D, fun=A.tanh), L.Identity(A.tanh),
        L.GruMod(D, D)]), (T, NB, D)),
    "CudnnGru": (lambda L, A, _: L.CudnnGru(D, 7), (T, NB, D)),
    "CudnnGru_no_bias": (lambda L, A, _: L.CudnnGru(D, 7, has_bias=False),
                         (T, NB, D)),
    "Reverse_CudnnGru": (lambda L, A, _: L.Reverse(L.CudnnGru(D, 7)),
                         (T, NB, D)),
    "birnn": (lambda L, A, _: L.birnn(L.GruMod(D, 5), L.Lstm(D, 4)),
              (T, NB, D)),
    "DownUpSample": (lambda L, A, _: L.DownUpSample(
        L.FeedForward(2 * D, 2 * D, fun=A.tanh), 2), (T, NB, D)),
    # the layers of the earlier slices, for their JSON export
    "Serial": (lambda L, A, _: L.Serial([
        L.Convolution(D, 6, 5, stride=2, fun=A.swish),
        L.Reverse(L.Lstm(6, 4))]), (T, NB, D)),
    "Convolution_no_bias": (lambda L, A, _: L.Convolution(
        D, 6, 4, has_bias=False), (T, NB, D)),
    "GruMod": (lambda L, A, _: L.GruMod(D, 5), (T, NB, D)),
    "Lstm_no_bias": (lambda L, A, _: L.Lstm(D, 5, has_bias=False),
                     (T, NB, D)),
    "GlobalNormFlipFlop": (lambda L, A, _: L.GlobalNormFlipFlop(D, 4),
                           (T, NB, D)),
    "GlobalNormFlipFlopCatMod": (
        lambda L, A, AL: L.GlobalNormFlipFlopCatMod(
            D, AL.AlphabetInfo(*MODALPHABET)), (T, NB, D)),
}
# the layers above but the earlier slices' that hold parameters of their
# own or in their sublayers: their gradients are held against jax.grad
GRAD_CASES = ["FeedForward", "FeedForward_no_bias", "Softmax", "TimeLinear",
              "Parallel", "Product", "Residual", "GatedResidual",
              "SoftChoice", "CudnnGru", "CudnnGru_no_bias",
              "Reverse_CudnnGru", "DownUpSample"]


def _case(name, seed=1):
    make, shape = CASES[name]
    jl, tl = _both(make)
    params = jl.init(np.random.default_rng(seed))
    load_jax_params(tl, params)
    x = np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)
    return jl, tl, params, x


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_forward_matches_jax(name):
    jl, tl, params, x = _case(name)
    want = np.asarray(jl.apply(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = tl(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_layer_gradients_match_jax(name):
    """d/d(params, x) of sum(y * dy): each within 1e-5 of its largest."""
    jl, tl, params, x = _case(name)
    y_shape = np.asarray(jl.apply(params, jnp.asarray(x))).shape
    dy = np.random.default_rng(9).normal(size=y_shape).astype(np.float32)

    def f(p, xx):
        return jnp.sum(jl.apply(p, xx) * dy)
    jg_params, jg_x = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    want = flat_params(jax.tree.map(np.asarray, jg_params))

    xt = torch.from_numpy(x).requires_grad_()
    named = dict(tl.named_parameters())
    (tl(xt) * torch.from_numpy(dy)).sum().backward()
    assert set(named) == set(want)
    pairs = [("x", xt.grad.numpy(), np.asarray(jg_x))] + [
        (k, np.zeros_like(want[k]) if p.grad is None else p.grad.numpy(),
         want[k]) for k, p in named.items()]
    for key, got, w in pairs:
        assert got.shape == w.shape, key
        assert np.abs(got - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), \
            key


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_json_matches_jax(name):
    """The port's `json()` dumps to the string the JAX layer's
    `json(params)` dumps to, for the same weights."""
    jl, tl, params, _ = _case(name)
    want = json.dumps(jl.json(params), cls=JJsonEncoder)
    assert json.dumps(tl.json(), cls=TJsonEncoder) == want
    assert json.dumps(tl.json(), cls=JJsonEncoder) == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_init_draws_the_jax_weights(name):
    """The same pytree from one seed, whose keys are the module's
    state_dict (no `b` where has_bias=False for the linear layers)."""
    make, _ = CASES[name]
    jl, tl = _both(make)
    jp = flat_params(jl.init(np.random.default_rng(3)))
    tp = flat_params(tl.init(np.random.default_rng(3)))
    assert list(jp) == list(tp)
    assert set(tp) == set(tl.state_dict())
    for k in jp:
        assert tp[k].dtype == np.float32
        np.testing.assert_array_equal(tp[k], jp[k])
    if name.endswith("_no_bias") and "Lstm" not in name \
            and "CudnnGru" not in name:
        assert "b" not in tp


def test_no_layer_raises_not_ported():
    """Every public class and helper of the JAX layers module has a
    counterpart in the port."""
    names = [n for n in vars(jlayers) if not n.startswith("_")
             and callable(getattr(jlayers, n))
             and getattr(getattr(jlayers, n), "__module__", "")
             == jlayers.__name__]
    assert "CudnnGru" in names and "guess_model_stride" in names
    assert [n for n in names if not hasattr(tlayers, n)] == []


# -- a network of every layer ---------------------------------------------------

def _all_layers_source():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ALL_LAYERS_SOURCE


@pytest.fixture(scope="module")
def all_layers(tmp_path_factory):
    """chip_smoke.py's network of every layer at size 16, stride 5, in both
    packages, from one seed."""
    path = tmp_path_factory.mktemp("all_layers") / "all_layers.py"
    path.write_text(thelpers.canonical_source(_all_layers_source()))
    kwargs = dict(insize=1, size=16, winlen=19, stride=5)
    jnet = jhelpers.new_model(str(path), **kwargs)[0]
    tnet = thelpers.new_model(str(path), **kwargs)[0]
    params = jnet.init(np.random.default_rng(4))
    return jnet, params, load_jax_params(tnet, params)


def _batch(seed=2, n=4, chunk_len=500):
    """A seeded batch of the repo's mapped reads, drawn by the JAX
    sampler, with one padding row."""
    from taiyaki_tpu.data import chunk_selection as jcs
    from taiyaki_tpu.data import mapped_signal_files as jmsf
    reads_file = os.path.join(REPO, "RESULTS", "training_ingredients",
                              "mapped_remap_samref.hdf5")
    with jmsf.MappedSignalReader(reads_file) as msr:
        alphabet = msr.get_alphabet_information()
        reads = list(msr.reads())
    np.random.seed(seed)
    fp = jcs.sample_filter_parameters(reads, 50, chunk_len, 3.0, 10.0, 0.5,
                                      5, 1.1)
    batch, _ = jtrain.sample_batch(reads, chunk_len, n,
                                   jtrain.max_seqlen_for_chunk(chunk_len, 5),
                                   alphabet, fp, seqlen_granularity=128)
    batch = jtrain.Batch(batch.signal, batch.seqs, batch.seqlens.copy(),
                         None)
    batch.seqlens[-1] = 0
    return batch


def test_all_layers_network_matches_jax(all_layers):
    """Output (1e-4), training loss (1e-5 relative) and every gradient in
    the JAX leaf order (1e-4 of its largest)."""
    jnet, params, tnet = all_layers
    assert jnet.stride == tnet.stride == 5
    assert [type(l).__name__ for l in tnet.sublayers] == \
        [type(l).__name__ for l in jnet.sublayers]
    batch = _batch()
    want = np.asarray(jnet.apply(params, jnp.asarray(batch.signal)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(batch.signal)).numpy()
    assert got.shape == want.shape == (100, 4, 40)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    jbatch = jtrain.Batch(*(None if a is None else jnp.asarray(a)
                            for a in batch))
    jloss, jgrads = jax.value_and_grad(jtrain.make_loss_fn(jnet))(
        params, jbatch, 1.0)
    tloss, tgrads = ttrain.make_grad_step(tnet)(
        ttrain.batch_to_device(batch, torch.device("cpu")), 1.0)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads) == len(leaf_names(tnet))
    for name, g, w in zip(leaf_names(tnet), tgrads, jleaves):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.abs(g.numpy() - w).max() <= \
            1e-4 * max(np.abs(w).max(), 1e-30), name


def test_all_layers_json_matches_jax(all_layers):
    jnet, params, tnet = all_layers
    assert json.dumps(tnet.json(), cls=TJsonEncoder, indent=4) == \
        json.dumps(jnet.json(params), cls=JJsonEncoder, indent=4)


# -- helpers ---------------------------------------------------------------------

def _stride_nets(which):
    if which == "DownUpSample":
        return _both(lambda L, A, _: L.Serial([
            L.Convolution(1, 8, 5, stride=3, fun=A.tanh),
            L.DownUpSample(L.FeedForward(16, 16), 2),
            L.GlobalNormFlipFlop(8, 4)]))
    if which == "DeltaSample":
        return _both(lambda L, A, _: L.Serial([
            L.DeltaSample(), L.Window(3),
            L.Convolution(3, 8, 5, stride=2), L.GlobalNormFlipFlop(8, 4)]))
    return (jmodel.network(size=8, stride=which),
            tmodel.network(size=8, stride=which))


@pytest.mark.parametrize("which", [1, 2, 5, "DownUpSample", "DeltaSample"])
def test_guess_model_stride_matches_jax(which):
    jnet, tnet = _stride_nets(which)
    params = jnet.init(np.random.default_rng(0))
    want = jlayers.guess_model_stride(jnet, params)
    assert want == jhelpers.guess_model_stride(jnet)
    assert tlayers.guess_model_stride(tnet) == want
    load_jax_params(tnet, params)
    assert thelpers.guess_model_stride(tnet) == want == tnet.stride
    assert tlayers.is_delta_model(tnet) == jlayers.is_delta_model(jnet) \
        == (which == "DeltaSample")
