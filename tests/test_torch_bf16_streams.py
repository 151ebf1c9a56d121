"""The LSTM layers' bf16 streams (TAIYAKI_TPU_BF16_STREAMS=1, ops/rnn.py)
on the CPU against the JAX package's mixed precision, which it runs on
the CPU under TAIYAKI_TPU_PALLAS_INTERPRET=1 with B a multiple of 8, on
the same seeded numpy inputs:

(a) the plain twins of kernels 1 (every emit mode), 4, 11 and 12 against
    `pallas_rnn.<kernel>(..., interpret=True)` called with the JAX
    layer's dtypes (residual_dtype and h_dtype bf16, dh and x bf16, or x
    f32 as the first layer's): every output's dtype the JAX kernel's,
    the f32 outputs (weight partials summed, d_b) within the f32
    tolerances of tests/test_torch_scan.py (rtol 1e-4, atol 1e-5; d_sW
    atol 1e-4), the bf16 outputs equal as bf16 but for at most 1% of
    them one bf16 step apart (`bf16_close`: the f32 values before the
    rounding differ by the order of their sums);
(b) `ops.rnn.lstm_layer` under the switch against
    `taiyaki_tpu.ops.rnn.lstm_layer` through `jax.vjp`, under each
    residual policy: h and every gradient within half of the JAX route's
    own distance from its f32 route (~2e-3 to 6e-3 of each one's
    largest; the port's ~1e-6);
(c) each JAX sub-switch (TAIYAKI_TPU_F32_GATES=1, TAIYAKI_TPU_BF16_ACTS=0,
    TAIYAKI_TPU_F32_GRADS=1) gives the kernels of a 2-layer stack the
    dtypes the JAX route gives its kernels;
(d) the bytes the LSTM layers of a 2-layer stack save for the backward
    (saved_tensors_hooks, each storage once) at most 0.55 of those saved
    with the switch unset;
(e) one training step of a size-16 mLstm_flipflop (B=8, chunks of 500
    samples) under the switch against the JAX package's: the loss within
    5e-3 relative and each gradient within 2e-2 of its largest, the JAX
    route's own distance from its f32 step beside them (both CRFs and
    logZs round their scores to bf16 under the mixed precision:
    tests/test_torch_bf16_scores.py);
(f) `lstm_scan` and `gru_scan` raise under the switch, naming it, while
    the GRU layer under grad and with a bf16 act stream run (their bf16
    instances: tests/test_torch_bf16_gru.py); a bf16 tensor given to a
    kernel with no bf16 instance raises; the switch unset, the layer is
    the f32 one bit for bit; the inference CLIs' opt-out
    (`rnn.f32_inference`) keeps a basecall's forward f32 and equal to
    the unswitched one, and leaves the environment as it found it;
and the layers that can follow an LSTM take its bf16 h as JAX promotion
does (bf16 beside an f32 parameter gives f32), against the JAX layers.
"""

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
from taiyaki_tpu.ops import pallas_rnn
from taiyaki_tpu.ops import rnn as jrnn
from taiyaki_tpu_torch import activation as tact
from taiyaki_tpu_torch import alphabet as talphabet
from taiyaki_tpu_torch import layers as tlayers
from taiyaki_tpu_torch import train as ttrain
from taiyaki_tpu_torch.convert import leaf_names, load_jax_params
from taiyaki_tpu_torch.models import mLstm_flipflop as tmodel
from taiyaki_tpu_torch.ops import gru as tgru
from taiyaki_tpu_torch.ops import lstm as tlstm
from taiyaki_tpu_torch.ops import rnn as trnn
from test_torch_all_layers import MODALPHABET, _batch
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse)

BT = 8                      # the TPU kernels' time block
T, B, D, H = 24, 8, 12, 16
BF16, F32 = torch.bfloat16, torch.float32
SWITCH = "TAIYAKI_TPU_BF16_STREAMS"
SUB_SWITCHES = ("TAIYAKI_TPU_F32_GATES", "TAIYAKI_TPU_BF16_ACTS",
                "TAIYAKI_TPU_F32_GRADS", "TAIYAKI_TPU_ACTS_BWD",
                "TAIYAKI_TPU_RECOMPUTE", "TAIYAKI_TPU_NO_RECOMPUTE",
                "TAIYAKI_TPU_F32_SCORES", "TAIYAKI_TPU_PALLAS_INTERPRET")
BF16_SHARE = 0.01           # of a bf16 output one bf16 step apart, at most
DIRS = [False, True]


@pytest.fixture(autouse=True)
def clean_switches(monkeypatch):
    """Every test starts with the switches unset."""
    for k in (SWITCH,) + SUB_SWITCHES:
        monkeypatch.delenv(k, raising=False)


def _inputs(seed, t=T, b=B, d=D, h=H):
    """x [t, b, d], iW [4h, d], b [4h], sW [4h, h], dh [t, b, h]."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, b, d)).astype(np.float32),
            (rng.normal(size=(4 * h, d)) / np.sqrt(d)).astype(np.float32),
            (0.5 * rng.normal(size=4 * h)).astype(np.float32),
            (rng.normal(size=(4 * h, h)) / np.sqrt(h)).astype(np.float32),
            rng.normal(size=(t, b, h)).astype(np.float32))


def _to_jax(t):
    """A port tensor as a JAX array of the same dtype."""
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _to_torch(a):
    """A JAX array as a port tensor of the same dtype."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(BF16)
    return torch.from_numpy(np.array(a))


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def bf16_close(got, want, atol, share=BF16_SHARE):
    """Two bf16 tensors equal but for at most `share` of their elements,
    each at most one bf16 step (of the larger magnitude) or `atol`
    apart."""
    assert got.dtype == want.dtype == BF16
    g, w = got.float(), want.float()
    step = torch.ldexp(torch.ones_like(w), torch.frexp(
        torch.maximum(g.abs(), w.abs()))[1] - 8)
    diff = (g - w).abs()
    assert bool((diff <= torch.maximum(step, torch.full_like(step, atol)))
                .all()), diff.max().item()
    assert (diff > 0).float().mean().item() <= share


def _f32_close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


# -- (a) the twins against the TPU kernels in interpret mode ----------------

# the port's emit modes and the JAX kernel's (emit=None there gives h, c)
EMITS = {None: None, "c": None, "pre": "pre", "acts": "acts"}


@pytest.mark.parametrize("x_dtype", [F32, BF16], ids=["x32", "x16"])
@pytest.mark.parametrize("reverse", DIRS)
@pytest.mark.parametrize("emit", list(EMITS), ids=str)
def test_fwd_twin_matches_pallas_kernel(emit, reverse, x_dtype):
    """Kernel 1's twin with bf16 h and residuals against
    pallas_rnn.lstm_fused_fwd: every output bf16, as bf16 equal."""
    x, iW, b, sW, _ = _inputs(1)
    xt = torch.from_numpy(x).to(x_dtype)
    got = tlstm.lstm_fwd(xt, *map(torch.from_numpy, (iW, b, sW)),
                         reverse=reverse, emit=emit, h_dtype=BF16,
                         res_dtype=BF16)
    want = pallas_rnn.lstm_fused_fwd(
        _to_jax(xt), *map(jnp.asarray, (iW, b, sW)), block_t=BT,
        interpret=True, residual_dtype=jnp.bfloat16, reverse=reverse,
        true_len=T, h_dtype=jnp.bfloat16, emit=EMITS[emit])
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(tlstm.RESIDUALS[emit]) + 1
    for g, w in zip(got, want):
        w = _to_torch(w)
        assert g.dtype == w.dtype == BF16
        bf16_close(g, w, 1e-6)


def _bwd_case(kind, reverse, x_dtype):
    """(port args, JAX kernel, JAX args) of backward `kind` on the bf16
    forward's own residuals, dh bf16."""
    x, iW, b, sW, dh = _inputs(2)
    xt = torch.from_numpy(x).to(x_dtype)
    iWt, bt, sWt = map(torch.from_numpy, (iW, b, sW))
    h, c, acts, tc = tlstm.lstm_fwd_plain(xt, iWt, bt, sWt, reverse,
                                          "acts", BF16, BF16)
    pre = tlstm.lstm_fwd_plain(xt, iWt, bt, sWt, reverse, "pre", BF16,
                               BF16)[2]
    c_prev = tlstm.prev_state(c, reverse)
    dht = torch.from_numpy(dh).to(BF16)
    if kind == "acts":
        args = (dht, acts, tc, c_prev, h, xt, sWt, iWt)
        return (tlstm.lstm_bwd_acts, args, pallas_rnn.lstm_bwd_acts,
                [_to_jax(a) for a in args])
    if kind == "fusedw":
        args = (dht, pre, c, c_prev, h, xt, sWt, iWt)
        return (tlstm.lstm_bwd_fusedw, args, pallas_rnn.lstm_bwd_fusedw,
                [_to_jax(a) for a in args])
    args = (dht, c, h, xt, sWt, iWt, bt)
    return (tlstm.lstm_bwd_recompute, args, pallas_rnn.lstm_bwd_recompute,
            [_to_jax(a) for a in args])


@pytest.mark.parametrize("x_dtype", [F32, BF16], ids=["x32", "x16"])
@pytest.mark.parametrize("reverse", DIRS)
@pytest.mark.parametrize("kind", ["acts", "fusedw", "recompute"])
def test_bwd_twin_matches_pallas_kernel(kind, reverse, x_dtype):
    """Kernels 4, 11 and 12's twins on bf16 residuals, h and dh against
    pallas_rnn's: d_x in x's dtype, the weight gradients f32."""
    fn, args, jfn, jargs = _bwd_case(kind, reverse, x_dtype)
    got = fn(*args, reverse=reverse)
    want = jfn(*jargs, block_t=BT, interpret=True, reverse=reverse,
               dx_dtype=jargs[5 if kind != "recompute" else 3].dtype,
               true_len=T)
    d_x = _to_torch(want[0])
    assert got[0].dtype == d_x.dtype == x_dtype
    if x_dtype == BF16:
        bf16_close(got[0], d_x, 1e-5)
    else:
        _f32_close(got[0], want[0])
    for g, w, atol in zip(got[1:], want[1:], (1e-4, 1e-5, 1e-5)):
        assert g.dtype == F32 and w.dtype == jnp.float32
        _f32_close(g.sum(0), np.asarray(w).sum(0), atol=atol)


# -- (b) the layer against the JAX route -------------------------------------

POLICIES = {"acts": {}, "pre": {"TAIYAKI_TPU_ACTS_BWD": "0"},
            "recompute": {"TAIYAKI_TPU_RECOMPUTE": "1"}}


def _jax_layer(args, dh, reverse):
    """h and (d_x, d_iW, d_b, d_sW) of the JAX package's LSTM layer, all as
    f32 numpy, and h's dtype."""
    h, vjp = jax.vjp(lambda *a: jrnn.lstm_layer(*a, reverse=reverse),
                     *map(jnp.asarray, args))
    grads = vjp(jnp.asarray(dh).astype(h.dtype))
    return ([np.asarray(h.astype(jnp.float32))]
            + [np.asarray(g.astype(jnp.float32)) for g in grads]), h.dtype


def _port_layer(args, dh, reverse):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    h = trnn.lstm_layer(*leaves, reverse=reverse)
    grads = torch.autograd.grad(h, leaves, torch.from_numpy(dh).to(h.dtype))
    return [h.detach().float().numpy()] + [g.float().numpy()
                                           for g in grads], h.dtype


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("reverse", DIRS)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_layer_within_half_of_the_jax_routes_distance(policy, reverse,
                                                      monkeypatch):
    """One layer (T=24, B=8, D=H=32, seed 0): the port under the switch is
    within half of the distance between the JAX package's mixed route
    and its f32 route, for h and each gradient."""
    for k, v in POLICIES[policy].items():
        monkeypatch.setenv(k, v)
    x, iW, b, sW, dh = _inputs(0, d=32, h=32)
    args = (x, iW, b, sW)
    f32, _ = _jax_layer(args, dh, reverse)
    monkeypatch.setenv("TAIYAKI_TPU_PALLAS_INTERPRET", "1")
    mixed, jdtype = _jax_layer(args, dh, reverse)
    monkeypatch.delenv("TAIYAKI_TPU_PALLAS_INTERPRET")
    monkeypatch.setenv(SWITCH, "1")
    port, tdtype = _port_layer(args, dh, reverse)
    assert jdtype == jnp.bfloat16 and tdtype == BF16
    for name, a, m, p in zip(("h", "d_x", "d_iW", "d_b", "d_sW"), f32,
                             mixed, port):
        route = _rel(m, a)
        assert 1e-4 < route < 1e-2, name
        assert _rel(p, m) <= 0.5 * route, name


# -- (c) the sub-switches' dtypes --------------------------------------------

SUBS = {"default": {}, "F32_GATES": {"TAIYAKI_TPU_F32_GATES": "1"},
        "BF16_ACTS=0": {"TAIYAKI_TPU_BF16_ACTS": "0"},
        "F32_GRADS": {"TAIYAKI_TPU_F32_GRADS": "1"},
        "F32_GATES+F32_GRADS": {"TAIYAKI_TPU_F32_GATES": "1",
                                "TAIYAKI_TPU_F32_GRADS": "1"}}


def _recording(fn, calls, names):
    """`fn` recording the dtypes of its arguments `names` (positions)."""
    def wrapper(*args, **kw):
        calls.append(tuple(_dtype_name(args[i]) if hasattr(args[i], "dtype")
                           else None for i in names))
        return fn(*args, **kw)
    return wrapper


@pytest.mark.parametrize("sub", sorted(SUBS))
def test_sub_switches_give_the_jax_dtypes(sub, monkeypatch):
    """A 2-layer stack (the second reversed): the dtypes of h, of the
    residuals and of dh, h, x at each layer's backward kernel, and of
    d_x, equal the JAX route's."""
    for k, v in SUBS[sub].items():
        monkeypatch.setenv(k, v)
    x, iW, b, sW, dh = _inputs(3, d=H)
    rng = np.random.default_rng(4)
    iW2 = (rng.normal(size=(4 * H, H)) / np.sqrt(H)).astype(np.float32)
    # forward: the residuals (acts, tc) of each layer; backward: dh, acts,
    # tc, c_prev, h, x
    jcalls, tcalls = [], []
    monkeypatch.setattr(pallas_rnn, "lstm_bwd_acts", _recording(
        pallas_rnn.lstm_bwd_acts, jcalls, range(6)))
    monkeypatch.setattr(trnn, "lstm_bwd_acts", _recording(
        trnn.lstm_bwd_acts, tcalls, range(6)))

    def jstack(xx, w1, w2):
        h1 = jrnn.lstm_layer(xx, w1, b, sW)
        return h1, jrnn.lstm_layer(h1, w2, b, sW, reverse=True)

    monkeypatch.setenv("TAIYAKI_TPU_PALLAS_INTERPRET", "1")
    (jh1, jh2), vjp = jax.vjp(jstack, *map(jnp.asarray, (x, iW, iW2)))
    jdx = vjp((jnp.zeros_like(jh1), jnp.asarray(dh).astype(jh2.dtype)))[0]
    monkeypatch.delenv("TAIYAKI_TPU_PALLAS_INTERPRET")
    monkeypatch.setenv(SWITCH, "1")
    xt, w1, w2 = (torch.from_numpy(a).requires_grad_()
                  for a in (x, iW, iW2))
    th1 = trnn.lstm_layer(xt, w1, torch.from_numpy(b), torch.from_numpy(sW))
    th2 = trnn.lstm_layer(th1, w2, torch.from_numpy(b), torch.from_numpy(sW),
                          reverse=True)
    tdx, = torch.autograd.grad(th2, xt, torch.from_numpy(dh).to(th2.dtype))
    assert [_dtype_name(t) for t in (th1, th2, tdx)] == \
        [str(a.dtype) for a in (jh1, jh2, jdx)]
    assert tcalls == jcalls and len(tcalls) == 2


# -- (d) the bytes saved for the backward ------------------------------------

def _saved_bytes(switch, monkeypatch):
    """Bytes of the storages a 2-layer LSTM stack (T=200, B=8, D=H=32)
    saves for its backward, each storage once."""
    if switch:
        monkeypatch.setenv(SWITCH, "1")
    else:
        monkeypatch.delenv(SWITCH, raising=False)
    x, iW, b, sW, _ = _inputs(5, t=200, d=32, h=32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, iW, b, sW)]
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        h = trnn.lstm_layer(*leaves)
        h = trnn.lstm_layer(h, *leaves[1:], reverse=True)
    assert h.dtype == (BF16 if switch else F32)
    return sum(seen.values())


def test_saved_bytes_about_halved(monkeypatch):
    on, off = (_saved_bytes(s, monkeypatch) for s in (True, False))
    assert on <= 0.55 * off, (on, off)


# -- (e) a training step of mLstm_flipflop -----------------------------------

def _jax_step(jnet, params, batch):
    jbatch = jtrain.Batch(*(None if a is None else jnp.asarray(a)
                            for a in batch))
    loss, grads = jax.value_and_grad(jtrain.make_loss_fn(jnet))(
        params, jbatch, 1.0)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def test_training_step_against_the_jax_step(monkeypatch):
    """Size 16, B=8, chunks of 500 samples (T=100), seed 4: the port's
    step under the switch against the JAX package's mixed step."""
    kwargs = dict(insize=1, size=16, winlen=19, stride=5)
    jnet, tnet = jmodel.network(**kwargs), tmodel.network(**kwargs)
    params = jnet.init(np.random.default_rng(4))
    load_jax_params(tnet, params)
    batch = _batch(n=8)
    jloss32, jgrads32 = _jax_step(jnet, params, batch)
    monkeypatch.setenv("TAIYAKI_TPU_PALLAS_INTERPRET", "1")
    jloss, jgrads = _jax_step(jnet, params, batch)
    monkeypatch.delenv("TAIYAKI_TPU_PALLAS_INTERPRET")
    monkeypatch.setenv(SWITCH, "1")
    tloss, tgrads = ttrain.make_grad_step(tnet)(
        ttrain.batch_to_device(batch, torch.device("cpu")), 1.0)
    route = abs(jloss - jloss32) / abs(jloss32)
    assert abs(float(tloss) - jloss) <= 5e-3 * abs(jloss), (tloss, jloss,
                                                            route)
    assert len(jgrads) == len(tgrads) == len(leaf_names(tnet))
    for name, g, w, w32 in zip(leaf_names(tnet), tgrads, jgrads, jgrads32):
        assert g.dtype == F32 and g.shape == w.shape, name
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g.numpy() - w).max() <= 2e-2 * scale, (
            name, np.abs(g.numpy() - w).max() / scale,
            np.abs(w - w32).max() / scale)


# -- (f) what the switch refuses, and what it leaves alone -------------------

def _gru_args():
    x, _, _, _, _ = _inputs(6)
    rng = np.random.default_rng(7)
    return [torch.from_numpy(a) for a in (
        x, (0.3 * rng.normal(size=(3 * H, D))).astype(np.float32),
        (0.3 * rng.normal(size=3 * H)).astype(np.float32),
        (0.3 * rng.normal(size=(3 * H, H))).astype(np.float32))]


@pytest.mark.parametrize("case", ["gru grad", "gru bf16 h", "lstm_scan",
                                  "gru_scan"])
def test_paths_without_bf16_streams_raise(case, monkeypatch):
    """Every case has its bf16 instances now and runs under the switch,
    with the JAX route's dtypes.  The GRU layer: under grad h bf16 and
    every gradient f32 (x f32); with no grad a bf16 h, and a second layer
    on it a bf16 h too.  The scans (ROADMAP.md Queue 1 item 7.2): h f32
    and both gradients f32, finite, the gates and residuals bf16 inside
    (tests/test_torch_bf16_scan.py holds the values)."""
    monkeypatch.setenv(SWITCH, "1")
    x, iW, b, sW = _gru_args()
    if case == "gru grad":
        leaves = [t.clone().requires_grad_() for t in (x, iW, b, sW)]
        h = trnn.gru_layer(*leaves)
        grads = torch.autograd.grad(h, leaves, torch.ones_like(h))
        assert h.dtype == BF16 and bool(torch.isfinite(h.float()).all())
        assert [g.dtype for g in grads] == [F32] * 4
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        return
    if case == "gru bf16 h":
        with torch.no_grad():
            h = trnn.gru_layer(x, iW, b, sW)
            h2 = trnn.gru_layer(h, sW, b, sW, reverse=True)
        assert h.dtype == h2.dtype == BF16 and h2.shape == (T, B, H)
        return
    scan, G = ((trnn.lstm_scan, 4) if case == "lstm_scan"
               else (trnn.gru_scan, 3))
    rng = np.random.default_rng(8)
    leaves = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
              .requires_grad_() for shape in ((T, B, G * H), (G * H, H))]
    h = scan(*leaves)
    grads = torch.autograd.grad(h, leaves, torch.ones_like(h))
    assert h.dtype == F32 and bool(torch.isfinite(h).all())
    assert [g.dtype for g in grads] == [F32] * 2
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_gru_inference_with_f32_h_runs(monkeypatch):
    """The basecall CLIs' case: under the switch with
    TAIYAKI_TPU_F32_GATES=1 the GRU layer's forward runs, in f32."""
    x, iW, b, sW = _gru_args()
    with torch.no_grad():
        want = trnn.gru_layer(x, iW, b, sW)
        monkeypatch.setenv(SWITCH, "1")
        monkeypatch.setenv("TAIYAKI_TPU_F32_GATES", "1")
        assert torch.equal(trnn.gru_layer(x, iW, b, sW), want)


def test_bf16_reaching_an_f32_kernel_raises():
    """No kernel without a bf16 instance computes on bf16, and the bf16
    instances refuse what they do not take."""
    x, iW, b, sW = _gru_args()
    xb = x.to(BF16)
    with pytest.raises(ValueError):
        tgru.gru_fwd(xb, iW, b, sW)
    with pytest.raises(ValueError):
        tlstm.lstm_scan_fwd(torch.zeros(T, B, 4 * H, dtype=BF16),
                            torch.zeros(4 * H, H))
    xl, iWl, bl, sWl, dh = map(torch.from_numpy, _inputs(8))
    # bf16 x or h needs the bf16 instance (bf16 residuals)
    with pytest.raises(ValueError):
        tlstm.lstm_fwd(xl.to(BF16), iWl, bl, sWl)
    with pytest.raises(ValueError):
        tlstm.lstm_fwd(xl, iWl, bl, sWl, h_dtype=BF16)
    h, c, acts, tc = tlstm.lstm_fwd(xl, iWl, bl, sWl, emit="acts",
                                    res_dtype=BF16)
    cp = tlstm.prev_state(c, False)
    # residuals of two dtypes, and a bf16 dh beside f32 residuals
    with pytest.raises(ValueError):
        tlstm.lstm_bwd_acts(dh, acts, tc.float(), cp, h, xl, sWl, iWl)
    with pytest.raises(ValueError):
        tlstm.lstm_bwd_acts(dh.to(BF16), acts.float(), tc.float(),
                            cp.float(), h, xl, sWl, iWl)


def test_switch_unset_is_the_f32_layer():
    """Unset, the layer gives what the f32 twins give, bit for bit."""
    x, iW, b, sW, dh = map(torch.from_numpy, _inputs(9))
    leaves = [a.clone().requires_grad_() for a in (x, iW, b, sW)]
    h = trnn.lstm_layer(*leaves)
    assert h.dtype == F32
    grads = torch.autograd.grad(h, leaves, dh)
    hh, c, acts, tc = tlstm.lstm_fwd_plain(x, iW, b, sW, emit="acts")
    assert torch.equal(h, hh)
    d_x, d_sW, d_iW, d_b = tlstm.lstm_bwd_acts_plain(
        dh, acts, tc, tlstm.prev_state(c, False), hh, x, sW, iW)
    for g, w in zip(grads, (d_x, d_iW[0], d_b[0], d_sW[0])):
        assert torch.equal(g, w)


def test_inference_opt_out(monkeypatch):
    """rnn.f32_inference (the basecall and prepare_mapped_reads CLIs'):
    under the switch a network's forward is f32 and equal to the
    unswitched one; an exported value wins; the environment is left as it
    was."""
    kwargs = dict(insize=1, size=16, winlen=19, stride=5)
    net = tmodel.network(**kwargs)
    load_jax_params(net, jmodel.network(**kwargs).init(
        np.random.default_rng(10)))
    sig = torch.from_numpy(np.random.default_rng(11).normal(
        size=(300, 3, 1)).astype(np.float32))
    with torch.no_grad():
        want = net(sig)
        monkeypatch.setenv(SWITCH, "1")
        assert net(sig).dtype == F32      # the head promotes bf16 h
        assert not torch.equal(net(sig), want)
        with trnn.f32_inference():
            assert os.environ["TAIYAKI_TPU_F32_GATES"] == "1"
            assert os.environ["TAIYAKI_TPU_F32_SCORES"] == "1"
            assert torch.equal(net(sig), want)
        assert "TAIYAKI_TPU_F32_GATES" not in os.environ
        assert "TAIYAKI_TPU_F32_SCORES" not in os.environ
        monkeypatch.setenv("TAIYAKI_TPU_F32_GATES", "0")
        with trnn.f32_inference():
            assert os.environ["TAIYAKI_TPU_F32_GATES"] == "0"
        assert os.environ["TAIYAKI_TPU_F32_GATES"] == "0"


# -- the layers after an LSTM --------------------------------------------------

N = 8                       # feature width of the stacks below


def _ff(L, m=5, **kw):
    return L.FeedForward(N, m, **kw)


AFTER_LSTM = {
    "FeedForward": lambda L, A, _: _ff(L, fun=A.tanh),
    "Softmax": lambda L, A, _: L.Softmax(N, 6),
    "Residual": lambda L, A, _: L.Residual(L.Lstm(N, N)),
    "GatedResidual": lambda L, A, _: L.GatedResidual(_ff(L, m=N),
                                                     gate_init=0.7),
    "SoftChoice": lambda L, A, _: L.SoftChoice([_ff(L, m=N, fun=A.tanh),
                                                L.Identity(A.tanh)]),
    "Parallel": lambda L, A, _: L.Parallel([_ff(L, m=3), L.Softmax(N, 4),
                                            L.Identity()]),
    "Product": lambda L, A, _: L.Product([_ff(L, fun=A.sigmoid),
                                          _ff(L, has_bias=False)]),
    "GlobalNormFlipFlop": lambda L, A, _: L.GlobalNormFlipFlop(N, 4),
    "GlobalNormFlipFlopCatMod": lambda L, A, AL: L.GlobalNormFlipFlopCatMod(
        N, AL.AlphabetInfo(*MODALPHABET)),
}


@pytest.mark.parametrize("name", sorted(AFTER_LSTM))
def test_layer_after_an_lstm_matches_jax(name, monkeypatch):
    """The layer on an LSTM's bf16 h (the port's, under the switch) in
    both packages, the JAX one under its mixed precision: the output's
    dtype, and its values within 1e-5 of its largest; a bf16 output
    (Residual's, an LSTM's h plus another's) equal as bf16 but for at
    most 1% of it one bf16 step apart."""
    make = AFTER_LSTM[name]
    jl, tl = make(jlayers, jact, jalphabet), make(tlayers, tact, talphabet)
    params = jl.init(np.random.default_rng(12))
    load_jax_params(tl, params)
    x, iW, b, sW, _ = _inputs(13, d=4, h=N)
    monkeypatch.setenv(SWITCH, "1")
    monkeypatch.setenv("TAIYAKI_TPU_PALLAS_INTERPRET", "1")
    with torch.no_grad():
        h = trnn.lstm_layer(*map(torch.from_numpy, (x, iW, b, sW)))
        got = tl(h)
    assert h.dtype == BF16
    want = jl.apply(params, _to_jax(h))
    assert _dtype_name(got) == str(want.dtype)
    if got.dtype == BF16:
        bf16_close(got, _to_torch(want), 1e-6)
    else:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= \
            1e-5 * np.abs(want).max()


# layers that the JAX package does not run on a bf16 input either (its
# convolution and CudnnGru's scan take one dtype): both packages refuse
REFUSED_AFTER_LSTM = {
    "Convolution": lambda L, A, _: L.Convolution(N, 6, 5, fun=A.swish),
    "CudnnGru": lambda L, A, _: L.CudnnGru(N, 7),
}


@pytest.mark.parametrize("name", sorted(REFUSED_AFTER_LSTM))
def test_layer_after_an_lstm_refused_as_in_jax(name, monkeypatch):
    make = REFUSED_AFTER_LSTM[name]
    jl, tl = make(jlayers, jact, jalphabet), make(tlayers, tact, talphabet)
    params = jl.init(np.random.default_rng(14))
    load_jax_params(tl, params)
    h = torch.from_numpy(np.random.default_rng(15).normal(
        size=(T, B, N)).astype(np.float32)).to(BF16)
    with pytest.raises(TypeError):
        jl.apply(params, _to_jax(h))
    with pytest.raises(RuntimeError), torch.no_grad():
        tl(h)
