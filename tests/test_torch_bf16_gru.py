"""The GRU layers' bf16 streams (TAIYAKI_TPU_BF16_STREAMS=1, ops/rnn.py)
on the CPU against the JAX package's mixed precision, which it runs on
the CPU under TAIYAKI_TPU_PALLAS_INTERPRET=1 with B a multiple of 8, on
the same seeded numpy inputs (the terms of test_torch_bf16_streams.py,
which holds the LSTM's):

(a) the plain twins of kernels 7 (both emit modes), 8 and 13 against
    `pallas_rnn.<kernel>(..., interpret=True)` called with the JAX
    layer's dtypes (residual_dtype and h_dtype bf16, dh bf16, x bf16 as a
    later layer's or f32 as the first layer's), both directions: every
    output's dtype the JAX kernel's, the f32 outputs within 1e-4
    relative, the bf16 outputs equal as bf16 but for at most 1% of them
    one bf16 step apart (`bf16_close`);
(b) `ops.rnn.gru_layer` under the switch against
    `taiyaki_tpu.ops.rnn.gru_layer` through `jax.vjp`, under each
    residual policy (recompute, stored): h and every gradient within half
    of the JAX route's own distance from its f32 route;
(c) each JAX sub-switch (TAIYAKI_TPU_F32_GATES=1, TAIYAKI_TPU_BF16_ACTS=0,
    TAIYAKI_TPU_F32_GRADS=1) gives the GRU kernels of a 2-layer stack the
    dtypes the JAX route gives its kernels, under each policy;
(d) the bytes a 2-layer GRU stack saves for the backward under the stored
    policy at most 0.55 of those saved with the switch unset;
(e) one training step of a size-16 mGru_flipflop (B=8, the default
    policy) under the switch against the JAX package's: the loss within
    5e-3 relative and each gradient within 2e-2 of its largest;
(f) with the switch unset the GRU layer is the f32 one bit for bit, under
    each policy, and a failed bf16 pairing raises;
and the layers' products under the switch all take the tc GEMM.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu.models import mGru_flipflop as jmodel
from taiyaki_tpu.ops import pallas_rnn
from taiyaki_tpu.ops import rnn as jrnn
from taiyaki_tpu_torch import train as ttrain
from taiyaki_tpu_torch.convert import leaf_names, load_jax_params
from taiyaki_tpu_torch.models import mGru_flipflop as tmodel
from taiyaki_tpu_torch.ops import gru as tgru
from taiyaki_tpu_torch.ops import rnn as trnn
from test_torch_all_layers import _batch
from test_torch_bf16_streams import (BF16, BT, DIRS, F32, SWITCH,
                                     _dtype_name, _f32_close, _jax_step,
                                     _recording, _rel, _to_jax, _to_torch,
                                     bf16_close, clean_switches)  # noqa: F401
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse)

T, B, D, H = 24, 8, 12, 16
XDTYPES = pytest.mark.parametrize("x_dtype", [F32, BF16],
                                  ids=["x32", "x16"])
POLICIES = {"recompute": {}, "stored": {"TAIYAKI_TPU_NO_RECOMPUTE": "1"}}


def _inputs(seed, t=T, b=B, d=D, h=H):
    """x [t, b, d], iW [3h, d], b [3h], sW [3h, h], dh [t, b, h]."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, b, d)).astype(np.float32),
            (rng.normal(size=(3 * h, d)) / np.sqrt(d)).astype(np.float32),
            (0.5 * rng.normal(size=3 * h)).astype(np.float32),
            (rng.normal(size=(3 * h, h)) / np.sqrt(h)).astype(np.float32),
            rng.normal(size=(t, b, h)).astype(np.float32))


# -- (a) the twins against the TPU kernels in interpret mode ----------------

@XDTYPES
@pytest.mark.parametrize("reverse", DIRS)
@pytest.mark.parametrize("emit", [False, True], ids=["h", "residuals"])
def test_gru_fwd_twin_matches_pallas_kernel(emit, reverse, x_dtype):
    """Kernel 7's twin with bf16 h and residuals against
    pallas_rnn.gru_fused_fwd: h, gh and gx bf16, as bf16 equal."""
    x, iW, b, sW, _ = _inputs(1)
    xt = torch.from_numpy(x).to(x_dtype)
    got = tgru.gru_fwd(xt, *map(torch.from_numpy, (iW, b, sW)),
                       reverse=reverse, emit_residuals=emit, h_dtype=BF16,
                       res_dtype=BF16)
    want = pallas_rnn.gru_fused_fwd(
        _to_jax(xt), *map(jnp.asarray, (iW, b, sW)), block_t=BT,
        interpret=True, residual_dtype=jnp.bfloat16, reverse=reverse,
        true_len=T, h_dtype=jnp.bfloat16, emit_residuals=emit)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == (3 if emit else 1)
    for g, w in zip(got, want):
        w = _to_torch(w)
        assert g.dtype == w.dtype == BF16
        bf16_close(g, w, 1e-6)


def _bwd_case(kind, reverse, x_dtype):
    """(port wrapper, args, JAX kernel, JAX args) of backward `kind` on the
    bf16 forward's own h and residuals, dh bf16."""
    x, iW, b, sW, dh = _inputs(2)
    xt = torch.from_numpy(x).to(x_dtype)
    iWt, bt, sWt = map(torch.from_numpy, (iW, b, sW))
    h, gh, gx = tgru.gru_fwd_plain(xt, iWt, bt, sWt, reverse, True, BF16,
                                   BF16)
    dht = torch.from_numpy(dh).to(BF16)
    if kind == "fusedw":
        args = (dht, gx, gh, tgru.prev_state(h, reverse), xt, sWt, iWt)
        return (tgru.gru_bwd_fusedw, args, pallas_rnn.gru_bwd_fusedw,
                [_to_jax(a) for a in args])
    args = (dht, h, xt, sWt, iWt, bt)
    return (tgru.gru_bwd_recompute, args, pallas_rnn.gru_bwd_recompute,
            [_to_jax(a) for a in args])


@XDTYPES
@pytest.mark.parametrize("reverse", DIRS)
@pytest.mark.parametrize("kind", ["recompute", "fusedw"])
def test_gru_bwd_twin_matches_pallas_kernel(kind, reverse, x_dtype):
    """Kernels 8 and 13's twins on bf16 residuals, h and dh against
    pallas_rnn's: d_x in x's dtype, the weight gradients f32."""
    fn, args, jfn, jargs = _bwd_case(kind, reverse, x_dtype)
    got = fn(*args, reverse=reverse)
    xj = jargs[4 if kind == "fusedw" else 2]
    want = jfn(*jargs, block_t=BT, interpret=True, reverse=reverse,
               dx_dtype=xj.dtype, true_len=T)
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

def _jax_layer(args, dh, reverse):
    """h and (d_x, d_iW, d_b, d_sW) of the JAX package's GRU layer, all as
    f32 numpy, and h's dtype."""
    h, vjp = jax.vjp(lambda *a: jrnn.gru_layer(*a, reverse=reverse),
                     *map(jnp.asarray, args))
    grads = vjp(jnp.asarray(dh).astype(h.dtype))
    return ([np.asarray(h.astype(jnp.float32))]
            + [np.asarray(g.astype(jnp.float32)) for g in grads]), h.dtype


def _port_layer(args, dh, reverse):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    h = trnn.gru_layer(*leaves, reverse=reverse)
    grads = torch.autograd.grad(h, leaves, torch.from_numpy(dh).to(h.dtype))
    return [h.detach().float().numpy()] + [g.float().numpy()
                                           for g in grads], h.dtype


@pytest.mark.parametrize("reverse", DIRS)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_gru_layer_within_half_of_the_jax_routes_distance(policy, reverse,
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
# each policy's backward kernel and the positions of the arguments whose
# dtypes it records: dh, h, x (recompute); dh, gx, gh, h_prev, x (stored)
BWD_KERNELS = {"recompute": ("gru_bwd_recompute", (0, 1, 2)),
               "stored": ("gru_bwd_fusedw", (0, 1, 2, 3, 4))}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("sub", sorted(SUBS))
def test_gru_sub_switches_give_the_jax_dtypes(sub, policy, monkeypatch):
    """A 2-layer GRU stack (the second reversed): the dtypes of h, of the
    forward's residuals and of each layer's backward kernel's inputs, and
    of d_x, equal the JAX route's."""
    for k, v in dict(SUBS[sub], **POLICIES[policy]).items():
        monkeypatch.setenv(k, v)
    x, iW, b, sW, dh = _inputs(3, d=H)
    rng = np.random.default_rng(4)
    iW2 = (rng.normal(size=(3 * H, H)) / np.sqrt(H)).astype(np.float32)
    name, names = BWD_KERNELS[policy]
    jcalls, tcalls = [], []
    monkeypatch.setattr(pallas_rnn, name, _recording(
        getattr(pallas_rnn, name), jcalls, names))
    monkeypatch.setattr(trnn, name, _recording(
        getattr(trnn, name), tcalls, names))

    def jstack(xx, w1, w2):
        h1 = jrnn.gru_layer(xx, w1, b, sW)
        return h1, jrnn.gru_layer(h1, w2, b, sW, reverse=True)

    monkeypatch.setenv("TAIYAKI_TPU_PALLAS_INTERPRET", "1")
    (jh1, jh2), vjp = jax.vjp(jstack, *map(jnp.asarray, (x, iW, iW2)))
    jdx = vjp((jnp.zeros_like(jh1), jnp.asarray(dh).astype(jh2.dtype)))[0]
    monkeypatch.delenv("TAIYAKI_TPU_PALLAS_INTERPRET")
    monkeypatch.setenv(SWITCH, "1")
    xt, w1, w2 = (torch.from_numpy(a).requires_grad_()
                  for a in (x, iW, iW2))
    th1 = trnn.gru_layer(xt, w1, torch.from_numpy(b), torch.from_numpy(sW))
    th2 = trnn.gru_layer(th1, w2, torch.from_numpy(b), torch.from_numpy(sW),
                         reverse=True)
    tdx, = torch.autograd.grad(th2, xt, torch.from_numpy(dh).to(th2.dtype))
    assert [_dtype_name(t) for t in (th1, th2, tdx)] == \
        [str(a.dtype) for a in (jh1, jh2, jdx)]
    assert tcalls == jcalls and len(tcalls) == 2


# -- (d) the bytes saved for the backward ------------------------------------

def _saved_bytes(switch, monkeypatch):
    """Bytes of the storages a 2-layer GRU stack (T=200, B=8, D=H=32) saves
    for its backward under the stored policy, each storage once."""
    monkeypatch.setenv("TAIYAKI_TPU_NO_RECOMPUTE", "1")
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
        h = trnn.gru_layer(*leaves)
        h = trnn.gru_layer(h, *leaves[1:], reverse=True)
    assert h.dtype == (BF16 if switch else F32)
    return sum(seen.values())


def test_gru_saved_bytes_about_halved(monkeypatch):
    on, off = (_saved_bytes(s, monkeypatch) for s in (True, False))
    assert on <= 0.55 * off, (on, off)


# -- (e) a training step of mGru_flipflop ------------------------------------

def test_mgru_training_step_against_the_jax_step(monkeypatch):
    """Size 16, B=8, chunks of 500 samples (T=100), seed 4, the default
    (recompute) policy; the stored one is held by (b): the port's step
    under the switch against the JAX package's mixed step."""
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


# -- (f) the switch unset, and what the bf16 instances refuse ----------------

@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_gru_switch_unset_is_the_f32_layer(policy, monkeypatch):
    """Unset, the layer gives what the f32 twins give, bit for bit."""
    for k, v in POLICIES[policy].items():
        monkeypatch.setenv(k, v)
    x, iW, b, sW, dh = map(torch.from_numpy, _inputs(9))
    leaves = [a.clone().requires_grad_() for a in (x, iW, b, sW)]
    h = trnn.gru_layer(*leaves)
    assert h.dtype == F32
    grads = torch.autograd.grad(h, leaves, dh)
    hh, gh, gx = tgru.gru_fwd_plain(x, iW, b, sW, emit_residuals=True)
    assert torch.equal(h, hh)
    if policy == "stored":
        want = tgru.gru_bwd_fusedw_plain(
            dh, gx, gh, tgru.prev_state(hh, False), x, sW, iW)
    else:
        want = tgru.gru_bwd_recompute_plain(dh, hh, x, sW, iW, b)
    d_x, d_sW, d_iW, d_b = want
    for g, w in zip(grads, (d_x, d_iW[0], d_b[0], d_sW[0])):
        assert torch.equal(g, w)


@pytest.mark.parametrize("h", [256, 96])
def test_gru_bf16_gemms_take_the_tc_instance(h):
    """The GRU layers' products under the switch at mGru's width and
    train_abinitio's (3H = 768 and 288, D = H) all take the tc instance:
    x . iW^T and h_prev . sW^T of a bf16 A, d_x = dgx . iW (f32 A, bf16
    output), d_iW and d_sW of a bf16 B."""
    from taiyaki_tpu_torch.ops import gemm
    M = 2000 * 256
    for M_, N, K, kind, bf16 in ((M, 3 * h, h, gemm.GATE, True),
                                 (M, h, 3 * h, gemm.GATE, False),
                                 (3 * h, h, M, gemm.ATB, True)):
        assert gemm.gemm_plan(M_, N, K, kind, bf16=bf16).instance == "tc"


def test_gru_bf16_pairings_refused():
    """bf16 x or h needs the bf16 instance (bf16 residuals) in the forward;
    the backward from stored streams takes bf16 dh, h_prev or x only
    beside bf16 gx and gh, and one dtype for the two."""
    x, iW, b, sW, dh = map(torch.from_numpy, _inputs(8))
    with pytest.raises(ValueError):
        tgru.gru_fwd(x.to(BF16), iW, b, sW)
    with pytest.raises(ValueError):
        tgru.gru_fwd(x, iW, b, sW, h_dtype=BF16)
    h, gh, gx = tgru.gru_fwd(x, iW, b, sW, emit_residuals=True,
                             res_dtype=BF16)
    hp = tgru.prev_state(h, False)
    with pytest.raises(ValueError):
        tgru.gru_bwd_fusedw(dh, gx, gh.float(), hp, x, sW, iW)
    with pytest.raises(ValueError):
        tgru.gru_bwd_fusedw(dh.to(BF16), gx.float(), gh.float(), hp.float(),
                            x, sW, iW)
    with pytest.raises(ValueError):
        tgru.gru_bwd_recompute(dh.double(), h, x, sW, iW, b)
