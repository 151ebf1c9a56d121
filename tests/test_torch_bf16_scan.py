"""The scans' bf16 streams (TAIYAKI_TPU_BF16_STREAMS=1, ops/rnn.py
`scan_streams`) on the CPU against the JAX package's mixed precision,
which it runs on the CPU under TAIYAKI_TPU_PALLAS_INTERPRET=1 with B a
multiple of 8, on the same seeded numpy inputs (the terms of
test_torch_bf16_streams.py and test_torch_bf16_gru.py, which hold the
layers):

(a) the plain twins of kernels 14-17 against `pallas_rnn.lstm_fwd`,
    `lstm_bwd`, `gru_fwd` and `gru_bwd(..., interpret=True)` called with
    the JAX scans' dtypes (residual_dtype bf16; the gate stream bf16, or
    f32 as under TAIYAKI_TPU_F32_GATES; dh and grad_dtype bf16, or f32 as
    under TAIYAKI_TPU_F32_GRADS), both directions, the backwards with and
    without iW: every output's dtype the JAX kernel's, the f32 outputs
    within 1e-4 relative, the bf16 outputs equal as bf16 but for at most
    1% of them one bf16 step apart (`bf16_close`);
(b) `ops.rnn.lstm_scan` and `gru_scan` under the switch against
    `taiyaki_tpu.ops.rnn.lstm_scan` and `gru_scan` through `jax.vjp`: h,
    d gates_x and d_sW within half of the JAX route's own distance from
    its f32 route;
(c) TAIYAKI_TPU_F32_GATES=1, TAIYAKI_TPU_BF16_ACTS=0 and
    TAIYAKI_TPU_F32_GRADS=1 each give the scans' kernels the dtypes that
    the JAX scans give theirs (BF16_ACTS changes nothing);
(d) the bytes the scans save for the backward at most 0.6 of those saved
    with the switch unset, for each cell;
(e) with the switch unset the scans are the f32 ones bit for bit, and a
    bf16 pairing that no JAX route produces raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu.ops import pallas_rnn
from taiyaki_tpu.ops import rnn as jrnn
from taiyaki_tpu_torch.ops import gru as tgru
from taiyaki_tpu_torch.ops import lstm as tlstm
from taiyaki_tpu_torch.ops import rnn as trnn
from test_torch_bf16_streams import (BF16, BT, DIRS, F32, SWITCH,
                                     _dtype_name, _f32_close, _recording,
                                     _rel, _to_jax, _to_torch, bf16_close,
                                     clean_switches)  # noqa: F401
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse)

T, B, D, H = 24, 8, 12, 16
CELLS = {"lstm": 4, "gru": 3}
GATES = pytest.mark.parametrize("gx_dtype", [BF16, F32],
                                ids=["gx16", "gx32"])


def _inputs(G, seed, t=T, b=B, h=H):
    """gates_x [t, b, G h], sW [G h, h], dh [t, b, h], iW [G h, D]."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, b, G * h)).astype(np.float32),
            (0.3 * rng.normal(size=(G * h, h))).astype(np.float32),
            rng.normal(size=(t, b, h)).astype(np.float32),
            (0.3 * rng.normal(size=(G * h, D))).astype(np.float32))


def _check(got, want, atol=1e-5):
    """A port output against the JAX kernel's: the same dtype; bf16 as
    `bf16_close`, f32 within 1e-4 relative."""
    want = _to_torch(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if got.dtype == BF16:
        bf16_close(got, want, atol)
    else:
        _f32_close(got, want.numpy())


# -- (a) the twins against the TPU kernels in interpret mode ----------------

@GATES
@pytest.mark.parametrize("reverse", DIRS)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_scan_fwd_twin_matches_pallas_kernel(cell, reverse, gx_dtype):
    """Kernels 14 and 16's twins with bf16 residuals against
    pallas_rnn.lstm_fwd / gru_fwd: h f32; c and pre, or gh, bf16."""
    gx, sW, _, _ = _inputs(CELLS[cell], 1)
    gxt = torch.from_numpy(gx).to(gx_dtype)
    port = tlstm.lstm_scan_fwd if cell == "lstm" else tgru.gru_scan_fwd
    jfn = pallas_rnn.lstm_fwd if cell == "lstm" else pallas_rnn.gru_fwd
    got = port(gxt, torch.from_numpy(sW), reverse=reverse, residuals=True,
               res_dtype=BF16)
    want = jfn(_to_jax(gxt), jnp.asarray(sW), block_t=BT, interpret=True,
               residual_dtype=jnp.bfloat16, reverse=reverse)
    assert len(got) == len(want) == (3 if cell == "lstm" else 2)
    assert got[0].dtype == F32
    for g, w in zip(got, want):
        _check(g, w, 1e-6)
    h = port(gxt, torch.from_numpy(sW), reverse=reverse, res_dtype=BF16)
    assert torch.equal(h, got[0])


def _bwd_case(cell, reverse, gx_dtype, grad_dtype, seed=2):
    """(port chain, JAX kernel, args) on the bf16 forward twin's residuals,
    dh in `grad_dtype` (the JAX scans cast it so), and iW."""
    G = CELLS[cell]
    gx, sW, dh, iW = _inputs(G, seed)
    gxt, sWt = torch.from_numpy(gx).to(gx_dtype), torch.from_numpy(sW)
    dht = torch.from_numpy(dh).to(grad_dtype)
    if cell == "lstm":
        _, c, pre = tlstm.lstm_scan_fwd_plain(gxt, sWt, reverse, True, BF16)
        args = (dht, pre, c, tlstm.prev_state(c, reverse), sWt)
        return tlstm.lstm_scan_bwd, pallas_rnn.lstm_bwd, args, iW
    h, gh = tgru.gru_scan_fwd_plain(gxt, sWt, reverse, True, BF16)
    args = (dht, gxt, gh, tgru.prev_state(h, reverse), sWt)
    return tgru.gru_scan_bwd, pallas_rnn.gru_bwd, args, iW


@GATES
@pytest.mark.parametrize("grad_dtype", [BF16, F32], ids=["g16", "g32"])
@pytest.mark.parametrize("with_iw", [False, True], ids=["", "iW"])
@pytest.mark.parametrize("reverse", DIRS)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_scan_bwd_twin_matches_pallas_kernel(cell, reverse, with_iw,
                                             grad_dtype, gx_dtype):
    """Kernels 15 and 17's twins on bf16 residuals against
    pallas_rnn.lstm_bwd / gru_bwd with grad_dtype: dpre, or dgx and dgh,
    in the gradient dtype; d_x f32."""
    fn, jfn, args, iW = _bwd_case(cell, reverse, gx_dtype, grad_dtype)
    iWt = torch.from_numpy(iW) if with_iw else None
    got = fn(*args, reverse=reverse, iW=iWt)
    want = jfn(*(_to_jax(a) for a in args), block_t=BT, interpret=True,
               reverse=reverse,
               grad_dtype=jnp.bfloat16 if grad_dtype == BF16 else None,
               iW=jnp.asarray(iW) if with_iw else None)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want) == (1 if cell == "lstm" else 2) + with_iw
    ngrads = len(got) - with_iw
    for g, w in zip(got[:ngrads], want[:ngrads]):
        assert g.dtype == grad_dtype
        _check(g, w)
    if with_iw:
        _check(got[-1], want[-1])
        assert got[-1].dtype == F32


# -- (b) the scans against the JAX route -------------------------------------

def _jax_scan(cell, gx, sW, dh, reverse):
    """h, d gates_x and d_sW of the JAX package's scan as f32 numpy."""
    scan = jrnn.lstm_scan if cell == "lstm" else jrnn.gru_scan
    h, vjp = jax.vjp(lambda g, w: scan(g, w, reverse=reverse),
                     jnp.asarray(gx), jnp.asarray(sW))
    grads = vjp(jnp.asarray(dh).astype(h.dtype))
    return [np.asarray(a.astype(jnp.float32)) for a in (h,) + tuple(grads)]


def _port_scan(cell, gx, sW, dh, reverse):
    scan = trnn.lstm_scan if cell == "lstm" else trnn.gru_scan
    leaves = [torch.from_numpy(a).requires_grad_() for a in (gx, sW)]
    h = scan(*leaves, reverse=reverse)
    grads = torch.autograd.grad(h, leaves, torch.from_numpy(dh).to(h.dtype))
    assert h.dtype == F32 and [g.dtype for g in grads] == [F32, F32]
    return [h.detach().numpy()] + [g.numpy() for g in grads]


def _dist(got, want):
    """||got - want|| / ||want||, in the 2-norm."""
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("reverse", DIRS)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_scan_within_half_of_the_jax_routes_distance(cell, reverse,
                                                     monkeypatch):
    """T=24, B=8, H=32: the port's scan under the switch is within half of
    the distance between the JAX package's mixed route and its f32 route,
    for h (which only the bf16 gates move), d gates_x and d_sW, in the
    2-norm (the port ~1e-7 to 2.5e-4, the route ~1.3e-3 to 3.3e-3);
    elementwise within one bf16 step of the largest.  d gates_x is the
    stored bf16 gradient stream itself, and the JAX route's own values
    round the other way at up to 0.5% of its elements between its traced
    route and its kernels called one by one (reversed scans): one such
    flip at a large element moves the largest difference by a whole
    step, which the 2-norm weighs by its share."""
    gx, sW, dh, _ = _inputs(CELLS[cell], 0, h=32)
    f32 = _jax_scan(cell, gx, sW, dh, reverse)
    monkeypatch.setenv("TAIYAKI_TPU_PALLAS_INTERPRET", "1")
    mixed = _jax_scan(cell, gx, sW, dh, reverse)
    monkeypatch.delenv("TAIYAKI_TPU_PALLAS_INTERPRET")
    monkeypatch.setenv(SWITCH, "1")
    port = _port_scan(cell, gx, sW, dh, reverse)
    for name, a, m, p in zip(("h", "d_gates_x", "d_sW"), f32, mixed, port):
        route = _dist(m, a)
        assert 1e-4 < route < 2e-2, (name, route)
        assert _dist(p, m) <= 0.5 * route, (name, _dist(p, m), route)
        assert _rel(p, m) <= 2.0 ** -8, (name, _rel(p, m))


# -- (c) the sub-switches' dtypes --------------------------------------------

SUBS = {"default": {}, "F32_GATES": {"TAIYAKI_TPU_F32_GATES": "1"},
        "BF16_ACTS=0": {"TAIYAKI_TPU_BF16_ACTS": "0"},
        "F32_GRADS": {"TAIYAKI_TPU_F32_GRADS": "1"},
        "F32_GATES+F32_GRADS": {"TAIYAKI_TPU_F32_GATES": "1",
                                "TAIYAKI_TPU_F32_GRADS": "1"}}
# each cell's kernels (JAX name, port name) and the positions of the
# arguments whose dtypes they record: the gate stream (forwards); dh and
# the residuals, with the GRU's gx and h_prev (backwards)
KERNELS = {"lstm": (("lstm_fwd", "lstm_scan_fwd", (0,)),
                    ("lstm_bwd", "lstm_scan_bwd", (0, 1, 2, 3))),
           "gru": (("gru_fwd", "gru_scan_fwd", (0,)),
                   ("gru_bwd", "gru_scan_bwd", (0, 1, 2, 3)))}


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("sub", sorted(SUBS))
def test_scan_sub_switches_give_the_jax_dtypes(sub, cell, monkeypatch):
    """The dtypes the scan's forward and chain are given, and those of h
    and d gates_x, equal the JAX route's under each sub-switch; the
    forward's residuals bf16 and h f32 in each."""
    for k, v in SUBS[sub].items():
        monkeypatch.setenv(k, v)
    gx, sW, dh, _ = _inputs(CELLS[cell], 3)
    jcalls, tcalls = [], []
    for jname, tname, names in KERNELS[cell]:
        monkeypatch.setattr(pallas_rnn, jname, _recording(
            getattr(pallas_rnn, jname), jcalls, names))
        monkeypatch.setattr(trnn, tname, _recording(
            getattr(trnn, tname), tcalls, names))
    monkeypatch.setenv("TAIYAKI_TPU_PALLAS_INTERPRET", "1")
    scan = jrnn.lstm_scan if cell == "lstm" else jrnn.gru_scan
    jh, vjp = jax.vjp(scan, jnp.asarray(gx), jnp.asarray(sW))
    jdg = vjp(jnp.asarray(dh).astype(jh.dtype))[0]
    monkeypatch.delenv("TAIYAKI_TPU_PALLAS_INTERPRET")
    monkeypatch.setenv(SWITCH, "1")
    leaves = [torch.from_numpy(a).requires_grad_() for a in (gx, sW)]
    th = (trnn.lstm_scan if cell == "lstm" else trnn.gru_scan)(*leaves)
    tdg, _ = torch.autograd.grad(th, leaves, torch.from_numpy(dh))
    assert [_dtype_name(t) for t in (th, tdg)] == \
        [str(a.dtype) for a in (jh, jdg)] == ["float32", "float32"]
    assert tcalls == jcalls and len(tcalls) == 2
    # the chain's residuals under every sub-switch: pre, c and c_prev
    # bf16; gh bf16 beside h_prev f32
    assert tcalls[1][1:] == (("bfloat16",) * 3 if cell == "lstm"
                             else (tcalls[0][0], "bfloat16", "float32"))


def test_bf16_acts_changes_nothing(monkeypatch):
    """TAIYAKI_TPU_BF16_ACTS=0 leaves the scans as they are under the
    switch alone, bit for bit (the JAX scans call their kernels with no
    h_dtype)."""
    out = []
    for acts in (None, "0"):
        if acts is not None:
            monkeypatch.setenv("TAIYAKI_TPU_BF16_ACTS", acts)
        monkeypatch.setenv(SWITCH, "1")
        for cell in sorted(CELLS):
            gx, sW, dh, _ = _inputs(CELLS[cell], 4)
            out.append(_port_scan(cell, gx, sW, dh, False))
    half = len(out) // 2
    for a, b in zip(out[:half], out[half:]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


# -- (d) the bytes saved for the backward ------------------------------------

def _saved_bytes(cell, switch, monkeypatch):
    """Bytes of the storages a scan (T=200, B=8, H=32) saves for its
    backward, each storage once."""
    if switch:
        monkeypatch.setenv(SWITCH, "1")
    else:
        monkeypatch.delenv(SWITCH, raising=False)
    gx, sW, _, _ = _inputs(CELLS[cell], 5, t=200, h=32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (gx, sW)]
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        h = (trnn.lstm_scan if cell == "lstm" else trnn.gru_scan)(*leaves)
    assert h.dtype == F32
    return sum(seen.values())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_scan_saved_bytes_cut(cell, monkeypatch):
    """h f32 with c and pre bf16 (LSTM), or h f32 with gx and gh bf16
    (GRU): 14 H against 24 H bytes a row, 16 H against 28 H, sW aside."""
    on, off = (_saved_bytes(cell, s, monkeypatch) for s in (True, False))
    assert on <= 0.6 * off, (on, off)


# -- (e) the switch unset, and what the bf16 instances refuse ----------------

@pytest.mark.parametrize("reverse", DIRS)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_scan_switch_unset_is_the_f32_scan(cell, reverse):
    """Unset, the scan gives what the f32 twins give, bit for bit."""
    gx, sW, dh, _ = map(torch.from_numpy, _inputs(CELLS[cell], 9))
    leaves = [a.clone().requires_grad_() for a in (gx, sW)]
    scan = trnn.lstm_scan if cell == "lstm" else trnn.gru_scan
    h = scan(*leaves, reverse=reverse)
    grads = torch.autograd.grad(h, leaves, dh)
    with torch.no_grad():
        assert torch.equal(scan(gx, sW, reverse=reverse), h)
    if cell == "lstm":
        hh, c, pre = tlstm.lstm_scan_fwd_plain(gx, sW, reverse, True)
        dg = tlstm.lstm_scan_bwd_plain(dh, pre, c, tlstm.prev_state(
            c, reverse), sW, reverse)
    else:
        hh, gh = tgru.gru_scan_fwd_plain(gx, sW, reverse, True)
        dg, dgh = tgru.gru_scan_bwd_plain(dh, gx, gh, tgru.prev_state(
            hh, reverse), sW, reverse)
    G = CELLS[cell]
    d_sW = torch.matmul((dg if cell == "lstm" else dgh).reshape(-1, G * H)
                        .t(), tlstm.prev_state(hh, reverse).reshape(-1, H))
    assert torch.equal(h, hh) and h.dtype == F32
    assert torch.equal(grads[0], dg) and torch.equal(grads[1], d_sW)


def test_scan_bf16_pairings_refused():
    """No JAX route gives these: bf16 gates beside f32 residuals (the f32
    instance), residuals of two dtypes, bf16 dh (and so bf16 gradients)
    beside f32 residuals, a dtype neither f32 nor bf16."""
    gx, sW, dh, _ = map(torch.from_numpy, _inputs(4, 6))
    with pytest.raises(ValueError):
        tlstm.lstm_scan_fwd(gx.to(BF16), sW)
    h, c, pre = tlstm.lstm_scan_fwd(gx, sW, residuals=True, res_dtype=BF16)
    cp = tlstm.prev_state(c, False)
    with pytest.raises(ValueError):
        tlstm.lstm_scan_bwd(dh, pre, c.float(), cp, sW)
    with pytest.raises(ValueError):
        tlstm.lstm_scan_bwd(dh.to(BF16), pre.float(), c.float(), cp.float(),
                            sW)
    with pytest.raises(ValueError):
        tlstm.lstm_scan_bwd(dh.double(), pre, c, cp, sW)
    gx, sW, dh, _ = map(torch.from_numpy, _inputs(3, 6))
    with pytest.raises(ValueError):
        tgru.gru_scan_fwd(gx.to(BF16), sW, residuals=True)
    h, gh = tgru.gru_scan_fwd(gx, sW, residuals=True)
    hp = tgru.prev_state(h, False)
    for bad in ({"dh": dh.to(BF16)}, {"gx": gx.to(BF16)},
                {"hp": hp.to(BF16)}):
        a = dict(dict(dh=dh, gx=gx, hp=hp), **bad)
        with pytest.raises(ValueError):
            tgru.gru_scan_bwd(a["dh"], a["gx"], gh, a["hp"], sW)
