"""Model layers as `torch.nn.Module`s (port of taiyaki_tpu/layers.py).

Each layer keeps the JAX layer's constructor signature, so the text of a
model-description file runs unchanged, and names its parameters as the
JAX parameter pytree does, so a flattened pytree is the module's
`state_dict` (see `taiyaki_tpu_torch.convert`).  `init(rng)` draws that
pytree with a `numpy.random.Generator` in the JAX package's order, so one
seed gives the same weights in both packages.

Tensor convention: time x batch x features (TBF) throughout.

Every layer of the JAX package is here.  Parameters are trainable: the
LSTM and GRU layers (`Lstm`, `GruMod`) take their gradients from the
backward kernels of `ops.rnn.lstm_layer` and `ops.rnn.gru_layer`, every
other layer from autograd.  `CudnnGru` has no kernel in the JAX package
(a `lax.scan`) and none here: one input product, then a loop over time of
plain PyTorch ops, on the card as on the CPU.

`json()` gives the layer's Guppy export, as the JAX layer's `json(params)`
gives it for the same weights: the same keys in the same order, the same
type strings, the weights as float32 numpy arrays reshaped and (GRU gates)
reordered in the same way.
"""

from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from taiyaki_tpu_torch import activation, flipflopfings


# -- initialisers (numpy, as in the JAX package) ------------------------------

def random_orthonormal(rng, n, m=None):
    """Random n x m orthonormal matrix (m >= n) via QR of Gaussian noise
    with Mezzadri sign correction."""
    m = n if m is None else m
    assert m >= n
    x = rng.standard_normal((m, m))
    q, r = np.linalg.qr(x)
    q = q * np.sign(np.diag(r))[None, :]
    return q[:n, :]


def orthonormal_matrix(rng, nrow, ncol):
    """Rectangular orthonormal-ish init: stack square orthonormal chunks."""
    nrep = nrow // ncol
    out = np.zeros((nrow, ncol), dtype=np.float32)
    for i in range(nrep):
        out[i * ncol:(i + 1) * ncol] = random_orthonormal(rng, ncol)
    rem = nrow - nrep * ncol
    if rem > 0:
        out[nrep * ncol:] = random_orthonormal(rng, rem, ncol)
    return out


def truncated_normal(rng, shape, sd):
    """Truncated normal (+-2 sd) for vector params."""
    out = np.empty(shape, dtype=np.float32).reshape(-1)
    filled = 0
    while filled < out.size:
        draw = rng.standard_normal(out.size * 2)
        draw = draw[np.abs(draw) < 2.0]
        take = min(out.size - filled, draw.size)
        out[filled:filled + take] = draw[:take]
        filled += take
    return (sd * out).reshape(shape)


def _param(*shape):
    """A trainable f32 parameter of `shape`, zero until weights are
    loaded."""
    return nn.Parameter(torch.zeros(*shape))


def _linear_init(rng, size, insize, has_bias):
    params = {"W": orthonormal_matrix(rng, size, insize)}
    if has_bias:
        params["b"] = truncated_normal(rng, (size,), sd=0.5)
    return params


def _promote(x, like):
    """`x` in `like`'s dtype where they differ: JAX's promotion of a bf16
    stream (an LSTM layer's h under TAIYAKI_TPU_BF16_STREAMS=1, ops/rnn.py)
    beside an f32 parameter, bf16 with f32 giving f32."""
    return x if x.dtype == like.dtype else x.to(like.dtype)


def _as_np(t):
    """A parameter as a float32 numpy array on the host (JSON export)."""
    return t.detach().cpu().numpy().astype(np.float32)


def _linear_json_params(layer):
    out = OrderedDict([("W", _as_np(layer.W))])
    if layer.has_bias:
        out["b"] = _as_np(layer.b)
    return out


# -- base --------------------------------------------------------------------

class Layer(nn.Module):
    """Base class.  `insize`/`size` give feature counts, `stride` the time
    down-sampling factor (1 unless overridden)."""

    stride = 1

    def init(self, rng):
        """Draw this layer's parameter pytree (numpy) from a numpy
        Generator, exactly as the JAX layer's `init` does."""
        return {}

    def json(self):
        """The layer's Guppy JSON structure (an OrderedDict)."""
        raise NotImplementedError


def _same_stride(sublayers):
    # branches consume the same input and their outputs are combined
    # time-aligned, so all sublayer strides must agree
    strides = {getattr(l, "stride", 1) for l in sublayers}
    assert len(strides) == 1, (
        "sublayers disagree on stride: {}".format(sorted(strides)))
    return strides.pop()


# -- simple feature layers ---------------------------------------------------

class FeedForward(Layer):
    """out = fun(x W^T + b)."""

    def __init__(self, insize, size, has_bias=True, fun=activation.linear):
        super().__init__()
        self.insize = insize
        self.size = size
        self.has_bias = has_bias
        self.activation = fun
        self.W = _param(size, insize)
        if has_bias:
            self.b = _param(size)

    def init(self, rng):
        return _linear_init(rng, self.size, self.insize, self.has_bias)

    def linear(self, x):
        y = torch.matmul(_promote(x, self.W), self.W.t())
        return y + self.b if self.has_bias else y

    def forward(self, x):
        return self.activation(self.linear(x))

    def json(self):
        return OrderedDict([
            ("type", "feed-forward"),
            ("activation", self.activation.__name__),
            ("size", self.size),
            ("insize", self.insize),
            ("bias", self.has_bias),
            ("params", _linear_json_params(self))])


class Softmax(FeedForward):
    """Log-softmax of a linear transform."""

    def __init__(self, insize, size, has_bias=True):
        super().__init__(insize, size, has_bias)

    def forward(self, x):
        return F.log_softmax(self.linear(x), dim=-1)

    def json(self):
        res = OrderedDict([("type", "softmax"),
                           ("size", self.size),
                           ("insize", self.insize),
                           ("bias", self.has_bias)])
        res["params"] = _linear_json_params(self)
        return res


class TimeLinear(FeedForward):
    """Linear transform over the *time* dimension: insize time points in,
    size out."""

    def forward(self, x):
        y = self.activation(self.linear(x.permute(1, 2, 0)))   # [B, F, T]
        return y.permute(2, 0, 1)

    def json(self):
        res = OrderedDict([("type", "TimeLinear"),
                           ("activation", self.activation.__name__),
                           ("size", self.size),
                           ("insize", self.insize),
                           ("bias", self.has_bias)])
        res["params"] = _linear_json_params(self)
        return res


class Identity(Layer):
    """Elementwise activation only."""

    def __init__(self, fun=activation.linear):
        super().__init__()
        self.fun = fun

    def forward(self, x):
        return self.fun(x)

    def json(self):
        return OrderedDict([("type", "Identity"),
                            ("activation", self.fun.__name__)])


class Studentise(Layer):
    """Normalise each feature over (time, batch) by its mean and its
    population variance."""

    def __init__(self, epsilon=1e-4):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x):
        m = torch.mean(x, dim=(0, 1), keepdim=True)
        v = torch.var(x, dim=(0, 1), keepdim=True, correction=0)
        return (x - m) / torch.sqrt(v + self.epsilon)

    def json(self):
        return {"type": "studentise"}


class DeltaSample(Layer):
    """Difference of neighbouring time samples, zero-padded at the end."""

    def forward(self, x):
        return torch.cat([x[1:] - x[:-1], torch.zeros_like(x[:1])], dim=0)

    def json(self):
        return OrderedDict([("type", "DeltaSample")])


class Window(Layer):
    """Sliding window over time, stacked on the feature axis: w copies of
    the zero-padded input, shifted by 0 .. w-1."""

    def __init__(self, w):
        super().__init__()
        assert w > 0, "Window size must be positive"
        assert w % 2 == 1, "Window size should be odd"
        self.w = w

    def forward(self, x):
        length = x.shape[0]
        pad = x.new_zeros((self.w // 2,) + tuple(x.shape[1:]))
        padded = torch.cat([pad, x, pad], dim=0)
        return torch.cat([padded[i:length + i] for i in range(self.w)],
                         dim=-1)

    def json(self):
        res = OrderedDict([("type", "window")])
        res["params"] = OrderedDict([("w", self.w)])
        return res


class UpSample(Layer):
    """(T, B, F) -> (T*nfold, B, F/nfold), each batch row's features
    spread over nfold consecutive times."""

    def __init__(self, nfold):
        super().__init__()
        self.nfold = nfold

    def forward(self, x):
        nt, nb, nf = x.shape
        assert nf % self.nfold == 0
        y = x.permute(1, 0, 2).reshape(nb, nt * self.nfold, nf // self.nfold)
        return y.permute(1, 0, 2)

    def json(self):
        return OrderedDict([("type", "UpSample"), ("nfold", self.nfold)])


class DownSample(Layer):
    """(T, B, F) -> (T/nfold, B, F*nfold), nfold consecutive times of each
    batch row joined on the features."""

    def __init__(self, nfold):
        super().__init__()
        self.nfold = nfold

    def forward(self, x):
        nt, nb, nf = x.shape
        assert nt % self.nfold == 0
        y = x.permute(1, 0, 2).reshape(nb, nt // self.nfold, nf * self.nfold)
        return y.permute(1, 0, 2)

    def json(self):
        return OrderedDict([("type", "DownSample"), ("nfold", self.nfold)])


# -- combinators -------------------------------------------------------------

class Serial(Layer):
    """Apply layers in sequence.  With `remat` set (`set_remat`), each
    sublayer runs under `torch.utils.checkpoint` when grad is on: its
    activations are not kept for the backward pass, which runs its forward
    again (the JAX package's TAIYAKI_TPU_REMAT, jax.checkpoint of each
    sublayer)."""

    def __init__(self, layers):
        super().__init__()
        self.sublayers = nn.ModuleList(layers)
        self.remat = False

    @property
    def insize(self):
        return self.sublayers[0].insize

    @property
    def size(self):
        return self.sublayers[-1].size

    @property
    def stride(self):
        s = 1
        for layer in self.sublayers:
            s *= getattr(layer, "stride", 1)
        return s

    def init(self, rng):
        return {"sublayers": [l.init(rng) for l in self.sublayers]}

    def forward(self, x):
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.sublayers:
            x = (checkpoint(layer, x, use_reentrant=False) if remat
                 else layer(x))
        return x

    def json(self):
        return OrderedDict([
            ("type", "serial"),
            ("sublayers", [l.json() for l in self.sublayers])])


def set_remat(net, on=True):
    """Set or clear `remat` on every Serial in `net` (the trainer's
    --remat)."""
    for module in net.modules():
        if isinstance(module, Serial):
            module.remat = on


class Parallel(Layer):
    """Apply layers to the same input; concatenate on features."""

    def __init__(self, layers):
        super().__init__()
        self.sublayers = nn.ModuleList(list(layers))

    @property
    def insize(self):
        return self.sublayers[0].insize

    @property
    def size(self):
        return sum(l.size for l in self.sublayers)

    @property
    def stride(self):
        return _same_stride(self.sublayers)

    def init(self, rng):
        return {"sublayers": [l.init(rng) for l in self.sublayers]}

    def forward(self, x):
        return torch.cat([l(x) for l in self.sublayers], dim=2)

    def json(self):
        return OrderedDict([
            ("type", "parallel"),
            ("sublayers", [l.json() for l in self.sublayers])])


class Product(Layer):
    """Elementwise product of layer outputs."""

    def __init__(self, layers):
        super().__init__()
        self.sublayers = nn.ModuleList(list(layers))

    @property
    def insize(self):
        return self.sublayers[0].insize

    @property
    def size(self):
        return self.sublayers[0].size

    @property
    def stride(self):
        return _same_stride(self.sublayers)

    def init(self, rng):
        return {"sublayers": [l.init(rng) for l in self.sublayers]}

    def forward(self, x):
        y = self.sublayers[0](x)
        for layer in self.sublayers[1:]:
            y = y * layer(x)
        return y

    def json(self):
        return OrderedDict([
            ("type", "Product"),
            ("sublayers", [l.json() for l in self.sublayers])])


class Reverse(Layer):
    """Run the enclosed layer backwards in time.  A recurrent layer with a
    kernel takes the direction as an argument (the kernel walks time
    backwards, no flipped copies); any other layer runs on flipped
    input."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    @property
    def insize(self):
        return self.layer.insize

    @property
    def size(self):
        return self.layer.size

    @property
    def stride(self):
        return getattr(self.layer, "stride", 1)

    def init(self, rng):
        return {"layer": self.layer.init(rng)}

    def forward(self, x):
        if isinstance(self.layer, (Lstm, GruMod)):
            return self.layer(x, reverse=True)
        return torch.flip(self.layer(torch.flip(x, (0,))), (0,))

    def json(self):
        return OrderedDict([("type", "reverse"),
                            ("sublayers", self.layer.json())])


class Residual(Layer):
    """x + layer(x)."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    @property
    def insize(self):
        return self.layer.insize

    @property
    def size(self):
        return self.layer.size

    def init(self, rng):
        return {"layer": self.layer.init(rng)}

    def forward(self, x):
        return x + self.layer(x)

    def json(self):
        return OrderedDict([("type", "Residual"),
                            ("sublayers", self.layer.json())])


class GatedResidual(Layer):
    """sigmoid(alpha) x + (1 - sigmoid(alpha)) layer(x); alpha has shape
    (1,)."""

    def __init__(self, layer, gate_init=0.0):
        super().__init__()
        self.layer = layer
        self.gate_init = gate_init
        self.alpha = _param(1)

    @property
    def insize(self):
        return self.layer.insize

    @property
    def size(self):
        return self.layer.size

    def init(self, rng):
        return {"alpha": np.array([self.gate_init], dtype=np.float32),
                "layer": self.layer.init(rng)}

    def forward(self, x):
        gate = torch.sigmoid(self.alpha[0])
        return (gate * _promote(x, gate)
                + (1.0 - gate) * _promote(self.layer(x), gate))

    def json(self):
        res = OrderedDict([("type", "GatedResidual"),
                           ("sublayers", self.layer.json())])
        res["params"] = OrderedDict([("alpha", float(_as_np(self.alpha)[0]))])
        return res


class SoftChoice(Layer):
    """Mixture of layer outputs weighted by softmax(alpha)."""

    def __init__(self, layers):
        super().__init__()
        self.sublayers = nn.ModuleList(list(layers))
        self.alpha = _param(len(self.sublayers))

    @property
    def insize(self):
        return self.sublayers[0].insize

    @property
    def size(self):
        return self.sublayers[0].size

    @property
    def stride(self):
        return _same_stride(self.sublayers)

    def init(self, rng):
        return {"alpha": np.zeros(len(self.sublayers), dtype=np.float32),
                "sublayers": [l.init(rng) for l in self.sublayers]}

    def forward(self, x):
        ps = torch.softmax(self.alpha, dim=0)
        ys = [p * _promote(l(x), p) for p, l in zip(ps, self.sublayers)]
        return sum(ys[1:], start=ys[0])

    def json(self):
        res = OrderedDict([
            ("type", "softchoice"),
            ("sublayers", [l.json() for l in self.sublayers])])
        res["params"] = OrderedDict([("alpha", _as_np(self.alpha))])
        return res


def birnn(forward, backward):
    """Bidirectional RNN: the forward layer and the time-reversed one in
    parallel."""
    return Parallel([forward, Reverse(backward)])


# -- convolution -------------------------------------------------------------

class Convolution(Layer):
    """1D convolution over time, TBF in / TBF out.  Weight layout
    [size, insize, winlen]; default padding (winlen//2, (winlen-1)//2),
    which is asymmetric for even winlen and so is applied with F.pad."""

    def __init__(self, insize, size, winlen, stride=1, pad=None,
                 fun=activation.tanh, has_bias=True):
        super().__init__()
        self.insize = insize
        self.size = size
        self.winlen = winlen
        self.stride = stride
        if pad is None:
            pad = (winlen // 2, (winlen - 1) // 2)
        self.padding = tuple(pad)
        self.activation = fun
        self.has_bias = has_bias
        self.W = _param(size, insize, winlen)
        if has_bias:
            self.b = _param(size)

    def init(self, rng):
        w = orthonormal_matrix(rng, self.size, self.insize * self.winlen)
        params = {"W": w.reshape(self.size, self.insize, self.winlen)}
        if self.has_bias:
            params["b"] = truncated_normal(rng, (self.size,), sd=0.5)
        return params

    def forward(self, x):
        y = F.conv1d(F.pad(x.permute(1, 2, 0), self.padding), self.W,
                     self.b if self.has_bias else None, stride=self.stride)
        return self.activation(y.permute(2, 0, 1))

    def json(self):
        res = OrderedDict([("type", "convolution"),
                           ("insize", self.insize),
                           ("size", self.size),
                           ("bias", self.has_bias),
                           ("winlen", self.winlen),
                           ("stride", self.stride),
                           ("padding", self.padding),
                           ("activation", self.activation.__name__)])
        res["params"] = _linear_json_params(self)
        return res


# -- recurrent layers --------------------------------------------------------

class Lstm(Layer):
    """LSTM over time: torch nn.LSTM cell equations with the redundant
    hidden bias pinned to zero; gates stacked in the order i, f, g, o
    (iW [4H, insize], sW [4H, H], b [4H]).  With has_bias=False, b stays
    zero."""

    def __init__(self, insize, size, has_bias=True):
        super().__init__()
        self.insize = insize
        self.size = size
        self.has_bias = has_bias
        self.iW = _param(4 * size, insize)
        self.sW = _param(4 * size, size)
        self.b = _param(4 * size)

    def init(self, rng):
        params = {
            "iW": orthonormal_matrix(rng, 4 * self.size, self.insize),
            "sW": orthonormal_matrix(rng, 4 * self.size, self.size),
        }
        if self.has_bias:
            params["b"] = truncated_normal(rng, (4 * self.size,), sd=0.5)
        else:
            params["b"] = np.zeros(4 * self.size, dtype=np.float32)
        return params

    def forward(self, x, reverse=False):
        from taiyaki_tpu_torch.ops.rnn import lstm_layer
        # has_bias=False keeps the zero b, initialised to zero and not
        # trained, as in the JAX package
        b = self.b if self.has_bias else self.b.detach()
        return lstm_layer(x, self.iW, b, self.sW, reverse=reverse)

    def json(self):
        res = OrderedDict([("type", "LSTM"),
                           ("activation", "tanh"),
                           ("gate", "sigmoid"),
                           ("size", self.size),
                           ("insize", self.insize),
                           ("bias", self.has_bias)])
        res["params"] = OrderedDict([
            ("iW", _as_np(self.iW).reshape(4, self.size, self.insize)),
            ("sW", _as_np(self.sW).reshape(4, self.size, self.size)),
            ("b", _as_np(self.b).reshape(4, self.size))])
        return res


def _cudnn_to_guppy_gru(p):
    """Reorder stacked GRU gates from CUDNN's order (r, z, n) to Guppy's
    (z, r, n)."""
    k = p.shape[0] // 3
    return np.concatenate([p[k:2 * k], p[:k], p[2 * k:]], axis=0)


class GruMod(Layer):
    """Guppy-compatible GRU: torch/CUDNN GRU cell equations with the
    redundant hidden bias pinned to zero; gates stacked in CUDNN's order
    r, z, n (iW [3H, insize], sW [3H, H], b [3H]).  With has_bias=False, b
    stays zero.  The JSON export reorders the gates to Guppy's (z, r,
    n)."""

    def __init__(self, insize, size, has_bias=True):
        super().__init__()
        self.insize = insize
        self.size = size
        self.has_bias = has_bias
        self.iW = _param(3 * size, insize)
        self.sW = _param(3 * size, size)
        self.b = _param(3 * size)

    def init(self, rng):
        params = {
            "iW": orthonormal_matrix(rng, 3 * self.size, self.insize),
            "sW": orthonormal_matrix(rng, 3 * self.size, self.size),
        }
        if self.has_bias:
            params["b"] = truncated_normal(rng, (3 * self.size,), sd=0.5)
        else:
            params["b"] = np.zeros(3 * self.size, dtype=np.float32)
        return params

    def forward(self, x, reverse=False):
        from taiyaki_tpu_torch.ops.rnn import gru_layer
        # see Lstm.forward on has_bias=False
        b = self.b if self.has_bias else self.b.detach()
        return gru_layer(x, self.iW, b, self.sW, reverse=reverse)

    def json(self):
        res = OrderedDict([("type", "GruMod"),
                           ("activation", "tanh"),
                           ("gate", "sigmoid"),
                           ("size", self.size),
                           ("insize", self.insize),
                           ("bias", self.has_bias)])
        iW = _cudnn_to_guppy_gru(_as_np(self.iW))
        sW = _cudnn_to_guppy_gru(_as_np(self.sW))
        b = _cudnn_to_guppy_gru(_as_np(self.b))
        res["params"] = OrderedDict([
            ("iW", iW.reshape(3, self.size, self.insize)),
            ("sW", sW.reshape(3, self.size, self.size)),
            ("b", b.reshape(3, self.size))])
        return res


class CudnnGru(Layer):
    """GRU with an input bias ib and a state bias sb (CUDNN's GRU), gates
    stacked r, z, n; sb sits inside the candidate gate:
        r = sigmoid(x W_r + ib_r + h U_r + sb_r)
        z = sigmoid(x W_z + ib_z + h U_z + sb_z)
        n = tanh(x W_n + ib_n + r * (h U_n + sb_n))
        h' = (1 - z) n + z h
    With has_bias=False, ib and sb stay zero.  No kernel: one input
    product, then a loop over time."""

    def __init__(self, insize, size, has_bias=True):
        super().__init__()
        self.insize = insize
        self.size = size
        self.has_bias = has_bias
        self.iW = _param(3 * size, insize)
        self.sW = _param(3 * size, size)
        self.ib = _param(3 * size)
        self.sb = _param(3 * size)

    def init(self, rng):
        params = {
            "iW": orthonormal_matrix(rng, 3 * self.size, self.insize),
            "sW": orthonormal_matrix(rng, 3 * self.size, self.size),
        }
        if self.has_bias:
            params["ib"] = truncated_normal(rng, (3 * self.size,), sd=0.5)
            params["sb"] = truncated_normal(rng, (3 * self.size,), sd=0.5)
        else:
            params["ib"] = np.zeros(3 * self.size, dtype=np.float32)
            params["sb"] = np.zeros(3 * self.size, dtype=np.float32)
        return params

    def forward(self, x):
        H = self.size
        ib, sb = self.ib, self.sb
        if not self.has_bias:
            # see Lstm.forward on has_bias=False
            ib, sb = ib.detach(), sb.detach()
        gates_x = torch.matmul(x, self.iW.t()) + ib
        sWt = self.sW.t()
        h = x.new_zeros(x.shape[1], H)
        out = []
        for gx in gates_x:
            gh = torch.matmul(h, sWt) + sb
            rz = torch.sigmoid(gx[:, :2 * H] + gh[:, :2 * H])
            r, z = rz[:, :H], rz[:, H:]
            n = torch.tanh(gx[:, 2 * H:] + r * gh[:, 2 * H:])
            h = (1.0 - z) * n + z * h
            out.append(h)
        return torch.stack(out)

    def json(self):
        res = OrderedDict([("type", "CudnnGru"),
                           ("activation", "tanh"),
                           ("gate", "sigmoid"),
                           ("size", self.size),
                           ("insize", self.insize),
                           ("bias", self.has_bias),
                           ("state0", False)])
        res["params"] = OrderedDict([
            ("iW", _cudnn_to_guppy_gru(_as_np(self.iW)).reshape(
                3, self.size, self.insize)),
            ("sW", _cudnn_to_guppy_gru(_as_np(self.sW)).reshape(
                3, self.size, self.size)),
            ("ib", _cudnn_to_guppy_gru(_as_np(self.ib)).reshape(
                3, self.size)),
            ("sb", _cudnn_to_guppy_gru(_as_np(self.sb)).reshape(
                3, self.size))])
        return res


# -- output heads ------------------------------------------------------------

class GlobalNormFlipFlop(Layer):
    """Flip-flop transition score head: scale * fun(x W^T + b).  Global
    normalisation is left to flipflop_logz."""

    def __init__(self, insize, nbase, has_bias=True, fun=activation.tanh,
                 scale=5.0):
        super().__init__()
        self.insize = insize
        self.nbase = nbase
        self.size = flipflopfings.nstate_flipflop(nbase)
        self.has_bias = has_bias
        self.activation = fun
        self.scale = scale
        self.W = _param(self.size, insize)
        if has_bias:
            self.b = _param(self.size)

    def init(self, rng):
        return _linear_init(rng, self.size, self.insize, self.has_bias)

    def forward(self, x):
        y = torch.matmul(_promote(x, self.W), self.W.t())
        if self.has_bias:
            y = y + self.b
        return self.scale * self.activation(y)

    def json(self):
        res = OrderedDict([
            ("type", "GlobalNormTwoState"),
            ("size", self.size),
            ("insize", self.insize),
            ("bias", self.has_bias),
            ("scale", self.scale),
            ("activation", self.activation.__name__)])
        res["params"] = _linear_json_params(self)
        return res


class GlobalNormFlipFlopCatMod(Layer):
    """Flip-flop head with a categorical modified-base score stream.

    Output: the 2*nbase*(nbase+1) transition scores (5 tanh) followed by
    one log-softmax per canonical base over its group of the raw mod
    columns (the shared canonical column 0 and that base's mods), width
    ncan_base + nmod_base.  The attributes are the JAX head's (can_nmods,
    output_alphabet, ordered_mod_long_names, can_mods_offsets,
    can_labels, mod_labels), as the trainer and the basecaller read
    them."""

    def __init__(self, insize, alphabet_info, has_bias=True):
        super().__init__()
        self.insize = insize
        self.has_bias = has_bias
        self.alphabet = alphabet_info.alphabet
        self.collapse_alphabet = alphabet_info.collapse_alphabet
        self.mod_long_names = alphabet_info.mod_long_names
        self.mod_name_conv = alphabet_info.mod_name_conv
        self.can_bases = alphabet_info.can_bases
        self.mod_bases = alphabet_info.mod_bases
        self.ncan_base = alphabet_info.ncan_base
        self.nmod_base = alphabet_info.nmod_base
        self.ntrans_states = 2 * self.ncan_base * (self.ncan_base + 1)
        self._compute_label_conversions()
        self._compute_mods_info()
        # raw linear output: transitions, one canonical column, the mods
        self.size = self.ntrans_states + 1 + self.nmod_base
        self.W = _param(self.size, insize)
        if has_bias:
            self.b = _param(self.size)
        for i, idx in enumerate(self.can_indices):
            self.register_buffer("_group{}".format(i),
                                 torch.from_numpy(idx.astype(np.int64)),
                                 persistent=False)

    @property
    def nbase(self):
        return self.ncan_base

    def _compute_label_conversions(self):
        """Each alphabet label's canonical label and mod category."""
        can_labels, mod_labels = [], []
        per_can_count = {b: 0 for b in self.can_bases}
        for b, can_b in zip(self.alphabet, self.collapse_alphabet):
            can_labels.append(self.can_bases.find(can_b))
            if b in self.can_bases:
                mod_labels.append(0)
            else:
                per_can_count[can_b] += 1
                mod_labels.append(per_can_count[can_b])
        self.can_labels = np.array(can_labels)
        self.mod_labels = np.array(mod_labels)

    def _compute_mods_info(self):
        """Output ordering: the alphabet of the output, the mods' long
        names in it, each base's mod count and group offsets, and the raw
        columns of each group."""
        self.output_alphabet = ""
        for can_b in self.can_bases:
            self.output_alphabet += can_b
            for b, can_bi in zip(self.alphabet, self.collapse_alphabet):
                if can_bi == can_b and b != can_b:
                    self.output_alphabet += b
        self.ordered_mod_long_names = (
            None if self.mod_long_names is None else
            [self.mod_name_conv[b] for b in self.alphabet
             if b in self.mod_bases])
        self.can_nmods = np.array(
            [sum(b == can_b for b in self.collapse_alphabet) - 1
             for can_b in self.can_bases])
        self.can_mods_offsets = np.cumsum(
            np.concatenate([[0], self.can_nmods + 1])).astype(np.int32)
        self.can_indices = []
        curr = 0
        for nmod in self.can_nmods:
            self.can_indices.append(
                np.concatenate([[0], np.arange(curr + 1, curr + 1 + nmod)]))
            curr += nmod
        self.out_size = self.ntrans_states + self.ncan_base + self.nmod_base

    def init(self, rng):
        return _linear_init(rng, self.size, self.insize, self.has_bias)

    def forward(self, x):
        y = torch.matmul(_promote(x, self.W), self.W.t())
        if self.has_bias:
            y = y + self.b
        trans = 5.0 * torch.tanh(y[..., :self.ntrans_states])
        raw = y[..., self.ntrans_states:]
        groups = [F.log_softmax(raw[..., getattr(self, "_group{}".format(i))],
                                dim=-1)
                  for i in range(len(self.can_indices))]
        return torch.cat([trans] + groups, dim=-1)

    def json(self):
        res = OrderedDict([
            ("type", "GlobalNormTwoStateCatMod"),
            ("size", self.size),
            ("insize", self.insize),
            ("bias", self.has_bias),
            ("can_nmods", self.can_nmods),
            ("output_alphabet", self.output_alphabet),
            ("modified_base_long_names", self.ordered_mod_long_names)])
        res["params"] = _linear_json_params(self)
        return res


# -- model predicates & helpers ----------------------------------------------

def is_cat_mod_model(net):
    """True if the network's last layer is a cat_mod head."""
    assert isinstance(net, Serial)
    return isinstance(net.sublayers[-1], GlobalNormFlipFlopCatMod)


def is_delta_model(net):
    """True if the network's first layer is DeltaSample."""
    assert isinstance(net, Serial)
    return isinstance(net.sublayers[0], DeltaSample)


def DownUpSample(layer, nfold):
    """`layer` between a time down-sampling by nfold and the up-sampling
    back."""
    assert layer.size % nfold == 0
    return Serial([DownSample(nfold), layer, UpSample(nfold)])


def guess_model_stride(net, input_length=720):
    """The network's total time stride, from the length of its output on a
    zero input of `input_length` samples (insize 1 where the first layer
    defines none, as DeltaSample), on the device of its parameters."""
    insize = getattr(net, "insize", 1)
    param = next(net.parameters(), None)
    device = torch.device("cpu") if param is None else param.device
    with torch.no_grad():
        out = net(torch.zeros(input_length, 1, insize, device=device))
    return int(round(input_length / out.shape[0]))
