"""Model layers as `torch.nn.Module`s (port of taiyaki_tpu/layers.py).

Each layer keeps the JAX layer's constructor signature, so the text of a
model-description file runs unchanged, and names its parameters as the
JAX parameter pytree does, so a flattened pytree is the module's
`state_dict` (see `taiyaki_tpu_torch.convert`).  `init(rng)` draws that
pytree with a `numpy.random.Generator` in the JAX package's order, so one
seed gives the same weights in both packages.

Tensor convention: time x batch x features (TBF) throughout.

Only the layers of the mLstm and mGru models (flip-flop and cat_mod) are
ported; every other layer of the JAX package raises NotImplementedError
naming itself.  Parameters are trainable: the convolutions and the head
take their gradients from autograd, the LSTM and GRU layers from the
backward kernels of `ops.rnn.lstm_layer` and `ops.rnn.gru_layer`.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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


# -- base --------------------------------------------------------------------

class Layer(nn.Module):
    """Base class.  `insize`/`size` give feature counts, `stride` the time
    down-sampling factor (1 unless overridden)."""

    stride = 1

    def init(self, rng):
        """Draw this layer's parameter pytree (numpy) from a numpy
        Generator, exactly as the JAX layer's `init` does."""
        return {}


def _not_ported(name):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "layer {} is not ported to taiyaki_tpu_torch yet (the port "
            "runs the mLstm and mGru flip-flop and cat_mod models: Serial, "
            "Reverse, Convolution, Lstm, GruMod, GlobalNormFlipFlop, "
            "GlobalNormFlipFlopCatMod)"
            .format(name))
    return type(name, (Layer,), {"__init__": __init__,
                                 "__doc__": "Not ported yet."})


FeedForward = _not_ported("FeedForward")
Softmax = _not_ported("Softmax")
TimeLinear = _not_ported("TimeLinear")
Identity = _not_ported("Identity")
Studentise = _not_ported("Studentise")
DeltaSample = _not_ported("DeltaSample")
Window = _not_ported("Window")
UpSample = _not_ported("UpSample")
DownSample = _not_ported("DownSample")
Parallel = _not_ported("Parallel")
Product = _not_ported("Product")
Residual = _not_ported("Residual")
GatedResidual = _not_ported("GatedResidual")
SoftChoice = _not_ported("SoftChoice")
CudnnGru = _not_ported("CudnnGru")


def birnn(forward, backward):
    return Parallel([forward, Reverse(backward)])


def DownUpSample(layer, nfold):
    return Serial([DownSample(nfold), layer, UpSample(nfold)])


# -- combinators -------------------------------------------------------------

class Serial(Layer):
    """Apply layers in sequence."""

    def __init__(self, layers):
        super().__init__()
        self.sublayers = nn.ModuleList(layers)

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
        for layer in self.sublayers:
            x = layer(x)
        return x


class Reverse(Layer):
    """Run the enclosed layer backwards in time.  A recurrent layer takes
    the direction as an argument (the kernel walks time backwards, no
    flipped copies); any other layer runs on flipped input."""

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


class GruMod(Layer):
    """Guppy-compatible GRU: torch/CUDNN GRU cell equations with the
    redundant hidden bias pinned to zero; gates stacked in CUDNN's order
    r, z, n (iW [3H, insize], sW [3H, H], b [3H]).  With has_bias=False, b
    stays zero."""

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
        y = torch.matmul(x, self.W.t())
        if self.has_bias:
            y = y + self.b
        return self.scale * self.activation(y)


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
        y = torch.matmul(x, self.W.t())
        if self.has_bias:
            y = y + self.b
        trans = 5.0 * torch.tanh(y[..., :self.ntrans_states])
        raw = y[..., self.ntrans_states:]
        groups = [F.log_softmax(raw[..., getattr(self, "_group{}".format(i))],
                                dim=-1)
                  for i in range(len(self.can_indices))]
        return torch.cat([trans] + groups, dim=-1)


def is_cat_mod_model(net):
    """True if the network's last layer is a cat_mod head."""
    assert isinstance(net, Serial)
    return isinstance(net.sublayers[-1], GlobalNormFlipFlopCatMod)
