"""Conv + 5x alternating-direction GRU + flip-flop head
(reference: models/mGru_flipflop.py:6-17)."""

from taiyaki_tpu_torch import activation, layers


def network(insize=1, size=256, winlen=19, stride=2, alphabet_info=None):
    nbase = 4 if alphabet_info is None else alphabet_info.nbase
    return layers.Serial([
        layers.Convolution(insize, size, winlen, stride=stride,
                           fun=activation.tanh),
        layers.Reverse(layers.GruMod(size, size)),
        layers.GruMod(size, size),
        layers.Reverse(layers.GruMod(size, size)),
        layers.GruMod(size, size),
        layers.Reverse(layers.GruMod(size, size)),
        layers.GlobalNormFlipFlop(size, nbase),
    ])
