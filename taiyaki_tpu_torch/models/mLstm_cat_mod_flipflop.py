"""3-conv stack + 5x alternating-direction LSTM + categorical-mod
flip-flop head (reference: models/mLstm_cat_mod_flipflop.py:8-20)."""

from taiyaki_tpu_torch import activation, layers


def network(insize=1, size=256, winlen=19, stride=5, alphabet_info=None):
    assert alphabet_info is not None, "cat_mod models need an alphabet"
    winlen2 = 5
    return layers.Serial([
        layers.Convolution(insize, 4, winlen2, stride=1,
                           fun=activation.swish),
        layers.Convolution(4, 16, winlen2, stride=1, fun=activation.swish),
        layers.Convolution(16, size, winlen, stride=stride,
                           fun=activation.swish),
        layers.Reverse(layers.Lstm(size, size)),
        layers.Lstm(size, size),
        layers.Reverse(layers.Lstm(size, size)),
        layers.Lstm(size, size),
        layers.Reverse(layers.Lstm(size, size)),
        layers.GlobalNormFlipFlopCatMod(size, alphabet_info),
    ])
