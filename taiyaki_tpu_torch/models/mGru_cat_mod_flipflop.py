"""Conv + 5x alternating-direction GRU + categorical-mod flip-flop head
(reference: models/mGru_cat_mod_flipflop.py)."""

from taiyaki_tpu_torch import activation, layers


def network(insize=1, size=256, winlen=19, stride=2, alphabet_info=None):
    assert alphabet_info is not None, "cat_mod models need an alphabet"
    return layers.Serial([
        layers.Convolution(insize, size, winlen, stride=stride,
                           fun=activation.tanh),
        layers.Reverse(layers.GruMod(size, size)),
        layers.GruMod(size, size),
        layers.Reverse(layers.GruMod(size, size)),
        layers.GruMod(size, size),
        layers.Reverse(layers.GruMod(size, size)),
        layers.GlobalNormFlipFlopCatMod(size, alphabet_info),
    ])
