"""The host Viterbis' numpy loops on the CPU: with TAIYAKI_TPU_NO_NATIVE_REMAP=1
the port's remap Viterbi and with TAIYAKI_TPU_NO_NATIVE=1 its squiggle
Viterbi take the JAX package's loops, which give the JAX loops' results
bit for bit, and the port's C++ paths with the scores within 1e-6
relative; a failed build raises and names both switches, and a switched
decoder needs no build."""

import numpy as np
import pytest

from taiyaki_tpu import flipflop_remap as jremap
from taiyaki_tpu.ops import squiggle as jsquiggle
from taiyaki_tpu_torch import decodeutil as tdu
from taiyaki_tpu_torch import flipflop_remap as tremap
from taiyaki_tpu_torch.ops import squiggle as tsquiggle

REMAP_SWITCH = "TAIYAKI_TPU_NO_NATIVE_REMAP"
SQUIGGLE_SWITCH = "TAIYAKI_TPU_NO_NATIVE"


def _remap_case(seed, T=300, M=60):
    """Log posteriors [T, 40] of a seeded read and a seeded sequence of M
    bases."""
    rng = np.random.default_rng(seed)
    x = 2.0 * rng.normal(size=(T, 40))
    x = (x - np.log(np.exp(x).sum(axis=1, keepdims=True))).astype(
        np.float32)
    return x, "".join(rng.choice(list("ACGT"), M))


@pytest.mark.parametrize("localpen", [0.5, 4.0, 1e30])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_remap_loop(seed, localpen, monkeypatch):
    x, seq = _remap_case(seed)
    cscore, cpath = tremap.flipflop_remap(x, seq, localpen=localpen)
    monkeypatch.setenv(REMAP_SWITCH, "1")
    nscore, npath = tremap.flipflop_remap(x, seq, localpen=localpen)
    jscore, jpath = jremap.flipflop_remap(x, seq, localpen=localpen)
    assert nscore == jscore
    np.testing.assert_array_equal(npath, jpath)
    np.testing.assert_array_equal(npath, cpath)
    assert abs(nscore - cscore) <= 1e-6 * abs(cscore)
    assert npath.max() == len(seq) - 1


def _squiggle_case(seed, npos=40, nsample=300):
    rng = np.random.default_rng(seed)
    params = np.stack([rng.normal(size=npos),
                       0.2 * rng.normal(size=npos) - 1.0,
                       rng.normal(size=npos)], axis=1).astype(np.float32)
    dwell = nsample // npos + 1
    signal = (np.repeat(params[:, 0], dwell)[:nsample]
              + 0.3 * rng.normal(size=nsample)).astype(np.float32)
    return params, signal


@pytest.mark.parametrize("localpen,minscore", [(None, None), (2.0, 5.0),
                                               (0.5, None)])
@pytest.mark.parametrize("seed", [0, 1])
def test_squiggle_loop(seed, localpen, minscore, monkeypatch):
    params, signal = _squiggle_case(seed)
    back = 0.05
    cscore, cpath = tsquiggle.squiggle_match_viterbi_path(
        params, signal, back, localpen, minscore)
    monkeypatch.setenv(SQUIGGLE_SWITCH, "1")
    nscore, npath = tsquiggle.squiggle_match_viterbi_path(
        params, signal, back, localpen, minscore)
    jscore, jpath = jsquiggle.squiggle_match_viterbi_path(
        params, signal, back, localpen, minscore)
    assert nscore == jscore
    np.testing.assert_array_equal(npath, jpath)
    np.testing.assert_array_equal(npath, cpath)
    assert abs(nscore - cscore) <= 1e-6 * abs(cscore)


@pytest.fixture
def broken_build(tmp_path, monkeypatch):
    """A decodeutil build that fails: a source g++ rejects."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("TAIYAKI_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tdu, "_LIB", None)
    monkeypatch.setattr(tdu, "_SRCS", tdu._SRCS + [str(bad)])


def test_failed_build_names_the_switches(broken_build, monkeypatch):
    x, seq = _remap_case(3, T=40, M=8)
    params, signal = _squiggle_case(3, npos=6, nsample=40)
    for call in (lambda: tremap.flipflop_remap(x, seq),
                 lambda: tsquiggle.squiggle_match_viterbi_path(
                     params, signal, 0.05)):
        with pytest.raises(RuntimeError) as e:
            call()
        assert "g++ exit" in str(e.value)
        assert REMAP_SWITCH + "=1" in str(e.value)
        assert SQUIGGLE_SWITCH + "=1" in str(e.value)
    # switched, each decoder runs its loop and builds nothing
    monkeypatch.setenv(REMAP_SWITCH, "1")
    monkeypatch.setenv(SQUIGGLE_SWITCH, "1")
    assert tremap.flipflop_remap(x, seq)[1].max() == len(seq) - 1
    assert len(tsquiggle.squiggle_match_viterbi_path(
        params, signal, 0.05)[1]) == len(signal)
    assert tdu._LIB is None


def test_missing_compiler_names_the_switches(tmp_path, monkeypatch):
    monkeypatch.setenv("TAIYAKI_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(tdu, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found.*"
                       + REMAP_SWITCH):
        tremap.flipflop_remap(*_remap_case(4, T=40, M=8))
