"""The port's host decoders (`taiyaki_tpu_torch.decodeutil`: forward and
backward partition scans, beam search, remap Viterbi) bitwise against
`taiyaki_tpu.decodeutil` on seeded scores, and `flipflop_remap` against
the JAX package's (its C++ and its numpy loop); the build: into the build
directory at first use, never beside the sources, raising if g++ fails."""

import os

import numpy as np
import pytest

from taiyaki_tpu import decodeutil as jdu
from taiyaki_tpu import flipflop_remap as jremap
from taiyaki_tpu import flipflopfings
from taiyaki_tpu_torch import decodeutil as tdu
from taiyaki_tpu_torch import flipflop_remap as tremap


def _scores(seed, nblk, nbase=4, scale=2.0, log_posteriors=False):
    rng = np.random.default_rng(seed)
    x = (scale * rng.normal(size=(nblk, flipflopfings.nstate_flipflop(
        nbase)))).astype(np.float32)
    if log_posteriors:       # rows of log probabilities, as basecall gives
        x = (x - np.log(np.exp(x).sum(axis=1, keepdims=True))).astype(
            np.float32)
    return x


@pytest.mark.parametrize("nbase", [2, 4])
@pytest.mark.parametrize("seeded", [False, True])
def test_partition_scans_bitwise(nbase, seeded):
    x = _scores(0, 50, nbase)
    init = (np.random.default_rng(1).normal(size=2 * nbase).astype(
        np.float32) if seeded else None)
    for jf, tf in ((jdu.forward, tdu.forward), (jdu.backward, tdu.backward)):
        (jo, jz), (to, tz) = jf(x, init=init), tf(x, init=init)
        assert to.dtype == jo.dtype == np.float32
        np.testing.assert_array_equal(to, jo)
        assert tz == jz


@pytest.mark.parametrize("width,guided,cut", [(1, True, 0.0), (5, True, 0.0),
                                              (5, False, 0.0), (16, True, 0.0),
                                              (5, True, 3.0)])
@pytest.mark.parametrize("seed", [2, 3])
def test_beamsearch_bitwise(width, guided, cut, seed):
    x = _scores(seed, 400, log_posteriors=True)
    jseq, jscore = jdu.beamsearch(x, beam_cut=cut, beam_width=width,
                                  guided=guided)
    tseq, tscore = tdu.beamsearch(x, beam_cut=cut, beam_width=width,
                                  guided=guided)
    assert tseq.dtype == np.int8 and len(tseq) > 1
    np.testing.assert_array_equal(tseq, jseq)
    assert tscore == jscore


def _remap_case(seed, nblk=300, nseq=60):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list("ACGT"), size=nseq))
    return _scores(seed, nblk, log_posteriors=True), seq


@pytest.mark.parametrize("localpen", [None, 0.5, 20.0])
@pytest.mark.parametrize("seed", [4, 5])
def test_flipflop_remap_matches_jax(localpen, seed, monkeypatch):
    """Score and path bitwise as the JAX package's C++ remap, global
    (localpen None: LARGE_VAL) and glocal; against its numpy loop, the
    same path and the score to f32 rounding (that loop keeps its start and
    end states in f32, the C++ in f64)."""
    x, seq = _remap_case(seed)
    kw = {} if localpen is None else {"localpen": localpen}
    tscore, tpath = tremap.flipflop_remap(x, seq, **kw)
    jscore, jpath = jremap.flipflop_remap(x, seq, **kw)
    assert tscore == jscore
    np.testing.assert_array_equal(tpath, jpath)
    monkeypatch.setenv("TAIYAKI_TPU_NO_NATIVE_REMAP", "1")
    nscore, npath = jremap.flipflop_remap(x, seq, **kw)
    assert abs(tscore - nscore) < 1e-5 * max(1.0, abs(nscore))
    np.testing.assert_array_equal(tpath, npath)
    assert tpath.max() == len(seq) - 1 or localpen is not None


def test_remap_viterbi_bitwise_and_checks_columns():
    x, seq = _remap_case(6)
    bases = np.array(["ACGT".find(b) for b in seq])
    flops = flipflopfings.flopmask(bases)
    stay = np.where(flops, bases + 36, bases + 8 * bases)
    step = (bases + 4 * flops)[:-1] + 8 * np.maximum(bases, 4 * flops)[1:]
    for pen in (1.0, 1e30):
        tscore, tpath = tdu.remap_viterbi(x, stay, step, pen)
        jscore, jpath = jdu.remap_viterbi(x, stay, step, pen)
        assert tscore == jscore
        np.testing.assert_array_equal(tpath, jpath)
    with pytest.raises(ValueError, match="out of range"):
        tdu.remap_viterbi(x, stay, step + 40, 1.0)
    with pytest.raises(ValueError, match="entries"):
        tdu.remap_viterbi(x, stay, step[:-1], 1.0)


def test_builds_into_the_build_directory(tmp_path, monkeypatch):
    """First use compiles into the build directory (the port's _build/ or
    $TAIYAKI_TORCH_BUILD_DIR), under a hashed name; nothing lands beside
    the sources, and the library works."""
    src_dir = os.path.dirname(tdu.__file__)
    before = sorted(os.listdir(src_dir))
    monkeypatch.setenv("TAIYAKI_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tdu, "_LIB", None)
    x = _scores(7, 30)
    assert tdu.forward(x)[1] == jdu.forward(x)[1]
    built = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert len(built) == 1 and built[0].startswith("decodeutil-")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert sorted(os.listdir(src_dir)) == before


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("TAIYAKI_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tdu, "_LIB", None)
    monkeypatch.setattr(tdu, "_SRCS", tdu._SRCS + [str(bad)])
    with pytest.raises(RuntimeError, match="decodeutil build failed"):
        tdu.beamsearch(_scores(8, 10))
    assert not os.listdir(str(tmp_path / "build"))
