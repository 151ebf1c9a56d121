// Glocal squiggle-match Viterbi (host-side, per read).
//
// The port's copy of taiyaki_tpu/decodeutil/squiggleviterbi.cpp, built by
// taiyaki_tpu_torch/decodeutil/__init__.py.
//
// Native equivalent of taiyaki_tpu/ops/squiggle.py:
// squiggle_match_viterbi_path, which is itself the TPU-framework port of
// the reference C kernel squiggle_match_viterbi
// (taiyaki/squiggle_match/c_squiggle_match.c:269-455).  The Python/numpy
// implementation loops over signal samples in the interpreter —
// minutes per real-length read (~1e5 samples); this kernel is the same
// dynamic program in C++ (the reference parallelizes over reads with
// OpenMP; here bin/map_to_squiggle.py's process pool plays that role).
//
// Semantics are kept bit-compatible with the numpy loop (which the test
// suite pins): float32 arithmetic exactly where numpy produces float32
// (penalty precursors, the emission core), float64 elsewhere, identical
// update order and strict-improvement (>) tie-breaks, first-maximum
// argmax for the tail transition.
//
// States: 0 = start, 1..npos = sequence positions, npos+1 = end,
// then npos "backward" shadow states.  Memory: like the reference, a
// full [nsample, nstate] int32 traceback is allocated (callers bound
// read length, bin/map_to_squiggle.py --max_read_length).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {
constexpr double kLarge = 1e30;
}

extern "C" float tt_squiggle_viterbi(
    const float *params,   // [npos, 3] row-major: level, log-scale, rate
    size_t npos,
    const float *signal,   // [nsample]
    size_t nsample,
    float back_prob,
    float localpen,        // LARGE_LOG_VAL => effectively global
    float minscore,        // LARGE_LOG_VAL => no emission floor
    int32_t *path_out) {   // [nsample] encoded path (see python docstring)
    const size_t nfstate = npos + 2;
    const size_t nstate = nfstate + npos;

    std::vector<float> loc(npos), logscale(npos), scale(npos);
    std::vector<double> move_pen(nfstate), stay_pen(nfstate);
    for (size_t p = 0; p < npos; p++) {
        loc[p] = params[p * 3 + 0];
        logscale[p] = params[p * 3 + 1];
        scale[p] = expf(logscale[p]);
        // f32 chain, matching numpy's weak-scalar promotion
        const float mp = (1.0f - back_prob)
            * (0.5f * (1.0f + tanhf(params[p * 3 + 2] / 2.0f)));
        move_pen[p + 1] = (double)logf(mp);
        stay_pen[p + 1] = (double)log1pf(-mp - back_prob);
    }
    double mean_move = 0.0, mean_stay = 0.0;
    for (size_t p = 1; p <= npos; p++) {
        mean_move += move_pen[p];
        mean_stay += stay_pen[p];
    }
    mean_move /= (double)npos;
    mean_stay /= (double)npos;
    move_pen[0] = move_pen[nfstate - 1] = mean_move;
    stay_pen[0] = stay_pen[nfstate - 1] = mean_stay;
    const double move_back_pen = log((double)back_prob);
    const double half = log(0.5);
    const double lpen = (double)localpen;

    std::vector<double> prev(nstate, -kLarge), curr(nstate);
    prev[0] = 0.0;
    std::vector<int32_t> traceback((size_t)nsample * nstate);
    std::vector<double> em(npos);

    for (size_t t = 0; t < nsample; t++) {
        int32_t *tb = traceback.data() + t * nstate;
        // stay in full states / back states
        for (size_t st = 0; st < nfstate; st++) {
            curr[st] = prev[st] + stay_pen[st];
            tb[st] = (int32_t)st;
        }
        for (size_t p = 0; p < npos; p++) {
            curr[nfstate + p] = prev[nfstate + p] + half;
            tb[nfstate + p] = (int32_t)(nfstate + p);
        }
        // move to next full state
        for (size_t st = 1; st < nfstate; st++) {
            const double cand = prev[st - 1] + move_pen[st - 1];
            if (cand > curr[st]) {
                curr[st] = cand;
                tb[st] = (int32_t)(st - 1);
            }
        }
        // start -> any position (head clipping): dest states 2..npos
        for (size_t d = 2; d <= npos; d++) {
            const double cand =
                prev[0] + move_pen[0] - lpen * (double)(d - 1);
            if (cand > curr[d]) {
                curr[d] = cand;
                tb[d] = 0;
            }
        }
        // any position -> end (tail clipping): first maximum wins
        {
            double best = -kLarge * 4;
            size_t best_st = 0;
            for (size_t st = 1; st < npos; st++) {
                const double cand = prev[st] + move_pen[st]
                    - lpen * (double)(npos - st);
                if (cand > best) {
                    best = cand;
                    best_st = st;
                }
            }
            if (npos > 1 && best > curr[nfstate - 1]) {
                curr[nfstate - 1] = best;
                tb[nfstate - 1] = (int32_t)best_st;
            }
        }
        // position p+1 -> back state p
        for (size_t p = 0; p + 1 < npos; p++) {
            const double cand = prev[2 + p] + move_back_pen;
            if (cand > curr[nfstate + p]) {
                curr[nfstate + p] = cand;
                tb[nfstate + p] = (int32_t)(2 + p);
            }
        }
        // back state p -> position p+1 (dest states 2..npos)
        for (size_t p = 0; p + 1 < npos; p++) {
            const double cand = prev[nfstate + p] + half;
            if (cand > curr[2 + p]) {
                curr[2 + p] = cand;
                tb[2 + p] = (int32_t)(nfstate + p);
            }
        }
        // Laplace emissions (f32 core, f64 - log(2) tail like numpy)
        for (size_t p = 0; p < npos; p++) {
            const float core =
                -fabsf(signal[t] - loc[p]) / scale[p] - logscale[p];
            double e = (double)core - M_LN2;
            if (e < -(double)minscore) e = -(double)minscore;
            em[p] = e;
        }
        for (size_t p = 0; p < npos; p++) {
            curr[1 + p] += em[p];
            curr[nfstate + p] += em[p];
        }
        curr[0] -= lpen;
        curr[nfstate - 1] -= lpen;
        prev.swap(curr);
    }

    // terminal state: last position vs end
    double score;
    int32_t st;
    if (prev[nfstate - 2] > prev[nfstate - 1]) {
        score = prev[nfstate - 2];
        st = (int32_t)(nfstate - 2);
    } else {
        score = prev[nfstate - 1];
        st = (int32_t)(nfstate - 1);
    }
    path_out[nsample - 1] = st;
    for (size_t t = nsample - 1; t > 0; t--) {
        path_out[t - 1] = traceback[t * nstate + path_out[t]];
    }

    // encode: start/end clipped to -1, positions 0-based, back states
    // mapped to their position
    size_t lo = 0;
    while (lo < nsample && path_out[lo] == 0) {
        path_out[lo] = -1;
        lo++;
    }
    size_t hi = nsample;
    while (hi > 0 && path_out[hi - 1] == (int32_t)(nfstate - 1)) {
        path_out[hi - 1] = -1;
        hi--;
    }
    for (size_t t = lo; t < hi; t++) {
        if (path_out[t] >= (int32_t)nfstate) {
            path_out[t] -= (int32_t)nfstate;
        } else {
            path_out[t] -= 1;
        }
    }
    return (float)score;
}
