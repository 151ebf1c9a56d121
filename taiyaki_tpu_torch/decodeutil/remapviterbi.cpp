// Glocal flip-flop remap Viterbi (host-side, per read).
//
// The port's copy of taiyaki_tpu/decodeutil/remapviterbi.cpp, built by
// taiyaki_tpu_torch/decodeutil/__init__.py.
//
// Native equivalent of taiyaki_tpu/flipflop_remap.py:map_to_crf_viterbi
// (itself the TPU-framework port of the reference's pure-numpy
// taiyaki/flipflop_remap.py:6-88).  The numpy loop walks T block
// boundaries in the interpreter — measured 3.0 s for a realistic read
// (T=20,000 blocks x M=10,000 positions), which dominates the
// beam+fastq basecall path (the device chain covers the same read in
// milliseconds).  This kernel is the same dynamic program in C++.
//
// Semantics are kept bit-compatible with the numpy implementation
// (pinned by tests): scores gather as float32, the lattice accumulates
// in float64 (numpy's `np.full(M, -LARGE_VAL)` is float64 and
// `prev + stay_sc` promotes), strict `>` tie-breaks everywhere, and the
// traceback is the same MSB-first bit-packing (bit m of row t+1 set =
// position m entered by a STEP from m-1 at block t).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" double tt_flipflop_remap_viterbi(
    const float *scores,        // [T, nstate] row-major
    size_t T, size_t nstate,
    const int32_t *stay_index,  // [M]
    const int32_t *step_index,  // [M-1]
    size_t M,
    double localpen,
    int32_t *path_out) {        // [T+1]; -1 = start/end state
    const double kLarge = localpen;  // callers pass LARGE_VAL for global
    (void)kLarge;
    const size_t tb_stride = (M + 7) / 8;
    std::vector<uint8_t> traceback((T + 1) * tb_stride, 0);
    std::vector<double> curr(M), prev(M);
    const double LARGE = 1e30;       // constants.LARGE_VAL
    for (size_t m = 0; m < M; m++) curr[m] = -LARGE;
    curr[0] = 0.0;
    double start_score = 0.0;
    double end_score = -LARGE;
    size_t alignment_end = 0;

    for (size_t t = 0; t < T; t++) {
        const float *row = scores + t * nstate;
        prev.swap(curr);
        uint8_t *tb = traceback.data() + (t + 1) * tb_stride;

        const float stay0 = row[stay_index[0]];
        const float stay_last = row[stay_index[M - 1]];
        const double leave_start = start_score - localpen;
        {
            const double a = (double)stay0, b = -localpen;
            start_score += (a > b) ? a : b;
        }

        const double stayed0 = prev[0] + (double)stay0;
        curr[0] = stayed0;
        // m >= 1: best of stay (prev[m] + stay_sc[m]) and step
        // (prev[m-1] + step_sc[m-1]); strict > prefers stay on ties.
        // Branchless byte-at-a-time: the compiler vectorizes the
        // select, and the traceback bits accumulate in a register
        // (one store per 8 lattice columns).
        {
            const double *__restrict__ pv = prev.data();
            double *__restrict__ cu = curr.data();
            size_t m = 1;
            while (m < M) {
                uint8_t bits = tb[m >> 3];
                const size_t mend = ((m >> 3) + 1) << 3;
                const size_t stop = mend < M ? mend : M;
                for (; m < stop; m++) {
                    const double stayed =
                        pv[m] + (double)row[stay_index[m]];
                    const double stepped =
                        pv[m - 1] + (double)row[step_index[m - 1]];
                    const int better = stepped > stayed;
                    cu[m] = better ? stepped : stayed;
                    bits |= (uint8_t)(better << (7 - (m & 7)));
                }
                tb[(m - 1) >> 3] = bits;
            }
        }
        if (start_score > curr[0]) curr[0] = start_score;
        if (leave_start > stayed0)
            tb[0] |= (uint8_t)(1u << 7);

        const double a = (double)stay_last, b = -localpen;
        const double remain_end = end_score + ((a > b) ? a : b);
        const double step_end = prev[M - 1] - localpen;
        if (step_end > remain_end) {
            end_score = step_end;
            alignment_end = t;
        } else {
            end_score = remain_end;
        }
    }

    for (size_t t = 0; t <= T; t++) path_out[t] = -1;
    size_t t;
    long m = (long)M - 1;
    if (curr[M - 1] > end_score) {
        t = T;
    } else {
        t = alignment_end;
    }
    // walk back; t is unsigned so loop on a signed copy
    for (long ti = (long)t; ti >= 0 && m >= 0; ti--) {
        path_out[ti] = (int32_t)m;
        const uint8_t *tb = traceback.data() + (size_t)ti * tb_stride;
        const int move = (tb[m >> 3] >> (7 - (m & 7))) & 1;
        m -= move;
    }
    const double best = curr[M - 1] > end_score ? curr[M - 1] : end_score;
    return best;
}
