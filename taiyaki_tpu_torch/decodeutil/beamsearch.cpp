// Prefix beam-search decoder for flip-flop CRF transition scores.
//
// The port's copy of taiyaki_tpu/decodeutil/beamsearch.cpp, built by
// taiyaki_tpu_torch/decodeutil/__init__.py.
//
// Re-implementation (from scratch, C++) of the capability of the
// reference's hash-based beam search (taiyaki/decodeutil/c_hashdecode.c):
// beam elements are *sequence prefixes* (flip-flop state strings); each
// carries the log-sum score of all paths collapsing to that prefix and
// currently dwelling in its last state.  Extensions are merged by a
// 64-bit chained hash of the prefix; ranking may be guided by backward
// scores (sum over future paths) and pruned by beam_cut in log space.
//
// Exposed C ABI (ctypes):
//   float tt_flipflop_beamsearch(const float* score, size_t nbase,
//                                size_t nblock, const float* bwd,
//                                int beam_width, float beamcut,
//                                int8_t* seq_out);
//   float tt_flipflop_forward(const float* score, size_t nbase,
//                             size_t nblock, float* out,
//                             const float* init);
//   float tt_flipflop_backward(const float* score, size_t nbase,
//                              size_t nblock, float* out,
//                              const float* init);

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr float NEG_LARGE = -1e30f;

inline float logsumexp2(float x, float y) {
    if (x == NEG_LARGE) return y;
    if (y == NEG_LARGE) return x;
    float hi = std::max(x, y), lo = std::min(x, y);
    float d = hi - lo;
    return (d > 17.0f) ? hi : hi + std::log1p(std::exp(-d));
}

inline size_t move_idx(size_t from, size_t to, size_t nbase) {
    return from + 2 * nbase * std::min(to, nbase);
}

inline size_t stay_idx(size_t st, size_t nbase) {
    return move_idx(st, st, nbase);
}

// Chained prefix hash: order-dependent mix of the previous hash and the
// appended state (splitmix64 finalizer).
inline uint64_t chain_hash(uint64_t h, uint64_t state) {
    uint64_t x = h ^ (state + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2));
    x ^= x >> 30; x *= 0xbf58476d1ce4e5b9ull;
    x ^= x >> 27; x *= 0x94d049bb133111ebull;
    x ^= x >> 31;
    return x;
}

struct Element {
    uint64_t hash;      // identity of the prefix
    int32_t arena;      // arena node of the prefix (or of the parent if
                        // `extended` and not yet materialized)
    int8_t last;        // last flip-flop state
    bool extended;      // true if arena still refers to the parent prefix
    float score;        // logsum over paths for this prefix
    float rank;         // score + guide, used for beam selection
};

struct ArenaNode {
    int32_t parent;
    int8_t state;
};

}  // namespace

extern "C" {

// Forward partition scan over 2*nbase states; out (optional) is
// [(nblock+1) x 2*nbase] ABSOLUTE boundary scores (the reference's
// contract: fwd[t] + bwd[t] is meaningful, decodeutil.pyx:forward).
// init (optional) seeds boundary 0; NULL = zeros, as the reference's
// zero-filled result array.  Internally the scan renormalizes per block
// for f32 safety and adds the offset back when writing rows.
float tt_flipflop_forward(const float* score, size_t nbase, size_t nblock,
                          float* out, const float* init) {
    const size_t nstate = 2 * nbase;
    std::vector<float> cur(nstate), nxt(nstate);
    for (size_t s = 0; s < nstate; s++) cur[s] = init ? init[s] : 0.0f;
    float logz = 0.0f;
    if (out) std::memcpy(out, cur.data(), nstate * sizeof(float));
    for (size_t t = 0; t < nblock; t++) {
        const float* sc = score + t * nstate * (nbase + 1);
        // into flip d: from every state
        for (size_t d = 0; d < nbase; d++) {
            float acc = NEG_LARGE;
            for (size_t q = 0; q < nstate; q++)
                acc = logsumexp2(acc, cur[q] + sc[move_idx(q, d, nbase)]);
            nxt[d] = acc;
        }
        // into flop d: from flip d or stay in flop d
        for (size_t d = 0; d < nbase; d++) {
            float a = cur[d] + sc[move_idx(d, d + nbase, nbase)];
            float b = cur[d + nbase] + sc[stay_idx(d + nbase, nbase)];
            nxt[nbase + d] = logsumexp2(a, b);
        }
        float mx = *std::max_element(nxt.begin(), nxt.end());
        for (size_t s = 0; s < nstate; s++) nxt[s] -= mx;
        logz += mx;
        cur.swap(nxt);
        if (out)
            for (size_t s = 0; s < nstate; s++)
                out[(t + 1) * nstate + s] = cur[s] + logz;
    }
    float acc = NEG_LARGE;
    for (size_t s = 0; s < nstate; s++) acc = logsumexp2(acc, cur[s]);
    return logz + acc;
}

// Backward partition scan; out (optional) is [(nblock+1) x 2*nbase]
// ABSOLUTE scores: out[t][q] = logsum of future paths starting in state
// q at boundary t.  init (optional) seeds boundary nblock (NULL = zeros).
float tt_flipflop_backward(const float* score, size_t nbase, size_t nblock,
                           float* out, const float* init) {
    const size_t nstate = 2 * nbase;
    std::vector<float> cur(nstate, 0.0f), nxt(nstate);
    if (init) for (size_t s = 0; s < nstate; s++) cur[s] = init[s];
    float logz = 0.0f;
    if (out) std::memcpy(out + nblock * nstate, cur.data(),
                         nstate * sizeof(float));
    for (size_t tt = nblock; tt-- > 0;) {
        const float* sc = score + tt * nstate * (nbase + 1);
        for (size_t q = 0; q < nstate; q++) {
            float acc = NEG_LARGE;
            for (size_t d = 0; d < nbase; d++)
                acc = logsumexp2(acc, sc[move_idx(q, d, nbase)] + cur[d]);
            if (q < nbase)  // flip q -> flop q
                acc = logsumexp2(acc,
                                 sc[move_idx(q, q + nbase, nbase)]
                                 + cur[q + nbase]);
            else            // stay in flop
                acc = logsumexp2(acc, sc[stay_idx(q, nbase)] + cur[q]);
            nxt[q] = acc;
        }
        float mx = *std::max_element(nxt.begin(), nxt.end());
        for (size_t s = 0; s < nstate; s++) nxt[s] -= mx;
        logz += mx;
        cur.swap(nxt);
        if (out)
            for (size_t s = 0; s < nstate; s++)
                out[tt * nstate + s] = cur[s] + logz;
    }
    float acc = NEG_LARGE;
    for (size_t q = 0; q < nbase; q++) acc = logsumexp2(acc, cur[q]);
    return logz + acc;
}

// Beam search.  score: [nblock x 2*nbase*(nbase+1)]; bwd: optional
// [(nblock+1) x 2*nbase] guide (pass NULL for unguided); seq_out: int8
// buffer of length >= nblock+1, -1 terminated.  Returns best score.
float tt_flipflop_beamsearch(const float* score, size_t nbase,
                             size_t nblock, const float* bwd,
                             int beam_width, float beamcut,
                             int8_t* seq_out) {
    const size_t nstate = 2 * nbase;
    const size_t ntrans = nstate * (nbase + 1);

    std::vector<ArenaNode> arena;
    arena.reserve(1024);
    std::vector<Element> beam, cand;
    // Start elements: each flip state as a length-1 prefix.
    for (size_t s = 0; s < nbase; s++) {
        arena.push_back({-1, (int8_t)s});
        uint64_t h = chain_hash(0x1234abcdull, s);
        beam.push_back({h, (int32_t)(arena.size() - 1), (int8_t)s, false,
                        0.0f, 0.0f});
    }

    std::unordered_map<uint64_t, size_t> merged;
    for (size_t t = 0; t < nblock; t++) {
        const float* sc = score + t * ntrans;
        const float* guide = bwd ? bwd + (t + 1) * nstate : nullptr;
        cand.clear();
        merged.clear();

        // extended=false candidates carry the arena node of the full
        // prefix; extended=true ones carry the *parent's* node and are
        // materialized only if they survive selection.  Merging prefers
        // an existing (non-extended) node.
        auto add_candidate = [&](uint64_t h, int32_t arena_ref, bool ext,
                                 int8_t last, float s) {
            auto it = merged.find(h);
            if (it != merged.end()) {
                Element& e = cand[it->second];
                e.score = logsumexp2(e.score, s);
                if (e.extended && !ext) {
                    e.arena = arena_ref;
                    e.extended = false;
                }
            } else {
                merged.emplace(h, cand.size());
                cand.push_back({h, arena_ref, last, ext, s, 0.0f});
            }
        };

        for (const Element& e : beam) {
            const size_t q = (size_t)e.last;
            // stay: same prefix
            add_candidate(e.hash, e.arena, false, e.last,
                          e.score + sc[stay_idx(q, nbase)]);
            // moves to flip d (move with d == q is the stay)
            for (size_t d = 0; d < nbase; d++) {
                if (q == d) continue;
                add_candidate(chain_hash(e.hash, d), e.arena, true,
                              (int8_t)d,
                              e.score + sc[move_idx(q, d, nbase)]);
            }
            // flip q -> flop q (only legal flop entry)
            if (q < nbase) {
                size_t d = q + nbase;
                add_candidate(chain_hash(e.hash, d), e.arena, true,
                              (int8_t)d,
                              e.score + sc[move_idx(q, d, nbase)]);
            }
        }

        float best_rank = NEG_LARGE;
        for (Element& e : cand) {
            e.rank = e.score + (guide ? guide[(size_t)e.last] : 0.0f);
            best_rank = std::max(best_rank, e.rank);
        }
        size_t keep = std::min((size_t)beam_width, cand.size());
        std::partial_sort(cand.begin(), cand.begin() + keep, cand.end(),
                          [](const Element& a, const Element& b) {
                              return a.rank > b.rank;
                          });
        cand.resize(keep);
        if (beamcut > 0.0f) {
            while (cand.size() > 1
                   && cand.back().rank < best_rank - beamcut)
                cand.pop_back();
        }
        for (Element& e : cand) {
            if (e.extended) {
                arena.push_back({e.arena, e.last});
                e.arena = (int32_t)(arena.size() - 1);
                e.extended = false;
            }
        }
        beam.swap(cand);
    }

    // best by pure score
    const Element* best = &beam[0];
    for (const Element& e : beam)
        if (e.score > best->score) best = &e;

    // walk the arena chain; sequence is reversed
    std::vector<int8_t> rev;
    for (int32_t a = best->arena; a >= 0; a = arena[(size_t)a].parent)
        rev.push_back(arena[(size_t)a].state);
    size_t n = rev.size();
    for (size_t i = 0; i < n; i++) seq_out[i] = rev[n - 1 - i];
    if (n < nblock + 1) seq_out[n] = -1;
    return best->score;
}

}  // extern "C"
