// Glocal (query-global, reference-local) affine-gap sequence alignment.
//
// The port's copy of taiyaki_tpu/decodeutil/seqalign.cpp, built by
// taiyaki_tpu_torch/decodeutil/__init__.py.
//
// Role: the stand-in for `bwa mem` where no aligner binary is installed
// (cli/align.py).  At basecaller-assessment scale (one query vs its known
// reference, a few kb each) a full DP is milliseconds in C++ and exact:
// no seeding heuristics are needed.
//
// Scoring matches the reference's bwa-mem defaults (-A 1 -B 2 -O 2 -E 1):
// match +A, mismatch -B, gap open -(O+E), gap extend -E.  The query must
// align end to end (global in query); the reference start and end are free
// (local in reference), which is the right shape for "this read came from
// somewhere in this reference".

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int32_t NEG = std::numeric_limits<int32_t>::min() / 4;

// traceback codes per cell, 2 bits per matrix packed in one byte
// H: 0 = diag, 1 = from E (deletion), 2 = from F (insertion)
// E: bit 4 set = extend (came from E), else open (came from H)
// F: bit 5 set = extend (came from F), else open (came from H)
constexpr uint8_t H_DIAG = 0, H_FROME = 1, H_FROMF = 2, H_MASK = 3;
constexpr uint8_t E_EXT = 1 << 4;
constexpr uint8_t F_EXT = 1 << 5;

}  // namespace

extern "C" {

// query/ref: base codes (0..3; any negative value never matches).
// cigar_ops/cigar_lens: caller buffers of capacity *ncigar; ops are
// 0 = M (match or mismatch), 1 = I (query-only), 2 = D (ref-only).
// Returns the alignment score, or NEG on error (capacity exceeded /
// empty inputs).  *ref_start / *ref_end: aligned reference span
// [start, end).  *nm: edit distance of the alignment (mismatches +
// inserted + deleted bases), i.e. the SAM NM tag.
int32_t tt_seq_align(const int8_t* query, size_t nq,
                     const int8_t* ref, size_t nr,
                     int32_t match, int32_t mismatch,
                     int32_t gap_open, int32_t gap_extend,
                     int32_t* cigar_ops, int32_t* cigar_lens,
                     int32_t* ncigar, int32_t* ref_start,
                     int32_t* ref_end, int32_t* nm) {
    if (nq == 0 || nr == 0) return NEG;
    const int32_t open_cost = gap_open + gap_extend;

    // Row-wise DP over the query; full traceback matrix (1 byte/cell).
    std::vector<int32_t> H(nr + 1), E(nr + 1), Hprev(nr + 1), Fcol(nr + 1);
    std::vector<uint8_t> tb((nq + 1) * (nr + 1));

    // i = 0: free reference start (H = 0 everywhere), gaps closed.
    for (size_t j = 0; j <= nr; ++j) {
        Hprev[j] = 0;
        Fcol[j] = NEG;
    }
    for (size_t i = 1; i <= nq; ++i) {
        uint8_t* tbrow = &tb[i * (nr + 1)];
        // j = 0: query consumed against nothing -> insertion run.
        int32_t f0 = (i == 1) ? Hprev[0] - open_cost : Fcol[0] - gap_extend;
        Fcol[0] = f0;
        H[0] = f0;
        tbrow[0] = H_FROMF | ((i == 1) ? 0 : F_EXT);
        E[0] = NEG;
        int32_t e = NEG;
        const int8_t qb = query[i - 1];
        for (size_t j = 1; j <= nr; ++j) {
            uint8_t cell = 0;
            // E: gap in query (consume ref)
            int32_t e_open = H[j - 1] - open_cost;
            int32_t e_ext = e - gap_extend;
            if (e_ext > e_open) { e = e_ext; cell |= E_EXT; }
            else e = e_open;
            // F: gap in ref (consume query)
            int32_t f_open = Hprev[j] - open_cost;
            int32_t f_ext = Fcol[j] - gap_extend;
            int32_t f;
            if (f_ext > f_open) { f = f_ext; cell |= F_EXT; }
            else f = f_open;
            Fcol[j] = f;
            // H: diagonal vs gap states
            int32_t diag = Hprev[j - 1] +
                ((qb >= 0 && qb == ref[j - 1]) ? match : -mismatch);
            int32_t h = diag;  // cell H bits stay H_DIAG
            if (e > h) { h = e; cell = (cell & ~H_MASK) | H_FROME; }
            if (f > h) { h = f; cell = (cell & ~H_MASK) | H_FROMF; }
            H[j] = h;
            tbrow[j] = cell;
        }
        std::swap(H, Hprev);
    }

    // Free reference end: best score anywhere in the last row.
    size_t best_j = 0;
    int32_t best = NEG;
    for (size_t j = 0; j <= nr; ++j)
        if (Hprev[j] > best) { best = Hprev[j]; best_j = j; }

    // Traceback from (nq, best_j) to i == 0.
    const int32_t cap = *ncigar;
    int32_t nops = 0;
    int32_t edits = 0;
    size_t i = nq, j = best_j;
    int state = 0;  // 0 = H, 1 = E, 2 = F
    auto push = [&](int32_t op) -> bool {
        if (nops > 0 && cigar_ops[nops - 1] == op) {
            ++cigar_lens[nops - 1];
            return true;
        }
        if (nops >= cap) return false;
        cigar_ops[nops] = op;
        cigar_lens[nops] = 1;
        ++nops;
        return true;
    };
    while (i > 0) {
        const uint8_t cell = tb[i * (nr + 1) + j];
        if (state == 0) {
            const uint8_t h = cell & H_MASK;
            if (h == H_DIAG) {
                if (!push(0)) return NEG;
                const int8_t qb = query[i - 1];
                if (!(qb >= 0 && j > 0 && qb == ref[j - 1])) ++edits;
                --i; --j;
            } else if (h == H_FROME) {
                state = 1;
            } else {
                state = 2;
            }
        } else if (state == 1) {       // E: deletion (consume ref)
            if (!push(2)) return NEG;
            ++edits;
            state = (cell & E_EXT) ? 1 : 0;
            --j;
        } else {                       // F: insertion (consume query)
            if (!push(1)) return NEG;
            ++edits;
            state = (cell & F_EXT) ? 2 : 0;
            --i;
        }
    }

    // ops were collected tip-to-root; reverse into read order.
    for (int32_t a = 0, b = nops - 1; a < b; ++a, --b) {
        std::swap(cigar_ops[a], cigar_ops[b]);
        std::swap(cigar_lens[a], cigar_lens[b]);
    }
    *ncigar = nops;
    *ref_start = static_cast<int32_t>(j);
    *ref_end = static_cast<int32_t>(best_j);
    *nm = edits;
    return best;
}

}  // extern "C"
