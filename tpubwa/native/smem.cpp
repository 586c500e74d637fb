// Scalar SMEM seeding, native (bwt.c:bwt_smem1a:~400, bwt_extend:~240,
// bwt_seed_strategy1:~490; bwamem.c:mem_collect_intv:~200).
//
// Exact port of tpubwa/ref/smem.py (the Python oracle stays
// independent; this is the production host fallback).  Operates
// directly on the FMIndex's packed arrays: bwt_words (16 codes per
// uint32, first base in the top bits), occ_ckpt (uint32[n_blocks+1,4]
// counts before each 128-base block), L2[5], seq_len, primary.
//
// Used for: megaq tiny-tail redo (overflow lanes), oversize-read
// scalar path — cases where a device dispatch costs more than the
// work.
#include <cstdint>
#include <climits>
#include <cstring>
#include <vector>
#include <thread>
#include <algorithm>

namespace {

struct FmIdx {
    const uint32_t* words;
    const uint32_t* ckpt;   // [n_blocks+1][4]
    int64_t L2[5];
    int64_t seq_len;
    int64_t primary;
    // text-position-marked SA (fmindex.py:build_sa_marks); optional
    const uint32_t* mark_rows = nullptr;  // [nb][8]
    const int64_t* marked_vals = nullptr;
    int64_t mark_D = 0;
};

struct Intv {
    int64_t x0, x1, size;
    int32_t qb, qe;
};

// counts of each base in stored BWT[0..k] inclusive (k in [-1, n-1]).
// One pass per word: 2-bit value histogram from 3 popcounts (c0 from
// the kept-pair count).
static void occ4_stored(const FmIdx& f, int64_t k, int64_t out[4]) {
    if (k < 0) { out[0] = out[1] = out[2] = out[3] = 0; return; }
    const int64_t blk = k >> 7;
    const uint32_t* ck = f.ckpt + blk * 4;
    const int64_t start = blk << 7;
    const int64_t w0 = blk * 8;           // WORDS_PER_BLOCK = 128/16
    const int64_t nb = k - start + 1;
    const int64_t nw = (nb + 15) >> 4;
    int64_t cnt[4] = {ck[0], ck[1], ck[2], ck[3]};
    const int rem = (int)(nb & 15);
    for (int64_t i = 0; i < nw; ++i) {
        const uint32_t w = f.words[w0 + i];
        const uint32_t keep = (i == nw - 1 && rem)
            ? (0xFFFFFFFFu << (32 - 2 * rem)) : 0xFFFFFFFFu;
        const uint32_t M = 0x55555555u & keep;   // kept pair slots
        const uint32_t hi = (w >> 1) & M;
        const uint32_t lo = w & M;
        const int c3 = __builtin_popcount(hi & lo);
        const int c2 = __builtin_popcount(hi & ~lo);
        const int c1 = __builtin_popcount(lo & ~hi);
        cnt[0] += __builtin_popcount(M) - c1 - c2 - c3;
        cnt[1] += c1; cnt[2] += c2; cnt[3] += c3;
    }
    out[0] = cnt[0]; out[1] = cnt[1]; out[2] = cnt[2]; out[3] = cnt[3];
}

// conceptual-row occ for all 4 bases (fmindex.py:occ)
static void occ4(const FmIdx& f, int64_t k, int64_t out[4]) {
    if (k == f.seq_len) {
        for (int c = 0; c < 4; ++c) out[c] = f.L2[c + 1] - f.L2[c];
        return;
    }
    if (k < 0) { out[0] = out[1] = out[2] = out[3] = 0; return; }
    if (k >= f.primary) k -= 1;
    occ4_stored(f, k, out);
}

// single-base stored count (the occ4 scan, one pattern)
static int64_t occ1_stored(const FmIdx& f, int64_t k, int c) {
    if (k < 0) return 0;
    const int64_t blk = k >> 7;
    const int64_t start = blk << 7;
    const int64_t w0 = blk * 8;
    const int64_t nb = k - start + 1;
    const int64_t nw = (nb + 15) >> 4;
    int64_t cnt = f.ckpt[blk * 4 + c];
    const int rem = (int)(nb & 15);
    const uint32_t pat = 0x55555555u * (uint32_t)c;
    for (int64_t i = 0; i < nw; ++i) {
        const uint32_t w = f.words[w0 + i];
        const uint32_t keep = (i == nw - 1 && rem)
            ? (0xFFFFFFFFu << (32 - 2 * rem)) : 0xFFFFFFFFu;
        const uint32_t x = w ^ pat;
        cnt += __builtin_popcount((~x) & ((~x) >> 1) & 0x55555555u
                                  & keep);
    }
    return cnt;
}

static int64_t occ1(const FmIdx& f, int64_t k, int c) {
    if (k == f.seq_len) return f.L2[c + 1] - f.L2[c];
    if (k < 0) return 0;
    if (k >= f.primary) k -= 1;
    return occ1_stored(f, k, c);
}

static inline int bwt_code(const FmIdx& f, int64_t k) {
    const uint32_t w = f.words[k >> 4];
    return (w >> ((15 - (k & 15)) << 1)) & 3;
}

// LF mapping on conceptual rows (bwt.h:bwt_invPsi)
static int64_t inv_psi(const FmIdx& f, int64_t k) {
    if (k == f.primary) return 0;
    const int64_t x = k - (k > f.primary ? 1 : 0);
    const int c = bwt_code(f, x);
    return f.L2[c] + occ1(f, k, c);
}

// bwt_sa via text-position marks: every walk <= D-1 LF steps
static int64_t sa_value(const FmIdx& f, int64_t k) {
    int64_t steps = 0;
    for (;;) {
        const int64_t blk = k >> 7;
        const uint32_t* row = f.mark_rows + blk * 8;
        const int within = (int)(k & 127);
        const int wi = within >> 5;
        const int bp = 31 - (within & 31);
        const uint32_t w = row[1 + wi];
        if ((w >> bp) & 1u) {
            uint32_t full = 0;
            for (int i = 0; i < wi; ++i)
                full += __builtin_popcount(row[1 + i]);
            const uint32_t part =
                bp >= 31 ? 0 : __builtin_popcount(w >> (bp + 1));
            return steps + f.marked_vals[row[0] + full + part];
        }
        k = inv_psi(f, k);
        ++steps;
    }
}

static Intv set_intv(const FmIdx& f, int c) {
    Intv ik;
    ik.x0 = f.L2[c] + 1;
    ik.x1 = f.L2[3 - c] + 1;
    ik.size = f.L2[c + 1] - f.L2[c];
    ik.qb = 0; ik.qe = 0;
    return ik;
}

// occ4 at two conceptual positions a <= b; when both stored indices
// land in the same 128-base block (common: b - a = interval size,
// usually small), one word scan serves both cutoffs.
static void occ4_pair(const FmIdx& f, int64_t a, int64_t b,
                      int64_t oa[4], int64_t ob[4]) {
    if (a < 0 || a == f.seq_len || b == f.seq_len) {
        occ4(f, a, oa);
        occ4(f, b, ob);
        return;
    }
    const int64_t ka = a - (a >= f.primary ? 1 : 0);
    const int64_t kb = b - (b >= f.primary ? 1 : 0);
    if ((ka >> 7) != (kb >> 7)) {
        occ4(f, a, oa);
        occ4(f, b, ob);
        return;
    }
    const int64_t blk = ka >> 7;
    const uint32_t* ck = f.ckpt + blk * 4;
    const int64_t start = blk << 7;
    const int64_t w0 = blk * 8;
    const int64_t na = ka - start + 1;       // bases for a's cutoff
    const int64_t nb = kb - start + 1;       // bases for b's cutoff
    const int64_t nw = (nb + 15) >> 4;
    int64_t ca[4] = {ck[0], ck[1], ck[2], ck[3]};
    int64_t cb[4] = {ck[0], ck[1], ck[2], ck[3]};
    for (int64_t i = 0; i < nw; ++i) {
        const uint32_t w = f.words[w0 + i];
        const int64_t base = i << 4;
        // b's kept pairs in this word
        const int remb = (int)(nb - base >= 16 ? 16 : nb - base);
        const uint32_t keepb =
            remb >= 16 ? 0xFFFFFFFFu : (0xFFFFFFFFu << (32 - 2 * remb));
        const uint32_t Mb = 0x55555555u & keepb;
        const uint32_t hi = (w >> 1) & Mb;
        const uint32_t lo = w & Mb;
        const int c3 = __builtin_popcount(hi & lo);
        const int c2 = __builtin_popcount(hi & ~lo);
        const int c1 = __builtin_popcount(lo & ~hi);
        const int c0 = __builtin_popcount(Mb) - c1 - c2 - c3;
        cb[0] += c0; cb[1] += c1; cb[2] += c2; cb[3] += c3;
        const int64_t ra = na - base;
        if (ra >= 16) {                      // word fully inside a
            ca[0] += c0; ca[1] += c1; ca[2] += c2; ca[3] += c3;
        } else if (ra > 0) {                 // a's partial word
            const uint32_t Ma =
                0x55555555u & (0xFFFFFFFFu << (32 - 2 * (int)ra));
            const uint32_t hia = (w >> 1) & Ma;
            const uint32_t loa = w & Ma;
            const int a3 = __builtin_popcount(hia & loa);
            const int a2 = __builtin_popcount(hia & ~loa);
            const int a1 = __builtin_popcount(loa & ~hia);
            ca[0] += __builtin_popcount(Ma) - a1 - a2 - a3;
            ca[1] += a1; ca[2] += a2; ca[3] += a3;
        }
    }
    for (int c = 0; c < 4; ++c) { oa[c] = ca[c]; ob[c] = cb[c]; }
}

// bwt.c:~240 — extend by one base; ok[4] indexed by extension base
static void bwt_extend(const FmIdx& f, const Intv& ik, bool is_back,
                       Intv ok[4]) {
    const int64_t piv = is_back ? ik.x0 : ik.x1;
    const int64_t oth = is_back ? ik.x1 : ik.x0;
    int64_t tk[4], tl[4];
    occ4_pair(f, piv - 1, piv - 1 + ik.size, tk, tl);
    for (int c = 0; c < 4; ++c) {
        const int64_t new_piv = f.L2[c] + 1 + tk[c];
        ok[c].size = tl[c] - tk[c];
        ok[c].qb = ik.qb; ok[c].qe = ik.qe;
        if (is_back) ok[c].x0 = new_piv; else ok[c].x1 = new_piv;
    }
    const int64_t sent =
        (piv <= f.primary && piv + ik.size - 1 >= f.primary) ? 1 : 0;
    int64_t acc = oth + sent;
    for (int c = 3; c >= 0; --c) {
        if (is_back) ok[c].x1 = acc; else ok[c].x0 = acc;
        acc += ok[c].size;
    }
}

// bwt.c:bwt_smem1a — SMEMs covering query position x; returns next x
static int64_t smem1a(const FmIdx& f, const uint8_t* q, int64_t len,
                      int64_t x, int64_t min_intv, int64_t max_intv,
                      std::vector<Intv>& mem_out) {
    mem_out.clear();
    if (q[x] > 3) return x + 1;
    if (min_intv < 1) min_intv = 1;
    Intv ik = set_intv(f, q[x]);
    ik.qe = (int32_t)(x + 1);
    if (max_intv && ik.size <= max_intv) {
        mem_out.push_back(ik);
        return x + 1;
    }
    static thread_local std::vector<Intv> curr, prev;
    curr.clear(); prev.clear();
    Intv ok[4];
    int64_t i = x + 1;
    while (i < len) {
        if (ik.size < max_intv) {          // (never with max_intv == 0)
            curr.push_back(ik);
            break;
        } else if (q[i] < 4) {
            const int c = 3 - q[i];        // forward ext via revcomp side
            bwt_extend(f, ik, false, ok);
            if (ok[c].size != ik.size) {
                curr.push_back(ik);
                if (ok[c].size < min_intv) break;
            }
            ik = ok[c];
            ik.qe = (int32_t)(i + 1);
        } else {
            curr.push_back(ik);
            break;
        }
        ++i;
    }
    if (i == len) curr.push_back(ik);
    std::reverse(curr.begin(), curr.end());
    const int64_t ret = curr[0].qe;

    prev.swap(curr);
    i = x - 1;
    while (i >= -1) {
        const int c = (i < 0 || q[i] > 3) ? -1 : (int)q[i];
        curr.clear();
        for (size_t pj = 0; pj < prev.size(); ++pj) {
            const Intv& p = prev[pj];
            if (pj + 1 < prev.size()) {
                // the scans are memory-latency-bound: overlap the
                // next stack entry's block fetches with this one
                const int64_t np = prev[pj + 1].x0 - 1;
                const int64_t nk = np - (np >= f.primary ? 1 : 0);
                if (nk >= 0) {
                    __builtin_prefetch(f.words + (nk >> 7) * 8);
                    __builtin_prefetch(f.ckpt + (nk >> 7) * 4);
                }
            }
            bool has_ok = false;
            if (c >= 0 && ik.size >= max_intv) {
                bwt_extend(f, p, true, ok);
                has_ok = true;
            }
            if (c < 0 || ik.size < max_intv ||
                (has_ok && ok[c].size < min_intv)) {
                if (curr.empty()) {        // shorter matches contained
                    if (mem_out.empty() ||
                        (int64_t)(i + 1) < mem_out.back().qb) {
                        Intv m = p;
                        m.qb = (int32_t)(i + 1);
                        mem_out.push_back(m);
                    }
                }
            } else if (curr.empty() || ok[c].size != curr.back().size) {
                Intv nk = ok[c];
                nk.qb = p.qb; nk.qe = p.qe;
                curr.push_back(nk);
            }
        }
        if (curr.empty()) break;
        prev.swap(curr);
        --i;
    }
    std::reverse(mem_out.begin(), mem_out.end());
    return ret;
}

// bwt.c:bwt_seed_strategy1 — forward-only round-3 seeding
static int64_t seed_strategy1(const FmIdx& f, const uint8_t* q,
                              int64_t len, int64_t x, int64_t min_len,
                              int64_t max_intv, Intv* m, bool* got) {
    *got = false;
    if (q[x] > 3) return x + 1;
    Intv ik = set_intv(f, q[x]);
    Intv ok[4];
    for (int64_t i = x + 1; i < len; ++i) {
        if (q[i] < 4) {
            const int c = 3 - q[i];
            bwt_extend(f, ik, false, ok);
            if (ok[c].size < max_intv && i - x >= min_len) {
                *m = ok[c];
                m->qb = (int32_t)x; m->qe = (int32_t)(i + 1);
                *got = true;
                return i + 1;
            }
            ik = ok[c];
        } else {
            return i + 1;
        }
    }
    return len;
}

struct Out {
    int64_t* rows;   // (x0, x1, size, qb, qe[, rid]) per row
    int64_t cap, n, width;
    bool overflow;
    void push(const Intv& m, int64_t rid) {
        if (n < cap) {
            int64_t* r = rows + n * width;
            r[0] = m.x0; r[1] = m.x1; r[2] = m.size;
            r[3] = m.qb; r[4] = m.qe;
            if (width > 5) r[5] = rid;
        } else {
            overflow = true;
        }
        ++n;
    }
};

// round 1 over the whole read, rows sorted by (qb, qe) — the mirror
// of device/smem.py:_scalar_round1
static void round1_sorted(const FmIdx& f, const uint8_t* q, int64_t len,
                          int64_t min_seed_len, std::vector<Intv>& out) {
    out.clear();
    std::vector<Intv> tmp;
    int64_t x = 0;
    while (x < len) {
        if (q[x] < 4) {
            x = smem1a(f, q, len, x, 1, 0, tmp);
            for (const Intv& p : tmp)
                if (p.qe - p.qb >= min_seed_len) out.push_back(p);
        } else {
            ++x;
        }
    }
    std::stable_sort(out.begin(), out.end(),
                     [](const Intv& a, const Intv& b) {
                         return a.qb != b.qb ? a.qb < b.qb : a.qe < b.qe;
                     });
}

}  // namespace

extern "C" {

void* tpubwa_smem_init(const uint32_t* words, const uint32_t* ckpt,
                       const int64_t* L2, int64_t seq_len,
                       int64_t primary) {
    FmIdx* f = new FmIdx();
    f->words = words;
    f->ckpt = ckpt;
    for (int i = 0; i < 5; ++i) f->L2[i] = L2[i];
    f->seq_len = seq_len;
    f->primary = primary;
    return f;
}

void tpubwa_smem_free(void* h) { delete (FmIdx*)h; }

// attach the text-position-marked SA arrays (optional; host SA walk)
void tpubwa_sa_init(void* h, const uint32_t* mark_rows,
                    const int64_t* marked_vals, int64_t D) {
    FmIdx* f = (FmIdx*)h;
    f->mark_rows = mark_rows;
    f->marked_vals = marked_vals;
    f->mark_D = D;
}

// bwa's per-interval occurrence subsampling + bounded SA walks
// (bwamem.c:mem_chain head ~330; device/pipeline.py:_sa_positions
// mirror): rows are (x0, size); per row step = size > max_occ ?
// size / max_occ : 1, cnt = min(ceil(size / step), max_occ); ranks
// x0 + j * step.  out_cnt[n_rows] gets cnt; positions concatenate in
// row order.  Returns total positions, -needed if cap was too small,
// or INT64_MIN when marks are absent.
int64_t tpubwa_sa_positions(void* h, const int64_t* x0,
                            const int64_t* size, int64_t n_rows,
                            int64_t max_occ, int64_t nthreads,
                            int64_t* out_pos, int64_t cap,
                            int64_t* out_cnt) {
    const FmIdx& f = *(const FmIdx*)h;
    if (!f.mark_rows || f.mark_D <= 0) return INT64_MIN;
    if (max_occ <= 0) {              // -c 0: every seed over-occ
        for (int64_t r = 0; r < n_rows; ++r) out_cnt[r] = 0;
        return 0;
    }
    // pass 1: counts + exact output offsets (cheap, no walks)
    std::vector<int64_t> off((size_t)n_rows + 1, 0);
    for (int64_t r = 0; r < n_rows; ++r) {
        const int64_t sz = size[r];
        const int64_t step = sz > max_occ ? sz / max_occ : 1;
        const int64_t cnt =
            sz > 0 ? std::min((sz + step - 1) / step, max_occ) : 0;
        out_cnt[r] = cnt;
        off[(size_t)r + 1] = off[(size_t)r] + cnt;
    }
    const int64_t n = off[(size_t)n_rows];
    if (n > cap) return -n;
    // pass 2: the walks, row-range-split over nthreads (deterministic:
    // every position's slot is fixed by the offsets)
    const int64_t T = std::max<int64_t>(
        1, std::min<int64_t>(nthreads, n_rows));
    auto work = [&](int64_t t) {
        const int64_t lo = n_rows * t / T;
        const int64_t hi = n_rows * (t + 1) / T;
        for (int64_t r = lo; r < hi; ++r) {
            const int64_t sz = size[r];
            const int64_t step = sz > max_occ ? sz / max_occ : 1;
            int64_t* w = out_pos + off[(size_t)r];
            for (int64_t j = 0; j < out_cnt[r]; ++j)
                w[j] = sa_value(f, x0[r] + j * step);
        }
    };
    if (T == 1) {
        work(0);
    } else {
        std::vector<std::thread> th;
        for (int64_t t = 0; t < T; ++t) th.emplace_back(work, t);
        for (auto& x : th) x.join();
    }
    return n;
}

// Full 3-round mem_collect_intv for one read; rows (x0,x1,size,qb,qe)
// sorted by (qb, qe).  Returns row count, or -needed if cap was too
// small (caller re-allocates exactly).
int64_t tpubwa_smem_collect(void* h, const uint8_t* q, int64_t len,
                            int64_t min_seed_len, int64_t split_len,
                            int64_t split_width, int64_t max_mem_intv,
                            int64_t* out_rows, int64_t cap) {
    const FmIdx& f = *(const FmIdx*)h;
    std::vector<Intv> mems, tmp;
    int64_t x = 0;
    while (x < len) {                      // round 1
        if (q[x] < 4) {
            x = smem1a(f, q, len, x, 1, 0, tmp);
            for (const Intv& p : tmp)
                if (p.qe - p.qb >= min_seed_len) mems.push_back(p);
        } else {
            ++x;
        }
    }
    const size_t old_n = mems.size();      // round 2
    for (size_t k = 0; k < old_n; ++k) {
        const Intv p = mems[k];
        if (p.qe - p.qb < split_len || p.size > split_width) continue;
        smem1a(f, q, len, (p.qb + p.qe) >> 1, p.size + 1, 0, tmp);
        for (const Intv& s : tmp)
            if (s.qe - s.qb >= min_seed_len) mems.push_back(s);
    }
    if (max_mem_intv > 0) {                // round 3
        x = 0;
        Intv m; bool got;
        while (x < len) {
            if (q[x] < 4) {
                x = seed_strategy1(f, q, len, x, min_seed_len,
                                   max_mem_intv, &m, &got);
                if (got && m.size > 0) mems.push_back(m);
            } else {
                ++x;
            }
        }
    }
    std::stable_sort(mems.begin(), mems.end(),
                     [](const Intv& a, const Intv& b) {
                         return a.qb != b.qb ? a.qb < b.qb : a.qe < b.qe;
                     });
    if ((int64_t)mems.size() > cap) return -(int64_t)mems.size();
    for (size_t i = 0; i < mems.size(); ++i) {
        int64_t* r = out_rows + i * 5;
        r[0] = mems[i].x0; r[1] = mems[i].x1; r[2] = mems[i].size;
        r[3] = mems[i].qb; r[4] = mems[i].qe;
    }
    return (int64_t)mems.size();
}

// Batched full 3-round collect for a read chunk (the host seeding
// mode): per-read rows sorted by (qb, qe), concatenated in read
// order, rid in column 5.  nthreads > 1 splits the reads into
// contiguous ranges (bwa -t; output order is deterministic either
// way).  Returns row count or -needed.
int64_t tpubwa_smem_collect_batch(void* h, const uint8_t* reads,
                                  int64_t stride, const int32_t* lens,
                                  int64_t n_reads,
                                  int64_t min_seed_len,
                                  int64_t split_len,
                                  int64_t split_width,
                                  int64_t max_mem_intv,
                                  int64_t nthreads,
                                  int64_t* out_rows, int64_t cap) {
    const int64_t T = std::max<int64_t>(
        1, std::min<int64_t>(nthreads, n_reads));
    std::vector<std::vector<int64_t>> parts((size_t)T);
    auto work = [&](int64_t t) {
        const int64_t lo = n_reads * t / T;
        const int64_t hi = n_reads * (t + 1) / T;
        std::vector<int64_t>& out = parts[(size_t)t];
        std::vector<int64_t> one((size_t)(4 * stride + 64) * 5);
        for (int64_t ri = lo; ri < hi; ++ri) {
            const uint8_t* q = reads + ri * stride;
            int64_t c = (int64_t)one.size() / 5;
            int64_t m = tpubwa_smem_collect(
                h, q, lens[ri], min_seed_len, split_len, split_width,
                max_mem_intv, one.data(), c);
            if (m < 0) {
                one.resize((size_t)(-m) * 5);
                m = tpubwa_smem_collect(
                    h, q, lens[ri], min_seed_len, split_len,
                    split_width, max_mem_intv, one.data(), -m);
            }
            for (int64_t i = 0; i < m; ++i) {
                out.insert(out.end(), one.begin() + i * 5,
                           one.begin() + i * 5 + 5);
                out.push_back(ri);
            }
        }
    };
    if (T == 1) {
        work(0);
    } else {
        std::vector<std::thread> th;
        for (int64_t t = 0; t < T; ++t) th.emplace_back(work, t);
        for (auto& x : th) x.join();
    }
    int64_t n = 0;
    for (auto& p : parts) n += (int64_t)p.size() / 6;
    if (n > cap) return -n;
    int64_t* w = out_rows;
    for (auto& p : parts) {
        std::memcpy(w, p.data(), p.size() * sizeof(int64_t));
        w += p.size();
    }
    return n;
}

// The _scalar_full job batch (device/smem_fused.py): jobs are
// (read_idx, x, min_intv, one_shot) int64[nj,4]; one-shot jobs reseed
// from x with min_intv; full jobs run sorted round 1 plus ALL of
// their round-2 reseeds (jobs built from the sorted round-1 rows in
// row order, the _r2_jobs_from mirror).  Output rows are
// (x0,x1,size,qb,qe,rid) in exactly the Python emission order.
// Returns row count or -needed.
int64_t tpubwa_smem_jobs(void* h, const uint8_t* reads, int64_t stride,
                         const int32_t* lens, const int64_t* jobs,
                         int64_t nj, int64_t min_seed_len,
                         int64_t split_len, int64_t split_width,
                         int64_t* out_rows, int64_t cap) {
    const FmIdx& f = *(const FmIdx*)h;
    Out out{out_rows, cap, 0, 6, false};
    std::vector<Intv> r1, tmp;
    for (int64_t j = 0; j < nj; ++j) {
        const int64_t ri = jobs[j * 4 + 0];
        const int64_t x = jobs[j * 4 + 1];
        const int64_t mi = jobs[j * 4 + 2];
        const bool osh = jobs[j * 4 + 3] != 0;
        const uint8_t* q = reads + ri * stride;
        const int64_t len = lens[ri];
        if (osh) {
            smem1a(f, q, len, x, mi, 0, tmp);
            for (const Intv& p : tmp)
                if (p.qe - p.qb >= min_seed_len) out.push(p, ri);
            continue;
        }
        round1_sorted(f, q, len, min_seed_len, r1);
        for (const Intv& p : r1) out.push(p, ri);
        for (const Intv& p : r1) {         // _r2_jobs_from mirror
            if (p.qe - p.qb < split_len || p.size > split_width)
                continue;
            smem1a(f, q, len, (p.qb + p.qe) >> 1, p.size + 1, 0, tmp);
            for (const Intv& s : tmp)
                if (s.qe - s.qb >= min_seed_len) out.push(s, ri);
        }
    }
    return out.overflow ? -out.n : out.n;
}

}  // extern "C"
