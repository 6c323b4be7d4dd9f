// hnsw.cpp — in-repo HNSW approximate-nearest-neighbor index.
//
// The reference delegated ANN search to hnswlib (C++) behind ChromaDB
// (reference: src/medical_engine.py:52). This is an original, from-the-paper
// implementation (Malkov & Yashunin, arXiv:1603.09320) providing the same
// capability in-repo. Its primary job in this framework is the honest
// recall-parity harness: the BASELINE target is "recall@10 >= Chroma-HNSW
// parity at equal memory", and you cannot measure parity against an engine
// you cannot run — so the CPU-side HNSW lives here, exposed to Python via a
// C ABI + ctypes (benchmarks/parity.py).
//
// Metric: inner product on L2-normalized vectors (cosine), matching the
// device engine. dist = -dot so smaller is better.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// epoch-stamped visited set: avoids an O(n) allocation per search. One per
// thread in batch search — the graph itself is read-only during queries.
struct VisitTable {
    std::vector<uint32_t> stamp;
    uint32_t epoch = 0;
};

struct Hnsw {
    int dim;
    int M;            // max links per node, upper levels
    int M0;           // max links at level 0 (2*M)
    int efc;          // efConstruction
    double level_mult;

    std::vector<float> vecs;                 // n * dim, contiguous
    std::vector<uint64_t> labels;
    std::vector<int> node_level;
    // links[l] is a flat array: node -> [count, n0, n1, ...] stride (cap+1)
    std::vector<std::vector<int>> links;     // per level
    int entry = -1;
    int max_level = -1;
    std::mt19937 rng{12345};
    // scratch for build-time searches (single-writer); query-time batch
    // search uses per-thread tables instead
    mutable VisitTable build_visit;

    size_t n() const { return labels.size(); }

    float dist(const float* a, const float* b) const {
        float s = 0.f;
        for (int i = 0; i < dim; ++i) s += a[i] * b[i];
        return -s;
    }
    const float* vec(int id) const { return vecs.data() + (size_t)id * dim; }

    int cap(int level) const { return level == 0 ? M0 : M; }

    int* neigh(int level, int id) {
        return links[level].data() + (size_t)id * (cap(level) + 1);
    }

    int random_level() {
        std::uniform_real_distribution<double> u(0.0, 1.0);
        double r = u(rng);
        int lvl = (int)(-std::log(std::max(r, 1e-12)) * level_mult);
        return std::min(lvl, 32);
    }

    void ensure_level(int level) {
        while ((int)links.size() <= level) {
            int l = (int)links.size();
            links.emplace_back();
            links[l].resize(vecs.capacity() / dim * (cap(l) + 1), 0);
        }
        for (int l = 0; l < (int)links.size(); ++l) {
            size_t need = (n() + 1) * (cap(l) + 1);
            if (links[l].size() < need) links[l].resize(need * 2, 0);
        }
    }

    // beam search at one level; returns min-heap-ordered vector of
    // (dist, id) pairs, best first, size <= ef.
    std::vector<std::pair<float, int>> search_layer(
        const float* q, int ep, int level, int ef,
        VisitTable& vt) const {
        using P = std::pair<float, int>;
        std::priority_queue<P> best;                       // max-heap by dist
        std::priority_queue<P, std::vector<P>, std::greater<P>> cand;
        auto& visited_stamp = vt.stamp;
        if (visited_stamp.size() < n()) visited_stamp.resize(n() * 2 + 64, 0);
        const uint32_t epoch = ++vt.epoch;

        float d0 = dist(q, vec(ep));
        best.push({d0, ep});
        cand.push({d0, ep});
        visited_stamp[ep] = epoch;

        while (!cand.empty()) {
            auto [dc, c] = cand.top();
            if (dc > best.top().first && (int)best.size() >= ef) break;
            cand.pop();
            const int* nb = links[level].data() + (size_t)c * (cap(level) + 1);
            int cnt = nb[0];
            for (int j = 1; j <= cnt; ++j) {
                int u = nb[j];
                if (visited_stamp[u] == epoch) continue;
                visited_stamp[u] = epoch;
                float du = dist(q, vec(u));
                if ((int)best.size() < ef || du < best.top().first) {
                    best.push({du, u});
                    cand.push({du, u});
                    if ((int)best.size() > ef) best.pop();
                }
            }
        }
        std::vector<P> out;
        out.reserve(best.size());
        while (!best.empty()) { out.push_back(best.top()); best.pop(); }
        std::sort(out.begin(), out.end());
        return out;
    }

    // simple neighbor-selection heuristic from the paper (keep diverse set)
    std::vector<int> select_neighbors(
        const float* q, std::vector<std::pair<float, int>>& cands, int m) const {
        std::vector<int> out;
        for (auto& [dq, id] : cands) {
            if ((int)out.size() >= m) break;
            bool ok = true;
            for (int sel : out) {
                if (dist(vec(id), vec(sel)) < dq) { ok = false; break; }
            }
            if (ok) out.push_back(id);
        }
        // backfill with closest if the heuristic was too aggressive
        for (auto& [dq, id] : cands) {
            if ((int)out.size() >= m) break;
            if (std::find(out.begin(), out.end(), id) == out.end())
                out.push_back(id);
        }
        return out;
    }

    void link(int level, int a, int b) {
        int* nb = neigh(level, a);
        int c = cap(level);
        if (nb[0] < c) {
            nb[++nb[0]] = b;
            return;
        }
        // over capacity: re-select among existing + new
        std::vector<std::pair<float, int>> cands;
        cands.reserve(nb[0] + 1);
        cands.push_back({dist(vec(a), vec(b)), b});
        for (int j = 1; j <= nb[0]; ++j)
            cands.push_back({dist(vec(a), vec(nb[j])), nb[j]});
        std::sort(cands.begin(), cands.end());
        auto sel = select_neighbors(vec(a), cands, c);
        nb[0] = (int)sel.size();
        for (int j = 0; j < (int)sel.size(); ++j) nb[j + 1] = sel[j];
    }

    void add(const float* v, uint64_t label) {
        int id = (int)n();
        vecs.insert(vecs.end(), v, v + dim);
        labels.push_back(label);
        int lvl = random_level();
        node_level.push_back(lvl);
        ensure_level(lvl);

        if (entry < 0) { entry = id; max_level = lvl; return; }

        int ep = entry;
        // greedy descent through levels above lvl
        for (int l = max_level; l > lvl; --l) {
            bool improved = true;
            float de = dist(v, vec(ep));
            while (improved) {
                improved = false;
                const int* nb = neigh(l, ep);
                for (int j = 1; j <= nb[0]; ++j) {
                    float dn = dist(v, vec(nb[j]));
                    if (dn < de) { de = dn; ep = nb[j]; improved = true; }
                }
            }
        }
        // beam insert at levels min(lvl, max_level)..0
        for (int l = std::min(lvl, max_level); l >= 0; --l) {
            auto cands = search_layer(v, ep, l, efc, build_visit);
            auto sel = select_neighbors(v, cands, cap(l));
            int* nb = neigh(l, id);
            nb[0] = (int)sel.size();
            for (int j = 0; j < (int)sel.size(); ++j) nb[j + 1] = sel[j];
            for (int s : sel) link(l, s, id);
            if (!cands.empty()) ep = cands.front().second;
        }
        if (lvl > max_level) { max_level = lvl; entry = id; }
    }

    int search(const float* q, int k, int ef,
               uint64_t* out_labels, float* out_scores,
               VisitTable& vt) const {
        if (entry < 0) return 0;
        int ep = entry;
        for (int l = max_level; l > 0; --l) {
            bool improved = true;
            float de = dist(q, vec(ep));
            while (improved) {
                improved = false;
                const int* nb = links[l].data() + (size_t)ep * (cap(l) + 1);
                for (int j = 1; j <= nb[0]; ++j) {
                    float dn = dist(q, vec(nb[j]));
                    if (dn < de) { de = dn; ep = nb[j]; improved = true; }
                }
            }
        }
        auto res = search_layer(q, ep, 0, std::max(ef, k), vt);
        int m = std::min((int)res.size(), k);
        for (int i = 0; i < m; ++i) {
            out_labels[i] = labels[res[i].second];
            out_scores[i] = -res[i].first;          // back to similarity
        }
        return m;
    }

    size_t memory_bytes() const {
        size_t b = vecs.size() * 4 + labels.size() * 8 + node_level.size() * 4;
        for (auto& l : links) b += l.size() * 4;
        return b;
    }
};

}  // namespace

extern "C" {

void* hnsw_create(int dim, int M, int ef_construction) {
    auto* h = new Hnsw();
    h->dim = dim;
    h->M = M;
    h->M0 = 2 * M;
    h->efc = ef_construction;
    h->level_mult = 1.0 / std::log(std::max(M, 2));
    return h;
}

void hnsw_add(void* p, const float* vec, uint64_t label) {
    static_cast<Hnsw*>(p)->add(vec, label);
}

void hnsw_add_batch(void* p, const float* vecs, const uint64_t* lab, int n) {
    auto* h = static_cast<Hnsw*>(p);
    for (int i = 0; i < n; ++i) h->add(vecs + (size_t)i * h->dim, lab[i]);
}

int hnsw_search(void* p, const float* q, int k, int ef,
                uint64_t* labels, float* scores) {
    auto* h = static_cast<Hnsw*>(p);
    return h->search(q, k, ef, labels, scores, h->build_visit);
}

// Parallel batch search: OpenMP over the query batch, one VisitTable per
// thread (the graph is read-only during queries, so this is race-free —
// hnswlib parallelizes queries the same way). threads<=0 means "all cores".
// out_labels/out_scores are [nq, k]; out_counts[i] = hits for query i
// (slots past the count are untouched). Returns the thread count used.
int hnsw_search_batch(void* p, const float* qs, int nq, int k, int ef,
                      uint64_t* out_labels, float* out_scores,
                      int* out_counts, int threads) {
    auto* h = static_cast<Hnsw*>(p);
#ifdef _OPENMP
    int nt = threads > 0 ? threads : omp_get_max_threads();
    std::vector<VisitTable> vts(nt);
#pragma omp parallel for schedule(dynamic, 4) num_threads(nt)
    for (int i = 0; i < nq; ++i) {
        VisitTable& vt = vts[omp_get_thread_num()];
        out_counts[i] = h->search(qs + (size_t)i * h->dim, k, ef,
                                  out_labels + (size_t)i * k,
                                  out_scores + (size_t)i * k, vt);
    }
    return nt;
#else
    VisitTable vt;
    for (int i = 0; i < nq; ++i)
        out_counts[i] = h->search(qs + (size_t)i * h->dim, k, ef,
                                  out_labels + (size_t)i * k,
                                  out_scores + (size_t)i * k, vt);
    return 1;
#endif
}

uint64_t hnsw_memory_bytes(void* p) {
    return static_cast<Hnsw*>(p)->memory_bytes();
}

uint64_t hnsw_size(void* p) { return static_cast<Hnsw*>(p)->n(); }

void hnsw_free(void* p) { delete static_cast<Hnsw*>(p); }

}  // extern "C"
