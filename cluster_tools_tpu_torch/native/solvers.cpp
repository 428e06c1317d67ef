// Native combinatorial graph solvers.
//
// The PyTorch port's own copy of cluster_tools_tpu/native/solvers.cpp (the
// port imports nothing of the JAX package).  Inherently sequential,
// pointer-chasing graph algorithms stay on the host in C++ (the role
// nifty/affogato play for the reference — SURVEY.md §2.10): greedy additive
// edge contraction (GAEC) multicut, threshold agglomerative clustering, and
// the mutex watershed.  Exposed as a plain C ABI consumed via ctypes.
//
// Reference behaviors mirrored:
//   * GAEC: elf.segmentation.multicut 'greedy-additive' solver
//     (multicut/solve_subproblems.py:184, solve_global.py:147-153)
//   * agglomerative clustering: elf mala_clustering / agglomerative_clustering
//     (watershed/agglomerate.py:190-198, agglomerative_clustering.py:138)
//   * mutex watershed: affogato compute_mws_segmentation
//     (mutex_watershed/mws_blocks.py:11)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct UnionFind {
    std::vector<int64_t> parent;
    std::vector<int64_t> rank_;

    explicit UnionFind(int64_t n) : parent(n), rank_(n, 0) {
        for (int64_t i = 0; i < n; ++i) parent[i] = i;
    }

    int64_t find(int64_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    }

    // returns the new root (or -1 if already merged)
    int64_t merge(int64_t a, int64_t b) {
        a = find(a);
        b = find(b);
        if (a == b) return -1;
        if (rank_[a] < rank_[b]) std::swap(a, b);
        parent[b] = a;
        if (rank_[a] == rank_[b]) ++rank_[a];
        return a;
    }
};

struct HeapEntry {
    double priority;
    int64_t u, v;
    uint64_t stamp;  // lazy invalidation: entry valid iff stamp matches edge stamp

    bool operator<(const HeapEntry& o) const { return priority < o.priority; }
};

struct EdgeVal {
    double w;  // accumulated value: sum (additive) or weighted mean (mean mode)
    double c;  // accumulated multiplicity (edge count / size)
};

// Dynamic contracted graph: per-root adjacency map root -> (neighbor -> EdgeVal).
struct DynamicGraph {
    std::vector<std::unordered_map<int64_t, EdgeVal>> adj;
    std::unordered_map<uint64_t, uint64_t> edge_stamp;  // key(u,v) -> stamp
    uint64_t stamp_counter = 0;

    explicit DynamicGraph(int64_t n) : adj(n) {}

    static uint64_t key(int64_t u, int64_t v, int64_t n) {
        if (u > v) std::swap(u, v);
        return static_cast<uint64_t>(u) * static_cast<uint64_t>(n) +
               static_cast<uint64_t>(v);
    }
};

// Core greedy agglomeration: repeatedly contract the max-priority edge while
// priority > stop_priority.  Parallel edges accumulate additively
// (mean_mode=false, GAEC) or by count-weighted mean (mean_mode=true,
// mala-style clustering; priority = -mean so the *lowest* boundary merges
// first).  Returns node -> root labels in `labels`.
void greedy_agglomeration(int64_t n_nodes, int64_t n_edges, const int64_t* uv,
                          const double* weights, const double* counts,
                          bool mean_mode, double stop_priority,
                          int64_t* labels) {
    UnionFind uf(n_nodes);
    DynamicGraph g(n_nodes);
    std::priority_queue<HeapEntry> heap;

    auto combine = [mean_mode](const EdgeVal& a, const EdgeVal& b) {
        if (mean_mode)
            return EdgeVal{(a.w * a.c + b.w * b.c) / (a.c + b.c), a.c + b.c};
        return EdgeVal{a.w + b.w, a.c + b.c};
    };
    auto priority = [mean_mode](const EdgeVal& e) {
        return mean_mode ? -e.w : e.w;
    };

    for (int64_t e = 0; e < n_edges; ++e) {
        int64_t u = uv[2 * e], v = uv[2 * e + 1];
        if (u == v) continue;
        EdgeVal val{weights[e], counts ? counts[e] : 1.0};
        auto it = g.adj[u].find(v);
        if (it == g.adj[u].end()) {
            g.adj[u][v] = val;
            g.adj[v][u] = val;
        } else {
            EdgeVal merged = combine(it->second, val);
            it->second = merged;
            g.adj[v][u] = merged;
        }
    }
    for (int64_t u = 0; u < n_nodes; ++u) {
        for (const auto& kv : g.adj[u]) {
            if (kv.first > u) {
                uint64_t k = DynamicGraph::key(u, kv.first, n_nodes);
                g.edge_stamp[k] = 0;
                heap.push({priority(kv.second), u, kv.first, 0});
            }
        }
    }

    while (!heap.empty()) {
        HeapEntry top = heap.top();
        heap.pop();
        int64_t u = uf.find(top.u), v = uf.find(top.v);
        if (u == v) continue;
        uint64_t k = DynamicGraph::key(u, v, n_nodes);
        auto st = g.edge_stamp.find(k);
        if (st == g.edge_stamp.end() || st->second != top.stamp) continue;
        if (top.priority <= stop_priority) break;

        // contract v into u (keep the larger adjacency as the base)
        if (g.adj[u].size() < g.adj[v].size()) std::swap(u, v);
        int64_t root = uf.merge(u, v);
        if (root != u) {  // union-by-rank picked v's tree; relabel so data at u
            std::swap(u, v);
        }
        // move v's edges into u
        g.adj[u].erase(v);
        g.adj[v].erase(u);
        for (const auto& kv : g.adj[v]) {
            int64_t w = kv.first;
            g.adj[w].erase(v);
            auto it = g.adj[u].find(w);
            EdgeVal merged;
            if (it == g.adj[u].end()) {
                merged = kv.second;
                g.adj[u][w] = merged;
                g.adj[w][u] = merged;
            } else {
                merged = combine(it->second, kv.second);
                it->second = merged;
                g.adj[w][u] = merged;
            }
            uint64_t nk = DynamicGraph::key(u, w, n_nodes);
            uint64_t stamp = ++g.stamp_counter;
            g.edge_stamp[nk] = stamp;
            heap.push({priority(merged), u, w, stamp});
        }
        g.adj[v].clear();
    }

    for (int64_t i = 0; i < n_nodes; ++i) labels[i] = uf.find(i);
}

// Lifted GAEC: contraction only along local edges, priority = combined
// local+lifted inter-cluster cost, both cost maps merge on contraction
// (nifty's liftedGraphEdgeWeightedClusterPolicy behavior, used by the
// reference through elf's lifted 'greedy-additive' solver).
void lifted_gaec_impl(int64_t n_nodes, int64_t n_edges, const int64_t* uv,
                      const double* costs, int64_t n_lifted,
                      const int64_t* lifted_uv, const double* lifted_costs,
                      int64_t* labels) {
    UnionFind uf(n_nodes);
    std::vector<std::unordered_map<int64_t, double>> local(n_nodes);
    std::vector<std::unordered_map<int64_t, double>> lifted(n_nodes);
    std::unordered_map<uint64_t, uint64_t> edge_stamp;
    uint64_t stamp_counter = 0;
    std::priority_queue<HeapEntry> heap;

    for (int64_t e = 0; e < n_edges; ++e) {
        int64_t u = uv[2 * e], v = uv[2 * e + 1];
        if (u == v) continue;
        local[u][v] += costs[e];
        local[v][u] = local[u][v];
    }
    for (int64_t e = 0; e < n_lifted; ++e) {
        int64_t u = lifted_uv[2 * e], v = lifted_uv[2 * e + 1];
        if (u == v) continue;
        lifted[u][v] += lifted_costs[e];
        lifted[v][u] = lifted[u][v];
    }
    auto combined = [&](int64_t u, int64_t v) {
        double c = local[u].at(v);
        auto it = lifted[u].find(v);
        if (it != lifted[u].end()) c += it->second;
        return c;
    };
    for (int64_t u = 0; u < n_nodes; ++u) {
        for (const auto& kv : local[u]) {
            if (kv.first > u) {
                edge_stamp[DynamicGraph::key(u, kv.first, n_nodes)] = 0;
                heap.push({combined(u, kv.first), u, kv.first, 0});
            }
        }
    }

    while (!heap.empty()) {
        HeapEntry top = heap.top();
        heap.pop();
        int64_t u = uf.find(top.u), v = uf.find(top.v);
        if (u == v) continue;
        uint64_t k = DynamicGraph::key(u, v, n_nodes);
        auto st = edge_stamp.find(k);
        if (st == edge_stamp.end() || st->second != top.stamp) continue;
        if (top.priority <= 0.0) break;

        if (local[u].size() + lifted[u].size() <
            local[v].size() + lifted[v].size())
            std::swap(u, v);
        int64_t root = uf.merge(u, v);
        if (root != u) std::swap(u, v);
        local[u].erase(v);
        local[v].erase(u);
        lifted[u].erase(v);
        lifted[v].erase(u);
        std::unordered_set<int64_t> touched;
        for (auto* m : {&local, &lifted}) {
            for (const auto& kv : (*m)[v]) {
                int64_t w = kv.first;
                (*m)[w].erase(v);
                (*m)[u][w] += kv.second;
                (*m)[w][u] = (*m)[u][w];
                touched.insert(w);
            }
            (*m)[v].clear();
        }
        for (const auto& kv : local[u]) touched.insert(kv.first);
        for (int64_t w : touched) {
            if (local[u].find(w) == local[u].end()) continue;  // lifted-only
            uint64_t nk = DynamicGraph::key(u, w, n_nodes);
            uint64_t stamp = ++stamp_counter;
            edge_stamp[nk] = stamp;
            heap.push({combined(u, w), u, w, stamp});
        }
    }

    for (int64_t i = 0; i < n_nodes; ++i) labels[i] = uf.find(i);
}

// ---------------------------------------------------------------------------
// Single-core DT-watershed benchmark baseline.
//
// The honest host comparator for the fused TPU program (ops/watershed.py
// dt_watershed): the same per-block pipeline the reference runs through
// vigra/C++ (watershed/watershed.py:286-344) — threshold → per-slice exact
// 2d EDT (Felzenszwalb) → gaussian → 3x3 maxima → CC seeds → height map →
// priority flood → size filter — implemented as plain single-thread C++.
// ---------------------------------------------------------------------------

// exact 1d squared distance transform (Felzenszwalb & Huttenlocher lower
// envelope), f = input costs, d = output, v/z = scratch (size n / n+1)
void edt_1d(const float* f, float* d, int64_t n, int64_t* v, float* z) {
    int64_t k = 0;
    v[0] = 0;
    z[0] = -3.0e38f;
    z[1] = 3.0e38f;
    for (int64_t q = 1; q < n; ++q) {
        float s;
        while (true) {
            int64_t p = v[k];
            s = ((f[q] + q * q) - (f[p] + p * p)) / (2.0f * (q - p));
            if (s > z[k]) break;
            --k;
        }
        ++k;
        v[k] = q;
        z[k] = s;
        z[k + 1] = 3.0e38f;
    }
    k = 0;
    for (int64_t q = 0; q < n; ++q) {
        while (z[k + 1] < q) ++k;
        int64_t p = v[k];
        d[q] = (q - p) * (q - p) + f[p];
    }
}

// separable 2d squared EDT of one slice (distance to nearest background==0)
void edt_2d(const uint8_t* fg, float* dist, int64_t ny, int64_t nx,
            float* tmp, float* col, float* cold, int64_t* v, float* z) {
    const float BIG = 1.0e10f;
    for (int64_t y = 0; y < ny; ++y) {
        // exact 1d line distance along x, squared
        float run = BIG;
        for (int64_t x = 0; x < nx; ++x) {
            run = fg[y * nx + x] ? ((run >= BIG) ? BIG : run + 1.0f) : 0.0f;
            tmp[y * nx + x] = run;
        }
        run = BIG;
        for (int64_t x = nx - 1; x >= 0; --x) {
            run = fg[y * nx + x] ? ((run >= BIG) ? BIG : run + 1.0f) : 0.0f;
            float m = std::min(tmp[y * nx + x], run);
            tmp[y * nx + x] = (m >= BIG) ? BIG : m * m;
        }
    }
    for (int64_t x = 0; x < nx; ++x) {
        for (int64_t y = 0; y < ny; ++y) col[y] = tmp[y * nx + x];
        edt_1d(col, cold, ny, v, z);
        for (int64_t y = 0; y < ny; ++y) dist[y * nx + x] = cold[y];
    }
}

// separable gaussian blur of one slice, reflect boundary
void gaussian_2d(const float* in, float* out, int64_t ny, int64_t nx,
                 float sigma, float* tmp) {
    if (sigma <= 0.0f) {
        std::memcpy(out, in, sizeof(float) * ny * nx);
        return;
    }
    int64_t radius = static_cast<int64_t>(4.0f * sigma + 0.5f);
    std::vector<float> kern(2 * radius + 1);
    float s2 = 2.0f * sigma * sigma, sum = 0.0f;
    for (int64_t i = -radius; i <= radius; ++i) {
        kern[i + radius] = std::exp(-(float)(i * i) / s2);
        sum += kern[i + radius];
    }
    for (auto& k : kern) k /= sum;
    auto reflect = [](int64_t i, int64_t n) {
        // scipy 'reflect' mode: (d c b a | a b c d | d c b a)
        while (i < 0 || i >= n) {
            if (i < 0) i = -i - 1;
            if (i >= n) i = 2 * n - i - 1;
        }
        return i;
    };
    for (int64_t y = 0; y < ny; ++y)
        for (int64_t x = 0; x < nx; ++x) {
            float acc = 0.0f;
            for (int64_t k = -radius; k <= radius; ++k)
                acc += kern[k + radius] * in[y * nx + reflect(x + k, nx)];
            tmp[y * nx + x] = acc;
        }
    for (int64_t y = 0; y < ny; ++y)
        for (int64_t x = 0; x < nx; ++x) {
            float acc = 0.0f;
            for (int64_t k = -radius; k <= radius; ++k)
                acc += kern[k + radius] * tmp[reflect(y + k, ny) * nx + x];
            out[y * nx + x] = acc;
        }
}

struct FloodEntry {
    float h;
    uint64_t order;
    int64_t idx;
    bool operator>(const FloodEntry& o) const {
        return h != o.h ? h > o.h : order > o.order;
    }
};

// seeded priority-flood of one slice, 4-connectivity (vigra watershedsNew
// moral equivalent: lowest height first, FIFO within plateaus)
void flood_2d(const float* hmap, const uint8_t* mask, int32_t* labels,
              int64_t ny, int64_t nx) {
    std::priority_queue<FloodEntry, std::vector<FloodEntry>,
                        std::greater<FloodEntry>> heap;
    uint64_t order = 0;
    std::vector<uint8_t> visited(ny * nx, 0);
    for (int64_t i = 0; i < ny * nx; ++i)
        if (labels[i] > 0) {
            visited[i] = 1;
            heap.push({hmap[i], order++, i});
        }
    const int64_t dy[4] = {-1, 1, 0, 0}, dx[4] = {0, 0, -1, 1};
    while (!heap.empty()) {
        FloodEntry e = heap.top();
        heap.pop();
        int64_t y = e.idx / nx, x = e.idx % nx;
        int32_t lab = labels[e.idx];
        for (int64_t d = 0; d < 4; ++d) {
            int64_t yy = y + dy[d], xx = x + dx[d];
            if (yy < 0 || yy >= ny || xx < 0 || xx >= nx) continue;
            int64_t j = yy * nx + xx;
            if (visited[j] || !mask[j]) continue;
            visited[j] = 1;
            labels[j] = lab;
            heap.push({hmap[j], order++, j});
        }
    }
}

}  // namespace

extern "C" {

// Full per-block DT-watershed, single core, per-slice (2d) mode — the
// benchmark baseline for the fused TPU program.  input: (nz, ny, nx) f32,
// labels out: int32 (globally unique across slices).  Returns n_seeds.
int64_t dt_watershed_cpu(const float* input, int64_t nz, int64_t ny,
                         int64_t nx, float threshold, float sigma_seeds,
                         float sigma_weights, float alpha, int64_t size_filter,
                         int32_t* labels) {
    const int64_t sz = ny * nx;
    std::vector<uint8_t> fg(sz);
    std::vector<float> dist(sz), smooth(sz), hmap(sz), tmp(sz);
    std::vector<float> col(ny), cold(ny), z(ny + 1);
    std::vector<int64_t> v(ny);
    int32_t next_label = 1;
    std::vector<int64_t> stack;

    for (int64_t zi = 0; zi < nz; ++zi) {
        const float* x = input + zi * sz;
        int32_t* lab = labels + zi * sz;
        for (int64_t i = 0; i < sz; ++i) fg[i] = x[i] < threshold;
        edt_2d(fg.data(), dist.data(), ny, nx, tmp.data(), col.data(),
               cold.data(), v.data(), z.data());
        float dmax = 0.0f;
        for (int64_t i = 0; i < sz; ++i) {
            dist[i] = std::sqrt(dist[i]);
            dmax = std::max(dmax, dist[i]);
        }
        gaussian_2d(dist.data(), smooth.data(), ny, nx, sigma_seeds,
                    tmp.data());
        // seeds: 3x3 local maxima of smoothed dt (dt>0), 8-conn CC label
        std::memset(lab, 0, sizeof(int32_t) * sz);
        std::vector<uint8_t> maxima(sz, 0);
        for (int64_t y = 0; y < ny; ++y)
            for (int64_t xx = 0; xx < nx; ++xx) {
                int64_t i = y * nx + xx;
                if (dist[i] <= 0.0f) continue;
                float c = smooth[i];
                bool is_max = true;
                for (int64_t ddy = -1; ddy <= 1 && is_max; ++ddy)
                    for (int64_t ddx = -1; ddx <= 1; ++ddx) {
                        int64_t yy = y + ddy, xc = xx + ddx;
                        if (yy < 0 || yy >= ny || xc < 0 || xc >= nx) continue;
                        if (smooth[yy * nx + xc] > c) {
                            is_max = false;
                            break;
                        }
                    }
                maxima[i] = is_max;
            }
        for (int64_t i = 0; i < sz; ++i) {
            if (!maxima[i] || lab[i] != 0) continue;
            int32_t id = next_label++;
            stack.clear();
            stack.push_back(i);
            lab[i] = id;
            while (!stack.empty()) {
                int64_t j = stack.back();
                stack.pop_back();
                int64_t y = j / nx, xx = j % nx;
                for (int64_t ddy = -1; ddy <= 1; ++ddy)
                    for (int64_t ddx = -1; ddx <= 1; ++ddx) {
                        int64_t yy = y + ddy, xc = xx + ddx;
                        if (yy < 0 || yy >= ny || xc < 0 || xc >= nx) continue;
                        int64_t k = yy * nx + xc;
                        if (maxima[k] && lab[k] == 0) {
                            lab[k] = id;
                            stack.push_back(k);
                        }
                    }
            }
        }
        // height map alpha*x + (1-alpha)*(1 - dt/dmax), smoothed
        float inv = dmax > 1e-6f ? 1.0f / dmax : 0.0f;
        for (int64_t i = 0; i < sz; ++i)
            tmp[i] = alpha * x[i] + (1.0f - alpha) * (1.0f - dist[i] * inv);
        gaussian_2d(tmp.data(), hmap.data(), ny, nx, sigma_weights,
                    smooth.data());
        flood_2d(hmap.data(), fg.data(), lab, ny, nx);
    }
    int64_t n_seeds = next_label - 1;

    if (size_filter > 0) {
        std::vector<int64_t> counts(next_label, 0);
        const int64_t total = nz * sz;
        for (int64_t i = 0; i < total; ++i) ++counts[labels[i]];
        std::vector<uint8_t> drop(next_label, 0);
        for (int64_t l = 1; l < next_label; ++l)
            drop[l] = counts[l] < size_filter;
        for (int64_t zi = 0; zi < nz; ++zi) {
            const float* x = input + zi * sz;
            int32_t* lab = labels + zi * sz;
            bool any = false;
            for (int64_t i = 0; i < sz; ++i) {
                fg[i] = x[i] < threshold;
                if (lab[i] > 0 && drop[lab[i]]) {
                    lab[i] = 0;
                    any = true;
                }
            }
            if (!any) continue;
            // re-flood freed voxels from the surviving labels
            edt_2d(fg.data(), dist.data(), ny, nx, tmp.data(), col.data(),
                   cold.data(), v.data(), z.data());
            float dmax = 0.0f;
            for (int64_t i = 0; i < sz; ++i) {
                dist[i] = std::sqrt(dist[i]);
                dmax = std::max(dmax, dist[i]);
            }
            float inv = dmax > 1e-6f ? 1.0f / dmax : 0.0f;
            for (int64_t i = 0; i < sz; ++i)
                tmp[i] = alpha * x[i] + (1.0f - alpha) * (1.0f - dist[i] * inv);
            gaussian_2d(tmp.data(), hmap.data(), ny, nx, sigma_weights,
                        smooth.data());
            flood_2d(hmap.data(), fg.data(), lab, ny, nx);
        }
    }
    return n_seeds;
}

// Lifted multicut via lifted-GAEC (see lifted_gaec_impl).
void lifted_gaec(int64_t n_nodes, int64_t n_edges, const int64_t* uv,
                 const double* costs, int64_t n_lifted,
                 const int64_t* lifted_uv, const double* lifted_costs,
                 int64_t* labels) {
    lifted_gaec_impl(n_nodes, n_edges, uv, costs, n_lifted, lifted_uv,
                     lifted_costs, labels);
}

// GAEC multicut: contract while the best merge has positive cost.
// labels receives the root id per node (not consecutive).
void gaec_multicut(int64_t n_nodes, int64_t n_edges, const int64_t* uv,
                   const double* costs, int64_t* labels) {
    greedy_agglomeration(n_nodes, n_edges, uv, costs, nullptr,
                         /*mean_mode=*/false, 0.0, labels);
}

// Threshold agglomeration on edge weights where LOW weight = merge first and
// parallel edges combine by size-weighted mean (mala semantics: weights are
// boundary probabilities).  Merges until the cheapest remaining mean boundary
// exceeds `threshold`.  `sizes` may be null (unit sizes).
void agglomerative_clustering(int64_t n_nodes, int64_t n_edges,
                              const int64_t* uv, const double* weights,
                              const double* sizes, double threshold,
                              int64_t* labels) {
    greedy_agglomeration(n_nodes, n_edges, uv, weights, sizes,
                         /*mean_mode=*/true, -threshold, labels);
}

// Mutex watershed on a weighted graph: edges sorted by |weight| descending are
// processed Kruskal-style; attractive edges (attractive[e] != 0) merge unless a
// mutex exists, repulsive edges install mutexes between clusters.
// (affogato's graph MWS algorithm.)
void mutex_watershed(int64_t n_nodes, int64_t n_edges, const int64_t* uv,
                     const double* weights, const uint8_t* attractive,
                     int64_t* labels) {
    std::vector<int64_t> order(n_edges);
    for (int64_t i = 0; i < n_edges; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return weights[a] > weights[b];
    });

    UnionFind uf(n_nodes);
    // per-root mutex partner sets
    std::vector<std::unordered_set<int64_t>> mutexes(n_nodes);

    auto have_mutex = [&](int64_t ra, int64_t rb) {
        const auto& small = mutexes[ra].size() < mutexes[rb].size() ? mutexes[ra]
                                                                    : mutexes[rb];
        int64_t other = (&small == &mutexes[ra]) ? rb : ra;
        return small.count(other) > 0;
    };

    for (int64_t idx : order) {
        int64_t ra = uf.find(uv[2 * idx]);
        int64_t rb = uf.find(uv[2 * idx + 1]);
        if (ra == rb) continue;
        if (attractive[idx]) {
            if (have_mutex(ra, rb)) continue;
            int64_t root = uf.merge(ra, rb);
            int64_t child = (root == ra) ? rb : ra;
            // Merge the child's mutex set into the root and rewrite the
            // partners' back-references child→root.  Invariant: a root's set
            // contains only current roots, and every partner set points back
            // at the current root — so `have_mutex` stays exact.  Snapshot
            // the child's set first: erasing/inserting while iterating the
            // same hashtable is UB when a partner entry aliases it.
            std::vector<int64_t> moved(mutexes[child].begin(),
                                       mutexes[child].end());
            mutexes[child].clear();
            for (int64_t m : moved) {
                mutexes[m].erase(child);
                if (m == root) continue;  // defensive: never self-mutex
                mutexes[m].insert(root);
                mutexes[root].insert(m);
            }
        } else {
            mutexes[ra].insert(rb);
            mutexes[rb].insert(ra);
        }
    }
    for (int64_t i = 0; i < n_nodes; ++i) labels[i] = uf.find(i);
}

}  // extern "C"
