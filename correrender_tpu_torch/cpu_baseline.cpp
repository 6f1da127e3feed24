// The port's CPU baseline: a copy of correrender_tpu/native/cpu_baseline.cpp
// (the JAX package's CPU reference-throughput baseline), kept in the port so
// that it imports nothing of the JAX package. The arithmetic is unchanged:
// pearson_field_cpu's one-pass sums in double, the KSG's 2-D k-d tree under
// the Chebyshev metric, kCountEpsilon = 1e-6f, range_count's [v - r, v + r)
// and the digamma sums in double. One departure: pearson_throughput_cpu_t
// restores the calling thread's OpenMP thread count as it found it (the JAX
// copy sets every core afterwards), so a threaded measurement leaves the
// rest of the process's OpenMP use as it was.
//
// Built by correrender_tpu_torch/native.py::cpu_baseline with
//   g++ -O3 -march=native -std=c++17 -shared -fPIC -fopenmp
// into build/cpu_baseline/ at first use.
//
// The same one-pass Pearson math as the reference's CPU path (semantics of
// computePearson1, reference src/Calculators/Correlation.cpp:42-99), so a
// harness can measure the CPU denominator of a speed-up on its host. The
// reference's CPU path is OpenMP-parallel over voxels
// (CorrelationCalculator.cpp:878-1100 wraps the per-voxel loop in
// #pragma omp parallel), so the denominator has a single-core and an
// all-core measurement (pearson_throughput_cpu_t with threads 1 and 0)
// beside the host's core count.

#include <cmath>
#include <cstdint>
#include <chrono>
#include <thread>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Number of hardware threads the all-core denominator uses.
int cpu_core_count() {
    unsigned n = std::thread::hardware_concurrency();
    return n ? int(n) : 1;
}

// Correlate every voxel series against the reference series.
// fields: member-major layout fields[e * num_voxels + v] (the layout the
// reference's loaders produce: one slab per member).
void pearson_field_cpu(
        const float* reference, const float* fields,
        int64_t num_voxels, int es, float* out) {
    // Voxel-parallel like the reference's OpenMP path
    // (Correlation.cpp:182-268 called under #pragma omp parallel for,
    // CorrelationCalculator.cpp:878-1100). Thread count is whatever
    // the caller set via omp_set_num_threads (see *_throughput_cpu_t).
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t v = 0; v < num_voxels; ++v) {
        double sum_x = 0.0, sum_y = 0.0, sum_xy = 0.0, sum_xx = 0.0,
               sum_yy = 0.0;
        for (int e = 0; e < es; ++e) {
            double x = reference[e];
            double y = fields[int64_t(e) * num_voxels + v];
            sum_x += x;
            sum_y += y;
            sum_xy += x * y;
            sum_xx += x * x;
            sum_yy += y * y;
        }
        double n = double(es);
        out[v] = float(
            (n * sum_xy - sum_x * sum_y) /
            std::sqrt((n * sum_xx - sum_x * sum_x) *
                      (n * sum_yy - sum_y * sum_y)));
    }
}

// Returns voxels/second for the given problem shape.
double pearson_throughput_cpu(int64_t num_voxels, int es) {
    float* reference = new float[es];
    float* fields = new float[int64_t(es) * num_voxels];
    float* out = new float[num_voxels];
    // Deterministic pseudo-data (xorshift32).
    uint32_t state = 0x243F6A88u;
    auto next = [&state]() {
        state ^= state << 13;
        state ^= state >> 17;
        state ^= state << 5;
        return float(state) * (1.0f / 4294967296.0f);
    };
    for (int e = 0; e < es; ++e) reference[e] = next();
    for (int64_t i = 0; i < int64_t(es) * num_voxels; ++i) fields[i] = next();

    auto t0 = std::chrono::steady_clock::now();
    pearson_field_cpu(reference, fields, num_voxels, es, out);
    auto t1 = std::chrono::steady_clock::now();
    double seconds = std::chrono::duration<double>(t1 - t0).count();

    delete[] reference;
    delete[] fields;
    delete[] out;
    return double(num_voxels) / seconds;
}

// Thread-controlled variant: threads=1 → the single-core denominator,
// threads=0 → all hardware threads (the reference's OpenMP behavior).
double pearson_throughput_cpu_t(int64_t num_voxels, int es,
                                int threads) {
#ifdef _OPENMP
    const int before = omp_get_max_threads();
    omp_set_num_threads(threads > 0 ? threads : cpu_core_count());
#endif
    double r = pearson_throughput_cpu(num_voxels, es);
#ifdef _OPENMP
    omp_set_num_threads(before);
#endif
    return r;
}

// Sustained DDR read+write bandwidth in GB/s (STREAM-triad-style
// a[i] = b[i] + s*c[i] over buffers far beyond LLC, all cores), the
// number that caps ANY CPU implementation of a bandwidth-bound
// estimator — reported alongside the denominators so the >=50x
// headline can be normalized to other hosts.
double ddr_bandwidth_gbs(int64_t elems, int reps) {
    if (elems <= 0) elems = int64_t(64) << 20;  // 256 MB/buffer (f32)
    if (reps <= 0) reps = 3;
    float* a = new float[elems];
    float* b = new float[elems];
    float* c = new float[elems];
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < elems; ++i) {
        a[i] = 0.0f; b[i] = 1.0f; c[i] = 2.0f;
    }
    double best = 0.0;
    for (int r = 0; r < reps; ++r) {
        auto t0 = std::chrono::steady_clock::now();
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (int64_t i = 0; i < elems; ++i) {
            a[i] = b[i] + 0.5f * c[i];
        }
        auto t1 = std::chrono::steady_clock::now();
        double s = std::chrono::duration<double>(t1 - t0).count();
        // 2 reads + 1 write per element.
        double gbs = double(elems) * 3.0 * sizeof(float) / s / 1e9;
        if (gbs > best) best = gbs;
    }
    delete[] a; delete[] b; delete[] c;
    return best;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// KSG (Kraskov-Stoegbauer-Grassberger) mutual-information CPU baseline.
//
// Same algorithmic shape as the reference's CPU path (semantics of
// computeMutualInformationKraskov{,2}, reference
// src/Calculators/MutualInformation.cpp:399-509 — independent
// implementation, not a copy): a 2D k-d tree (k+1)-nearest-neighbour
// query per point under the Chebyshev metric, then per-axis
// neighbourhood counts via binary searches over the sorted marginals,
// and MI = -<psi(nx)+psi(ny)> + psi(k) + psi(N) (estimator 1 includes
// the centre; estimator 2 uses per-axis radii from the neighbour set).
// Noise injection is omitted: a caller that wants the noised estimate
// passes the noised series.

#include <algorithm>
#include <vector>

namespace {

constexpr float kCountEpsilon = 1e-6f;  // default_epsilon<float>::value

double digamma(double x) {
    // Recurrence to x >= 6, then the asymptotic series.
    double result = 0.0;
    while (x < 6.0) {
        result -= 1.0 / x;
        x += 1.0;
    }
    const double inv = 1.0 / x, inv2 = inv * inv;
    result += std::log(x) - 0.5 * inv
        - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0));
    return result;
}

struct Pt { float x, y; };

// In-place 2D k-d tree over an index array (median split by
// alternating axis); kNN query keeps a small sorted candidate list.
struct KdTree2 {
    const Pt* pts = nullptr;
    std::vector<int> idx;

    void build(const Pt* p, int n) {
        pts = p;
        idx.resize(n);
        for (int i = 0; i < n; ++i) idx[i] = i;
        build_range(0, n, 0);
    }

    void build_range(int lo, int hi, int axis) {
        if (hi - lo <= 1) return;
        int mid = (lo + hi) / 2;
        auto cmp = [&](int a, int b) {
            return axis == 0 ? pts[a].x < pts[b].x : pts[a].y < pts[b].y;
        };
        std::nth_element(idx.begin() + lo, idx.begin() + mid,
                         idx.begin() + hi, cmp);
        build_range(lo, mid, 1 - axis);
        build_range(mid + 1, hi, 1 - axis);
    }

    // k nearest (Chebyshev); dists/out must hold k entries. Returns
    // the worst kept distance.
    void knn(Pt q, int k, float* dists, int* out) const {
        count_ = 0;
        k_ = k;
        dists_ = dists;
        out_ = out;
        search(0, (int)idx.size(), 0, q);
    }

private:
    mutable int count_ = 0, k_ = 0;
    mutable float* dists_ = nullptr;
    mutable int* out_ = nullptr;

    void insert(int i, float d) const {
        int pos = count_ < k_ ? count_ : k_ - 1;
        if (count_ < k_) ++count_;
        else if (d >= dists_[k_ - 1]) return;
        while (pos > 0 && dists_[pos - 1] > d) {
            dists_[pos] = dists_[pos - 1];
            out_[pos] = out_[pos - 1];
            --pos;
        }
        dists_[pos] = d;
        out_[pos] = i;
    }

    float worst() const {
        return count_ < k_ ? 3.4e38f : dists_[k_ - 1];
    }

    void search(int lo, int hi, int axis, Pt q) const {
        if (hi <= lo) return;
        int mid = (lo + hi) / 2;
        const Pt& p = pts[idx[mid]];
        float d = std::max(std::abs(p.x - q.x), std::abs(p.y - q.y));
        insert(idx[mid], d);
        float diff = axis == 0 ? q.x - p.x : q.y - p.y;
        int near_lo = diff < 0 ? lo : mid + 1;
        int near_hi = diff < 0 ? mid : hi;
        int far_lo = diff < 0 ? mid + 1 : lo;
        int far_hi = diff < 0 ? hi : mid;
        search(near_lo, near_hi, 1 - axis, q);
        if (std::abs(diff) <= worst()) search(far_lo, far_hi, 1 - axis, q);
    }
};

// Count points of the sorted array in [v - r, v + r) via two binary
// searches (semantics of the reference's averageDigamma,
// MutualInformation.cpp:280-345).
int range_count(const std::vector<float>& sorted, float v, float r) {
    auto lo = std::lower_bound(sorted.begin(), sorted.end(), v - r);
    auto hi = std::lower_bound(sorted.begin(), sorted.end(), v + r);
    int n = int(hi - lo);
    return n < 1 ? 1 : n;
}

float ksg_mi_one(const float* xs, const float* ys, int es, int k,
                 int estimator, KdTree2& tree, std::vector<Pt>& pts,
                 std::vector<float>& sx, std::vector<float>& sy,
                 std::vector<float>& nnd, std::vector<int>& nni) {
    pts.resize(es);
    for (int e = 0; e < es; ++e) pts[e] = {xs[e], ys[e]};
    tree.build(pts.data(), es);

    sx.assign(xs, xs + es);
    sy.assign(ys, ys + es);
    std::sort(sx.begin(), sx.end());
    std::sort(sy.begin(), sy.end());

    nnd.resize(k + 1);
    nni.resize(k + 1);
    double a = 0.0, b = 0.0;
    for (int e = 0; e < es; ++e) {
        tree.knn(pts[e], k + 1, nnd.data(), nni.data());
        if (estimator == 1) {
            float r = nnd[k] - kCountEpsilon;
            a += digamma(range_count(sx, xs[e], r));
            b += digamma(range_count(sy, ys[e], r));
        } else {
            float rx = 0.0f, ry = 0.0f;
            for (int i = 0; i <= k; ++i) {
                rx = std::max(rx, std::abs(pts[nni[i]].x - pts[e].x));
                ry = std::max(ry, std::abs(pts[nni[i]].y - pts[e].y));
            }
            a += digamma(std::max(
                range_count(sx, xs[e], rx + kCountEpsilon) - 1, 1));
            b += digamma(std::max(
                range_count(sy, ys[e], ry + kCountEpsilon) - 1, 1));
        }
    }
    double c = digamma(k), d = digamma(es);
    if (estimator == 2) c -= 1.0 / k;
    double mi = -(a + b) / es + c + d;
    return mi > 0.0 ? float(mi) : 0.0f;
}

}  // namespace

extern "C" {

// KSG MI of every voxel series against the reference series.
// fields layout matches pearson_field_cpu: fields[e * num_voxels + v].
void ksg_field_cpu(
        const float* reference, const float* fields,
        int64_t num_voxels, int es, int k, int estimator, float* out) {
    // Voxel-parallel with per-thread scratch (the reference wraps its
    // KSG CPU path in the same voxel-level OpenMP parallelism).
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        KdTree2 tree;
        std::vector<Pt> pts;
        std::vector<float> sx, sy, nnd, series(es);
        std::vector<int> nni;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
        for (int64_t v = 0; v < num_voxels; ++v) {
            for (int e = 0; e < es; ++e)
                series[e] = fields[int64_t(e) * num_voxels + v];
            out[v] = ksg_mi_one(reference, series.data(), es, k,
                                estimator, tree, pts, sx, sy, nnd, nni);
        }
    }
}

// Returns voxels/second for the given problem shape (same deterministic
// xorshift data generation as pearson_throughput_cpu).
double ksg_throughput_cpu(int64_t num_voxels, int es, int k,
                          int estimator) {
    std::vector<float> reference(es);
    std::vector<float> fields(size_t(es) * num_voxels);
    std::vector<float> out(num_voxels);
    uint32_t state = 0x243F6A88u;
    auto next = [&state]() {
        state ^= state << 13;
        state ^= state >> 17;
        state ^= state << 5;
        return float(state) * (1.0f / 4294967296.0f);
    };
    for (int e = 0; e < es; ++e) reference[e] = next();
    for (size_t i = 0; i < fields.size(); ++i) fields[i] = next();

    auto t0 = std::chrono::steady_clock::now();
    ksg_field_cpu(reference.data(), fields.data(), num_voxels, es, k,
                  estimator, out.data());
    auto t1 = std::chrono::steady_clock::now();
    double seconds = std::chrono::duration<double>(t1 - t0).count();
    return double(num_voxels) / seconds;
}

}  // extern "C"
