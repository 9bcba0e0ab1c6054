// The port's copy of deap_tpu/native/src/hv.cpp: the exact hypervolume
// on the host (an independent implementation of the WFG exclusive-
// hypervolume recursion with the dimension-dropping slicing step, linear-
// ithmic 2-D/3-D staircase-sweep base cases and a fused d=4 sweep).
// Exposed through a plain C ABI loaded by ctypes
// (deap_tpu_torch/native/hv_binding.py):
//   dtt_hypervolume(data, n, d, ref)
//   dtt_hv_contributions(data, n, d, ref, out)
//
// Convention: MINIMISATION relative to `ref`; points not strictly below
// the reference point in every objective contribute nothing.

#include <algorithm>
#include <cstddef>
#include <vector>

namespace {

struct Front {
    // Flat row-major [n, d] storage with index indirection to avoid
    // copying rows during sorts.
    std::vector<double> data;
    int d = 0;

    std::size_t size() const { return d ? data.size() / d : 0; }
    const double* row(std::size_t i) const { return data.data() + i * d; }
    void push(const double* p) { data.insert(data.end(), p, p + d); }
};

double hv2d(Front& f, const double* ref) {
    // Staircase sweep: ascending f0, keep the running minimum of f1.
    const std::size_t n = f.size();
    std::vector<std::size_t> idx(n);
    for (std::size_t i = 0; i < n; ++i) idx[i] = i;
    std::sort(idx.begin(), idx.end(), [&](std::size_t a, std::size_t b) {
        const double *pa = f.row(a), *pb = f.row(b);
        return pa[0] < pb[0] || (pa[0] == pb[0] && pa[1] < pb[1]);
    });
    double vol = 0.0, ymin = ref[1];
    for (std::size_t i : idx) {
        const double* p = f.row(i);
        if (p[1] < ymin) {
            vol += (ref[0] - p[0]) * (ymin - p[1]);
            ymin = p[1];
        }
    }
    return vol;
}

// Incremental 2-D staircase over (x, y) with x ascending, y strictly
// descending, tracking the dominated AREA relative to (ref_x, ref_y).
// Flat sorted vector, not a node-based container: entries a new point
// dominates form a CONTIGUOUS run erased in one range op, and the d=4
// sweep performs O(n^2) inserts, so allocation cost would dominate.
// Robust to projection-dominated and duplicate inserts (they add 0).
// The single home of this logic — both the 3-D base case and the
// fused d=4 sweep sweep z levels through it.
struct Staircase {
    std::vector<std::pair<double, double>> st;
    double area = 0.0;

    void reset() {
        st.clear();
        area = 0.0;
    }

    void insert(double x, double y, const double* ref) {
        auto it = std::lower_bound(
            st.begin(), st.end(), x,
            [](const std::pair<double, double>& e, double v) {
                return e.first < v;
            });
        if (it != st.begin() && (it - 1)->second <= y)
            return;  // projection-dominated by a strictly-left entry
        if (it != st.end() && it->first == x && it->second <= y)
            return;  // projection-dominated by an equal-x entry
        // Area gained: overlap of [x, ref_x) x [y, oldY(u)) with the
        // old staircase's min-y step function oldY, walking segments
        // rightward; entries the new point dominates are erased.
        double gain = 0.0;
        double seg_start = x;
        double prev_y = (it == st.begin()) ? ref[1] : (it - 1)->second;
        auto run = it;  // first surviving entry after the dominated run
        for (;;) {
            const double seg_end = (run == st.end()) ? ref[0]
                                                     : run->first;
            if (prev_y > y) gain += (seg_end - seg_start) * (prev_y - y);
            if (run == st.end() || run->second < y) break;
            seg_start = run->first;
            prev_y = run->second;
            ++run;
        }
        if (run != it) {  // overwrite the run's head, erase the rest
            *it = {x, y};
            st.erase(it + 1, run);
        } else {
            st.insert(it, {x, y});
        }
        area += gain;
    }
};

double hv3d(const Front& f, const double* ref) {
    // O(n log n) sweep on the 3rd objective (the performance class of
    // the reference's specialized 3-D base case, _hv.c:540-545, by a
    // different algorithm): sort ascending z and push (x, y) through
    // the incremental staircase; volume accrues as area x slab between
    // consecutive z levels. Robust to projection-dominated and
    // duplicate points, so callers may pass un-filtered limited sets.
    const std::size_t n = f.size();
    if (n == 0) return 0.0;
    static thread_local std::vector<std::size_t> idx;
    static thread_local Staircase sc;  // leaf: never two live at once
    idx.resize(n);
    for (std::size_t i = 0; i < n; ++i) idx[i] = i;
    std::sort(idx.begin(), idx.end(), [&](std::size_t a, std::size_t b) {
        return f.row(a)[2] < f.row(b)[2];
    });
    sc.reset();
    double vol = 0.0;
    double cur_z = f.row(idx[0])[2];
    for (std::size_t ii = 0; ii < n; ++ii) {
        const double* p = f.row(idx[ii]);
        vol += sc.area * (p[2] - cur_z);
        cur_z = p[2];
        sc.insert(p[0], p[1], ref);
    }
    vol += sc.area * (ref[2] - cur_z);
    return vol;
}

double inclhv(const double* p, const double* ref, int d) {
    double v = 1.0;
    for (int k = 0; k < d; ++k) v *= ref[k] - p[k];
    return v;
}

// b weakly dominates a (minimisation); `strict` excludes equality.
inline bool dominates(const double* b, const double* a, int d) {
    bool any_lt = false;
    for (int k = 0; k < d; ++k) {
        if (b[k] > a[k]) return false;
        if (b[k] < a[k]) any_lt = true;
    }
    return any_lt;
}

inline bool equal_pt(const double* b, const double* a, int d) {
    for (int k = 0; k < d; ++k)
        if (b[k] != a[k]) return false;
    return true;
}

// Non-dominated filter (keeps one copy of duplicates), O(m² d).
Front nds(const Front& f) {
    const std::size_t n = f.size();
    Front out;
    out.d = f.d;
    std::vector<bool> keep(n, true);
    for (std::size_t a = 0; a < n; ++a) {
        if (!keep[a]) continue;
        for (std::size_t b = 0; b < n; ++b) {
            if (a == b || !keep[b]) continue;
            if (dominates(f.row(b), f.row(a), f.d) ||
                (b < a && equal_pt(f.row(b), f.row(a), f.d))) {
                keep[a] = false;
                break;
            }
        }
    }
    for (std::size_t a = 0; a < n; ++a)
        if (keep[a]) out.push(f.row(a));
    return out;
}

double wfg(Front& f, const double* ref);

// Exclusive hypervolume of point i against the points after it, for
// d >= 4 (wfg's base cases absorb d <= 3). Because wfg sorts its
// front DESCENDING on the last objective, every later point has
// last coordinate <= p_i's, so each limited point max(p_i, p_j)
// shares p_i's last coordinate exactly and the union of their boxes
// is a slab: the whole term factorises into
//   (ref[d-1] - p_i[d-1]) * exclusive volume in the first d-1 dims.
// Each recursion level therefore DROPS a dimension (the WFG "slicing"
// step) instead of re-recursing at full d, bottoming out in the
// linearithmic 2-D/3-D staircase sweeps.
double exclhv(const Front& f, std::size_t i, const double* ref) {
    const int d = f.d;
    const double* pi = f.row(i);
    const std::size_t n = f.size();
    const double slab = ref[d - 1] - pi[d - 1];
    double inner = inclhv(pi, ref, d - 1);
    if (i + 1 < n) {
        Front lim;
        lim.d = d - 1;
        std::vector<double> q(d - 1);
        for (std::size_t j = i + 1; j < n; ++j) {
            const double* pj = f.row(j);
            // maxes of below-ref points stay below ref: no clipping
            for (int k = 0; k < d - 1; ++k)
                q[k] = std::max(pi[k], pj[k]);
            lim.push(q.data());
        }
        // exclhv only runs at d >= 5 (wfg's base cases take d <= 3 and
        // wfg4_sorted takes d == 4), so lim.d >= 4: always worth the
        // non-domination filter before recursing
        Front limited = nds(lim);
        inner -= wfg(limited, ref);
    }
    return slab * inner;
}

// d=4 sweep over a front already sorted DESCENDING on the 4th
// objective: each term is (slab in obj 4) x (3-D exclusive volume),
// and the 3-D limited set {max(p_i, p_j) : j > i} streams out
// already z-sorted — max(z_i, z_j) is non-decreasing along an
// ascending-3rd-objective walk — so each inner pass is pure
// staircase sweep, no sort.
//
// The outer loop runs i DESCENDING while a z-sorted
// structure-of-arrays of the points {j : j > i} grows by one
// insertion per step — and is PRUNED to its 3-D-nondominated subset.
// Pruning is volume-neutral: if q 3-D-dominates p (minimisation,
// componentwise), then max(p_i, q) <= max(p_i, p) componentwise for
// every p_i, so p's limited box is inside q's and the staircase union
// never misses it. A newly inserted point i has the LARGEST 4th
// objective among the live set, and on real fronts that correlates
// with small first-three coordinates, so insertions keep collapsing
// the live set — the inner sweep walks a short Pareto staircase, not
// all n-1-i survivors. This is where the old 1.6x constant-factor
// loss to the reference's AVL dimension-sweep at large-n d=4
// (BASELINE.md) was paid.
double wfg4_sorted(const Front& f, const double* ref) {
    const std::size_t n = f.size();
    // z-sorted arrays of the live (3-D-nondominated) points after i;
    // grown by memmove (sequential doubles — cheaper than any node
    // structure at the resulting sizes)
    std::vector<double> zx, zy, zz;
    zx.reserve(n);
    zy.reserve(n);
    zz.reserve(n);
    Staircase sc;
    double total = 0.0;
    for (std::size_t ii = n; ii-- > 0;) {
        const double* pi = f.row(ii);
        const double slab = ref[3] - pi[3];
        const double pi0 = pi[0], pi1 = pi[1], pi2 = pi[2];
        double inner = inclhv(pi, ref, 3);
        sc.reset();
        double vol3 = 0.0, cur_z = 0.0;
        bool first = true;
        const std::size_t live = zz.size();
        for (std::size_t k = 0; k < live; ++k) {
            const double z = std::max(pi2, zz[k]);
            if (first) {
                cur_z = z;
                first = false;
            }
            vol3 += sc.area * (z - cur_z);
            cur_z = z;
            sc.insert(std::max(pi0, zx[k]), std::max(pi1, zy[k]), ref);
        }
        if (!first) vol3 += sc.area * (ref[2] - cur_z);
        total += slab * (inner - vol3);
        // point i joins the live set for the remaining (smaller) i's
        // unless 3-D-dominated; any members it dominates drop out
        bool dominated = false;
        for (std::size_t k = 0; k < zz.size(); ++k) {
            if (zz[k] > pi2) break;  // z-sorted: no dominator past here
            if (zx[k] <= pi0 && zy[k] <= pi1) {
                dominated = true;
                break;
            }
        }
        if (dominated) continue;
        std::size_t w = 0;
        for (std::size_t k = 0; k < zz.size(); ++k) {
            const bool doomed =
                zz[k] >= pi2 && zx[k] >= pi0 && zy[k] >= pi1;
            if (!doomed) {
                zx[w] = zx[k];
                zy[w] = zy[k];
                zz[w] = zz[k];
                ++w;
            }
        }
        zx.resize(w);
        zy.resize(w);
        zz.resize(w);
        const std::size_t pos = std::lower_bound(zz.begin(), zz.end(),
                                                 pi2) - zz.begin();
        zz.insert(zz.begin() + pos, pi2);
        zx.insert(zx.begin() + pos, pi0);
        zy.insert(zy.begin() + pos, pi1);
    }
    return total;
}

double wfg(Front& f, const double* ref) {
    if (f.size() == 0) return 0.0;
    if (f.d == 1) {
        double m = ref[0];
        for (std::size_t i = 0; i < f.size(); ++i)
            m = std::min(m, f.row(i)[0]);
        return ref[0] - m;
    }
    if (f.d == 2) return hv2d(f, ref);
    if (f.d == 3) return hv3d(f, ref);
    // Sorting by the last objective descending shrinks limited sets
    // fastest (the classic WFG heuristic) — and makes the dimension-
    // dropping factorisation in exclhv/wfg4_sorted valid.
    const std::size_t n = f.size();
    std::vector<std::size_t> idx(n);
    for (std::size_t i = 0; i < n; ++i) idx[i] = i;
    const int d = f.d;
    std::sort(idx.begin(), idx.end(), [&](std::size_t a, std::size_t b) {
        return f.row(a)[d - 1] > f.row(b)[d - 1];
    });
    Front sorted;
    sorted.d = d;
    for (std::size_t i : idx) sorted.push(f.row(i));
    if (d == 4) return wfg4_sorted(sorted, ref);
    double total = 0.0;
    for (std::size_t i = 0; i < n; ++i) total += exclhv(sorted, i, ref);
    return total;
}

Front prepare(const double* data, int n, int d, const double* ref) {
    Front f;
    f.d = d;
    for (int i = 0; i < n; ++i) {
        const double* p = data + static_cast<std::size_t>(i) * d;
        bool below = true;
        for (int k = 0; k < d; ++k)
            if (p[k] >= ref[k]) { below = false; break; }
        if (below) f.push(p);
    }
    // the d<=3 base cases absorb dominated/duplicate points natively,
    // and the d=4 sweep's pruned live set does too (a 4-D-dominated
    // point's term telescopes to zero; WFG's exclusive-volume chain
    // is an identity for ANY set, filtered or not) — at those dims
    // the O(n^2) filter would dominate the actual computation
    // (measured: 40 of 42 ms at d=3 n=2000, 40 of 66 ms at d=4
    // n=2000 was this filter). From d=5 the recursion's limited sets
    // multiply, so pre-shrinking the front is worth the quadratic
    // pass.
    return d <= 4 ? f : nds(f);
}

}  // namespace

extern "C" {

// Exact hypervolume of `data` ([n, d] row-major, minimisation) w.r.t. ref.
double dtt_hypervolume(const double* data, int n, int d,
                            const double* ref) {
    if (n <= 0 || d <= 0) return 0.0;
    Front f = prepare(data, n, d, ref);
    return wfg(f, ref);
}

// Leave-one-out exclusive contribution of every point — the quantity
// behind the reference's least-contributor indicator
// (deap/tools/indicator.py:10-31). Computed DIRECTLY per point:
//   contrib(i) = V(box(p_i, ref)) - HV({p_j maxed with p_i : j != i})
// i.e. the inclusive box minus the part the others cover once clipped
// into it — no full-front recompute per point (the r3 implementation
// paid n whole-front WFG runs; the clipped sets here are small and
// heavily dominated, and d==3 dispatches to the linearithmic sweep).
// Points that are dominated, duplicated, or not strictly below the
// reference get exactly 0, as with leave-one-out.
void dtt_hv_contributions(const double* data, int n, int d,
                          const double* ref, double* out) {
    if (n <= 0 || d <= 0) return;
    std::vector<double> q(d);
    for (int i = 0; i < n; ++i) {
        const double* pi = data + static_cast<std::size_t>(i) * d;
        bool below = true;
        for (int k = 0; k < d; ++k)
            if (pi[k] >= ref[k]) { below = false; break; }
        if (!below) { out[i] = 0.0; continue; }
        Front lim;
        lim.d = d;
        for (int j = 0; j < n; ++j) {
            if (j == i) continue;
            const double* pj = data + static_cast<std::size_t>(j) * d;
            bool inside = true;
            for (int k = 0; k < d; ++k) {
                q[k] = std::max(pi[k], pj[k]);
                if (q[k] >= ref[k]) { inside = false; break; }
            }
            if (inside) lim.push(q.data());
        }
        double covered = 0.0;
        if (lim.size()) {
            if (d <= 4) {
                // the d<=3 staircase base cases and the d=4 pruned
                // sweep absorb dominated/duplicate rows natively (the
                // same telescoping identity as prepare()); the O(m^2)
                // filter would dominate them
                covered = wfg(lim, ref);
            } else {
                Front reduced = nds(lim);
                covered = wfg(reduced, ref);
            }
        }
        out[i] = inclhv(pi, ref, d) - covered;
    }
}

}  // extern "C"
