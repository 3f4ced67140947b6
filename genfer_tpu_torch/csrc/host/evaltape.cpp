// Native GF-DAG evaluator for the NumpyF64Backend interpreter path.
//
// The generic inference engine evaluates a generating-function DAG on a
// substitution lattice: observation-chain models request each node at
// O(n) distinct input points, so a 218-observe model performs ~80k node
// evaluations per extraction pass.  The per-evaluation tensor work is
// small (a few hundred KB), so the Python TensorPoly dispatch dominated
// end-to-end time (~85% measured on the mixture benchmark).  This
// extension runs the whole evaluation natively: the DAG is flattened to
// a node table (genfer_tpu_torch/gf/nativeeval.py), and eval() mirrors
// GenFun.eval_with / GenFun._eval / TaylorPoly (gf/ir.py,
// taylor/tensorpoly.py) op for op — same degree-demand targets, same
// fast-path *selection* (metadata-driven, value checks at the same
// program points), same truncation calculus — over plain C++ f64
// tensors.  Numeric kernels match the numpy backend's algorithms
// (reference parity chain: this file mirrors the Python engine, which
// mirrors fzaiser/genfer src/generating_function.rs:179-222,548-765 and
// src/multivariate_taylor.rs).
//
// Anything outside the mirrored surface (dynamic DAG rewrites of
// ShiftTaylorAtZero at nonzero inputs, >=2-effective-axis div/exp/log
// Newton paths, non-F64 scalars) throws Unsupported: the Python caller
// falls back to the reference-faithful interpreter.
//
// Memory: results are memoized per (node, inputs, demand) like the
// Python _EvalCache, but evicted by a global byte-budget LRU instead of
// static-parent counting (eviction only ever costs a recompute; the
// Python policy retained nearly the whole lattice, peaking at 6.6 GB on
// mixture).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <pthread.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <list>
#include <memory>
#include <string>
#include <tuple>
#include <unordered_map>
#include <vector>

namespace {

using i64 = int64_t;
constexpr i64 INF = INT64_MAX;  // INF_DEGREE sentinel

struct Unsupported {
    const char* why;
};

// ---------------------------------------------------------------------
// Poly: mirrors TaylorPoly (coeffs tensor + degrees_p1 + metadata)
// ---------------------------------------------------------------------

// flat f64 buffer with optionally-skipped zero-initialization (numpy
// allocates uninitialized and writes every element; mirroring that
// halves memory traffic on full-overwrite results)
//
// Allocation policy note (measured on the deployment microVM kernel):
// a FIRST touch of a fresh page costs ~25-29 us there (userfault-backed
// guest memory; 0.13 GB/s fresh vs 52 GB/s warm re-touch), so the
// evaluator's wall time tracks its peak unique footprint, not its alloc
// churn — glibc's warm reuse of freed chunks is free, and an exact-size
// freelist pool measured NEUTRAL wall-time-wise while inflating RSS 34%
// (it defeats malloc's cross-size coalescing).  Plain new[]/delete[] is
// therefore the right backend; the lever that matters is the memo
// budget below (4 GB retained = 1.4e6 faults = 36 s sys on the mixture
// golden; 256 MB = 0.4 s sys, recompute cost in the noise).
struct RawBuf {
    std::unique_ptr<double[]> p;
    size_t n;
    RawBuf(size_t n_, bool zero)
        : p(zero ? new double[n_]() : new double[n_]), n(n_) {}
    double* data() { return p.get(); }
    const double* data() const { return p.get(); }
    size_t size() const { return n; }
    double* begin() { return p.get(); }
    double* end() { return p.get() + n; }
    const double* begin() const { return p.get(); }
    const double* end() const { return p.get() + n; }
    double& operator[](size_t i) { return p[i]; }
    double operator[](size_t i) const { return p[i]; }
};

using BufPtr = std::shared_ptr<RawBuf>;

// profiling counters (enabled via GENFER_NATIVE_EVAL_STATS=1; printed to
// stderr at the end of each eval call)
struct EvalStats {
    long long alloc_bytes = 0;
    long long allocs = 0;
    long long evals = 0;
    long long kind_ns[20] = {0};
    long long kind_excl_ns[20] = {0};  // self time: children subtracted
    long long kind_n[20] = {0};
    long long fused_ok = 0, fused_fail = 0;
    long long subst_at1 = 0, subst_diag = 0, subst_pascal = 0,
              subst_horner = 0, subst_generic = 0, subst_zero = 0;
};
thread_local EvalStats* g_stats = nullptr;
// ns spent in child eval_node calls of the currently-running node
// (exclusive-time attribution; see eval_node's stats path)
thread_local long long g_child_ns = 0;
// when > 0: a dense conv whose multiply-add count reaches this bails
// out with Unsupported, so the HybridBackend caller re-runs through
// its Python path and offloads the big products to the accelerator
// (host-side ops below the threshold are identical either way)
thread_local double g_max_conv_flops = 0.0;

BufPtr make_buf(i64 n) {
    if (g_stats) {
        g_stats->alloc_bytes += n * 8;
        g_stats->allocs++;
    }
    return std::make_shared<RawBuf>((size_t)n, true);
}

// uninitialized: caller overwrites every element
BufPtr make_buf_raw(i64 n) {
    if (g_stats) {
        g_stats->alloc_bytes += n * 8;
        g_stats->allocs++;
    }
    return std::make_shared<RawBuf>((size_t)n, false);
}

BufPtr copy_buf(const BufPtr& src) {
    BufPtr out = make_buf_raw((i64)src->size());
    std::memcpy(out->data(), src->data(), src->size() * sizeof(double));
    return out;
}

struct Poly {
    std::vector<i64> shape;  // coeffs shape; shape.size() <= deg.size()
    std::vector<i64> deg;    // degrees_p1 (INF sentinel)
    BufPtr buf;
    bool has_hc = false, has_lin = false, has_c0 = false;
    double hc = 0, lin_c = 0, lin_m = 0, c0 = 0;
    int lin_v = -1;

    int nd() const { return (int)shape.size(); }
    i64 size() const {
        i64 n = 1;
        for (i64 s : shape) n *= s;
        return n;
    }
    double* data() { return buf->data(); }
    const double* data() const { return buf->data(); }
};

// mirrors TaylorPoly.__init__'s const0 defaulting
void finish_meta(Poly& p) {
    if (!p.has_c0) {
        if (p.has_hc) {
            p.c0 = p.hc;
            p.has_c0 = true;
        } else if (p.has_lin) {
            p.c0 = p.lin_c;
            p.has_c0 = true;
        }
    }
}

Poly mk(std::vector<i64> shape, std::vector<i64> deg, BufPtr buf) {
    Poly p;
    p.shape = std::move(shape);
    p.deg = std::move(deg);
    p.buf = std::move(buf);
    return p;
}

std::vector<i64> strides_of(const std::vector<i64>& shape) {
    std::vector<i64> s(shape.size());
    i64 acc = 1;
    for (int i = (int)shape.size() - 1; i >= 0; i--) {
        s[i] = acc;
        acc *= shape[i];
    }
    return s;
}

i64 numel(const std::vector<i64>& shape) {
    i64 n = 1;
    for (i64 s : shape) n *= s;
    return n;
}

i64 as_int(i64 d) {
    if (d == INF) throw Unsupported{"finite truncation degree required"};
    return d;
}

// mirrors TaylorPoly._materialize_const (concrete backend: always reads)
double materialize_const(Poly& p) {
    if (p.has_hc) return p.hc;
    p.hc = p.data()[0];
    p.has_hc = true;
    return p.hc;
}

bool is_constant(const Poly& p) { return p.size() == 1; }

bool is_zero(Poly& p) {
    if (!is_constant(p)) return false;
    return materialize_const(p) == 0.0;
}

bool is_one(Poly& p) {
    if (!is_constant(p)) return false;
    return materialize_const(p) == 1.0;
}

Poly from_scalar(double x) {
    Poly p = mk({}, {}, make_buf(1));
    p.data()[0] = x;
    p.has_hc = true;
    p.hc = x;
    finish_meta(p);
    return p;
}

Poly zero_with(const std::vector<i64>& degrees) {
    Poly p = mk(std::vector<i64>(degrees.size(), 1), degrees,
                make_buf(degrees.empty() ? 1 : numel(std::vector<i64>(degrees.size(), 1))));
    p.has_hc = true;
    p.hc = 0.0;
    finish_meta(p);
    return p;
}

Poly one_poly() { return from_scalar(1.0); }

// generic element copy of a box [starts, starts+counts) from src into a
// fresh contiguous buffer
Poly slice_axis(const Poly& p, int axis, i64 start, i64 stop) {
    std::vector<i64> ns = p.shape;
    ns[axis] = stop - start;
    Poly out = mk(ns, p.deg, make_buf_raw(numel(ns)));
    if (numel(ns) == 0) return out;
    const auto sstr = strides_of(p.shape);
    const auto dstr = strides_of(ns);
    const int nd = p.nd();
    // iterate output elements; last axis contiguous runs
    std::vector<i64> idx(nd, 0);
    const i64 total = numel(ns);
    const i64 run = nd > 0 ? ns[nd - 1] : 1;
    const double* sp = p.data();
    double* dp = out.data();
    for (i64 base = 0; base < total; base += run) {
        i64 soff = 0;
        for (int d = 0; d + 1 < nd; d++) soff += (idx[d] + (d == axis ? start : 0)) * sstr[d];
        if (nd - 1 == axis)
            soff += start * sstr[nd - 1];
        std::memcpy(dp + base, sp + soff, (size_t)run * sizeof(double));
        for (int d = nd - 2; d >= 0; d--) {
            if (++idx[d] < ns[d]) break;
            idx[d] = 0;
        }
    }
    return out;
}

// copy the origin box [0, extents) of p into a fresh contiguous buffer
// (all axes in one pass; the per-axis slice loop would copy once per
// truncated axis)
Poly slice_box(const Poly& p, const std::vector<i64>& extents) {
    Poly out = mk(extents, p.deg, make_buf_raw(numel(extents)));
    const i64 total = numel(extents);
    if (total == 0) return out;
    const int nd = (int)extents.size();
    if (nd == 0) {
        out.data()[0] = p.data()[0];
        return out;
    }
    const auto sstr = strides_of(p.shape);
    std::vector<i64> idx(nd, 0);
    const i64 run = extents[nd - 1];
    const double* sp = p.data();
    double* dp = out.data();
    for (i64 base = 0; base < total; base += run) {
        i64 soff = 0;
        for (int d = 0; d + 1 < nd; d++) soff += idx[d] * sstr[d];
        std::memcpy(dp + base, sp + soff, (size_t)run * sizeof(double));
        for (int d = nd - 2; d >= 0; d--) {
            if (++idx[d] < extents[d]) break;
            idx[d] = 0;
        }
    }
    return out;
}

// numpy-like zero-pad at the high end of each axis
BufPtr pad_to_buf(const double* src, const std::vector<i64>& sshape,
                  const std::vector<i64>& tshape) {
    BufPtr out = make_buf(numel(tshape));
    if (numel(sshape) == 0) return out;
    const auto sstr = strides_of(sshape);
    const auto dstr = strides_of(tshape);
    const int nd = (int)sshape.size();
    if (nd == 0) {
        (*out)[0] = src[0];
        return out;
    }
    std::vector<i64> idx(nd, 0);
    const i64 total = numel(sshape);
    const i64 run = sshape[nd - 1];
    double* dp = out->data();
    for (i64 base = 0; base < total; base += run) {
        i64 doff = 0, soff = 0;
        for (int d = 0; d + 1 < nd; d++) {
            doff += idx[d] * dstr[d];
            soff += idx[d] * sstr[d];
        }
        std::memcpy(dp + doff, src + soff, (size_t)run * sizeof(double));
        for (int d = nd - 2; d >= 0; d--) {
            if (++idx[d] < sshape[d]) break;
            idx[d] = 0;
        }
    }
    return out;
}

// reshape (append trailing 1-axes) is metadata-only: same buffer
// ---------------------------------------------------------------------
// Demand (mirrors gf/ir.py Demand)
// ---------------------------------------------------------------------

struct Demand {
    std::vector<i64> axes;
    i64 uni = 1;

    Demand() = default;
    Demand(std::vector<i64> a, i64 u) : axes(std::move(a)), uni(u) {}

    i64 axis(int v) const { return v < (int)axes.size() ? axes[v] : 1; }
    i64 maxv() const {
        i64 m = 1;
        for (i64 a : axes) m = std::max(m, a);
        return axes.empty() ? 1 : m;
    }
    bool operator==(const Demand& o) const { return axes == o.axes && uni == o.uni; }

    Demand bump(int v, i64 o) const {
        if (o == 0) return *this;
        std::vector<i64> na = axes;
        if (v < (int)na.size()) {
            if (na[v] != INF) na[v] += o;
        } else {
            while ((int)na.size() < v) na.push_back(1);
            na.push_back(1 + o);
        }
        return Demand(na, uni == INF ? INF : uni + o);
    }

    Demand with_axis(int v, i64 value) const {
        std::vector<i64> na = axes;
        if (v < (int)na.size()) {
            if (na[v] == value) return *this;
            na[v] = value;
        } else {
            while ((int)na.size() < v) na.push_back(1);
            na.push_back(value);
        }
        return Demand(na, uni);
    }

    i64 span(int n_axes) const {
        i64 t = 1;
        for (int i = 0; i < n_axes; i++) {
            i64 x = axis(i);
            if (x == INF) return INF;
            t += x - 1;
        }
        return t;
    }

    i64 comp_depth(int n_axes) const { return std::min(uni, span(n_axes)); }

    Demand join(const Demand& o) const {
        if (*this == o) return *this;
        int n = std::max((int)axes.size(), (int)o.axes.size());
        std::vector<i64> na(n);
        for (int i = 0; i < n; i++) na[i] = std::max(axis(i), o.axis(i));
        return Demand(na, std::max(uni, o.uni));
    }

    bool covers(const Demand& o) const {
        if (uni < o.uni) return false;
        int n = std::max((int)axes.size(), (int)o.axes.size());
        for (int i = 0; i < n; i++)
            if (axis(i) < o.axis(i)) return false;
        return true;
    }
};

// ---------------------------------------------------------------------
// TaylorPoly operations (mirror taylor/tensorpoly.py)
// ---------------------------------------------------------------------

// mirrors _truncate_degrees_p1
Poly trunc_degrees(const Poly& p, const std::vector<i64>& target) {
    std::vector<i64> degrees(p.deg.size());
    for (size_t i = 0; i < p.deg.size(); i++)
        degrees[i] = std::min(p.deg[i], i < target.size() ? target[i] : INF);
    bool changed = false;
    std::vector<i64> extents = p.shape;
    for (int v = 0; v < p.nd(); v++) {
        i64 ndv = v < (int)target.size() ? target[v] : INF;
        if (ndv != INF && extents[v] > ndv) {
            extents[v] = as_int(ndv);
            changed = true;
        }
    }
    if (!changed && degrees == p.deg) return p;
    Poly out = changed ? slice_box(p, extents) : p;
    out.deg = degrees;
    out.has_hc = p.has_hc;
    out.hc = p.hc;
    out.has_lin = changed ? false : p.has_lin;  // slice may drop the slope
    out.lin_c = p.lin_c;
    out.lin_m = p.lin_m;
    out.lin_v = p.lin_v;
    out.has_c0 = p.has_c0;
    out.c0 = p.c0;
    return out;
}

Poly trunc_demand(const Poly& p, const Demand& d) {
    std::vector<i64> degs(p.deg.size());
    for (size_t i = 0; i < p.deg.size(); i++) degs[i] = d.axis((int)i);
    return trunc_degrees(p, degs);
}

std::vector<i64> min_degrees(const Poly& a, const Poly& b) {
    size_t n = std::max(a.deg.size(), b.deg.size());
    std::vector<i64> out(n, INF);
    for (size_t v = 0; v < n; v++) {
        if (v < a.deg.size()) out[v] = std::min(out[v], a.deg[v]);
        if (v < b.deg.size()) out[v] = std::min(out[v], b.deg[v]);
    }
    return out;
}

std::vector<i64> max_shape_of(const Poly& a, const Poly& b) {
    size_t n = std::max(a.shape.size(), b.shape.size());
    std::vector<i64> shape(n, 1);
    for (size_t v = 0; v < n; v++) {
        if (v < a.shape.size()) shape[v] = std::max(shape[v], a.shape[v]);
        if (v < b.shape.size()) shape[v] = std::max(shape[v], b.shape[v]);
        if (v < a.deg.size()) shape[v] = std::min(shape[v], a.deg[v]);
        if (v < b.deg.size()) shape[v] = std::min(shape[v], b.deg[v]);
        shape[v] = as_int(shape[v]);
    }
    return shape;
}

std::vector<i64> sum_shape_of(const Poly& a, const Poly& b) {
    size_t n = std::max(a.shape.size(), b.shape.size());
    std::vector<i64> shape(n, 0);
    for (size_t v = 0; v < n; v++) {
        if (v < a.shape.size()) shape[v] += a.shape[v] - 1;
        if (v < b.shape.size()) shape[v] += b.shape[v] - 1;
        shape[v] += 1;
        if (v < a.deg.size()) shape[v] = std::min(shape[v], a.deg[v]);
        if (v < b.deg.size()) shape[v] = std::min(shape[v], b.deg[v]);
        shape[v] = as_int(shape[v]);
    }
    return shape;
}

// mirrors _broadcast_with: align degree lengths and ndims (appending the
// OTHER's trailing degrees / trailing 1-axes); metadata copied
void broadcast_pair(Poly& a, Poly& b) {
    if (a.deg.size() < b.deg.size()) {
        for (size_t i = a.deg.size(); i < b.deg.size(); i++) a.deg.push_back(b.deg[i]);
    } else if (b.deg.size() < a.deg.size()) {
        for (size_t i = b.deg.size(); i < a.deg.size(); i++) b.deg.push_back(a.deg[i]);
    }
    size_t nd = std::max(a.shape.size(), b.shape.size());
    while (a.shape.size() < nd) a.shape.push_back(1);
    while (b.shape.size() < nd) b.shape.push_back(1);
}

Poly with_degrees(const Poly& p, std::vector<i64> degrees) {
    Poly out = p;
    out.deg = std::move(degrees);
    return out;
}

// arr with val added to the first element only (mirrors _add_at_zero)
Poly add_at_zero_poly(const Poly& base, double val, bool subtract_from,
                      bool negate_all) {
    // subtract_from: first element = first - val (else first + val);
    // negate_all: negate the whole result afterwards (the a-is-scalar
    // branch of __sub__)
    Poly out = base;
    out.buf = copy_buf(base.buf);
    double& f = *out.buf->data();
    f = subtract_from ? f - val : f + val;
    if (negate_all)
        for (double& x : *out.buf) x = -x;
    return out;
}

struct LinMeta {
    bool has = false;
    double c = 0, m = 0;
    int v = -1;
};

// _lin_add / _lin_sub metadata propagation
LinMeta lin_add_meta(const Poly& a, const Poly& b, bool sub) {
    LinMeta r;
    bool a_const = a.has_hc && is_constant(a);
    bool b_const = b.has_hc && is_constant(b);
    if (a.has_lin && b_const) {
        r.has = true;
        r.c = sub ? a.lin_c - b.hc : a.lin_c + b.hc;
        r.m = a.lin_m;
        r.v = a.lin_v;
        return r;
    }
    if (b.has_lin && a_const) {
        r.has = true;
        if (sub) {
            r.c = a.hc - b.lin_c;
            r.m = -b.lin_m;
        } else {
            r.c = b.lin_c + a.hc;
            r.m = b.lin_m;
        }
        r.v = b.lin_v;
        return r;
    }
    if (a.has_lin && b.has_lin && a.lin_v == b.lin_v) {
        r.has = true;
        r.c = sub ? a.lin_c - b.lin_c : a.lin_c + b.lin_c;
        r.m = sub ? a.lin_m - b.lin_m : a.lin_m + b.lin_m;
        r.v = a.lin_v;
        return r;
    }
    return r;
}

Poly add_poly(const Poly& sa, const Poly& sb, bool sub) {
    std::vector<i64> result_degrees = min_degrees(sa, sb);
    Poly a2 = sa, b2 = sb;
    broadcast_pair(a2, b2);
    a2 = trunc_degrees(a2, result_degrees);
    b2 = trunc_degrees(b2, result_degrees);
    bool has_hc = a2.has_hc && b2.has_hc;
    double hc = sub ? a2.hc - b2.hc : a2.hc + b2.hc;
    LinMeta lin = lin_add_meta(a2, b2, sub);
    bool has_c0 = a2.has_c0 && b2.has_c0;
    double c0 = sub ? a2.c0 - b2.c0 : a2.c0 + b2.c0;
    Poly out;
    if (b2.size() == 1) {
        out = add_at_zero_poly(a2, b2.data()[0], sub, false);
    } else if (a2.size() == 1) {
        // add: b2 + a-const at zero; sub: -(b2 - a-const at zero)
        out = add_at_zero_poly(b2, a2.data()[0], sub, sub);
    } else {
        std::vector<i64> shape = max_shape_of(a2, b2);
        // single odometer pass: out = pad(a) +/- pad(b), no intermediate
        // padded copies (numpy's pad_to is a no-op when shapes match)
        i64 n = numel(shape);
        BufPtr po = make_buf_raw(n);
        const int nd = (int)shape.size();
        const auto stro = strides_of(shape);
        const auto stra = strides_of(a2.shape);
        const auto strb = strides_of(b2.shape);
        double* dp = po->data();
        const double* ap = a2.data();
        const double* bp = b2.data();
        if (nd == 0) {
            dp[0] = sub ? ap[0] - bp[0] : ap[0] + bp[0];
        } else {
            std::vector<i64> idx(nd, 0);
            const i64 run = shape[nd - 1];
            const i64 a_run = a2.shape[nd - 1];
            const i64 b_run = b2.shape[nd - 1];
            for (i64 base = 0; base < n; base += run) {
                bool in_a = true, in_b = true;
                i64 aoff = 0, boff = 0;
                for (int d = 0; d + 1 < nd; d++) {
                    if (idx[d] < a2.shape[d]) aoff += idx[d] * stra[d];
                    else in_a = false;
                    if (idx[d] < b2.shape[d]) boff += idx[d] * strb[d];
                    else in_b = false;
                }
                for (i64 j = 0; j < run; j++) {
                    double av = (in_a && j < a_run) ? ap[aoff + j] : 0.0;
                    double bv = (in_b && j < b_run) ? bp[boff + j] : 0.0;
                    dp[base + j] = sub ? av - bv : av + bv;
                }
                for (int d = nd - 2; d >= 0; d--) {
                    if (++idx[d] < shape[d]) break;
                    idx[d] = 0;
                }
            }
        }
        out = mk(shape, result_degrees, po);
    }
    out.deg = result_degrees;
    out.has_hc = has_hc;
    out.hc = hc;
    out.has_lin = lin.has;
    out.lin_c = lin.c;
    out.lin_m = lin.m;
    out.lin_v = lin.v;
    out.has_c0 = has_c0;
    out.c0 = c0;
    if (!has_c0) {
        out.has_c0 = false;
        finish_meta(out);
    }
    return out;
}

Poly neg_poly(const Poly& p) {
    Poly out = p;
    out.buf = make_buf_raw((i64)p.buf->size());
    const double* sp = p.data();
    double* dp = out.buf->data();
    for (size_t i = 0; i < p.buf->size(); i++) dp[i] = -sp[i];
    out.has_hc = p.has_hc;
    out.hc = -p.hc;
    out.has_lin = p.has_lin;
    out.lin_c = -p.lin_c;
    out.lin_m = -p.lin_m;
    out.lin_v = p.lin_v;
    out.has_c0 = p.has_c0;
    out.c0 = -p.c0;
    return out;
}

// scale every element by host scalar m (x * m order; IEEE mul commutes)
Poly scale_poly_raw(const Poly& p, double m, const std::vector<i64>& degrees) {
    Poly out = mk(p.shape, degrees, make_buf_raw((i64)p.buf->size()));
    const double* sp = p.data();
    double* dp = out.buf->data();
    for (size_t i = 0; i < p.buf->size(); i++) dp[i] = sp[i] * m;
    return out;
}

// zeros(shape) with arr embedded at `offset` along `axis`
Poly embed_poly(const Poly& src, const std::vector<i64>& shape, int axis,
                i64 offset, const std::vector<i64>& degrees) {
    Poly out = mk(shape, degrees, make_buf(numel(shape)));
    if (src.size() == 0) return out;
    const int nd = (int)shape.size();
    const auto sstr = strides_of(src.shape);
    const auto dstr = strides_of(shape);
    std::vector<i64> idx(nd, 0);
    const i64 total = numel(src.shape);
    const i64 run = nd > 0 ? src.shape[nd - 1] : 1;
    const double* sp = src.data();
    double* dp = out.data();
    for (i64 base = 0; base < total; base += run) {
        i64 doff = 0, soff = 0;
        for (int d = 0; d + 1 < nd; d++) {
            doff += (idx[d] + (d == axis ? offset : 0)) * dstr[d];
            soff += idx[d] * sstr[d];
        }
        if (axis == nd - 1) doff += offset * dstr[nd - 1];
        std::memcpy(dp + doff, sp + soff, (size_t)run * sizeof(double));
        for (int d = nd - 2; d >= 0; d--) {
            if (++idx[d] < src.shape[d]) break;
            idx[d] = 0;
        }
    }
    return out;
}

// --- conv kernels (same algorithms as _seriesops.conv_trunc) ----------

void conv_1d(const double* a, i64 la, const double* b, i64 lb, double* c,
             i64 lc) {
    for (i64 k = 0; k < lc; k++) {
        i64 lo = k - (lb - 1) > 0 ? k - (lb - 1) : 0;
        i64 hi = k < la - 1 ? k : la - 1;
        double acc = 0.0;
        for (i64 j = lo; j <= hi; j++) acc += a[j] * b[k - j];
        c[k] = acc;
    }
}

void scatter_rec(const double* big, const std::vector<i64>& strb, double* c,
                 const std::vector<i64>& strc, const std::vector<i64>& bounds,
                 double v, size_t d, i64 boff, i64 coff, size_t nd) {
    if (d == nd - 1) {
        const i64 run = bounds[d];
        const double* bp = big + boff;
        double* cp = c + coff;
        for (i64 j = 0; j < run; j++) cp[j] += v * bp[j];
        return;
    }
    for (i64 j = 0; j < bounds[d]; j++)
        scatter_rec(big, strb, c, strc, bounds, v, d + 1, boff + j * strb[d],
                    coff + j * strc[d], nd);
}

void conv_nd(const double* a, const std::vector<i64>& sa, const double* b,
             const std::vector<i64>& sb, double* c, const std::vector<i64>& sc) {
    const size_t nd = sc.size();
    const double* small_p = a;
    const double* big_p = b;
    const std::vector<i64>* ssmall = &sa;
    const std::vector<i64>* sbig = &sb;
    if (numel(sb) < numel(sa)) {
        small_p = b;
        big_p = a;
        ssmall = &sb;
        sbig = &sa;
    }
    const auto str_big = strides_of(*sbig);
    const auto str_c = strides_of(sc);
    const i64 total_c = numel(sc);
    for (i64 i = 0; i < total_c; i++) c[i] = 0.0;
    std::vector<i64> idx(nd, 0);
    std::vector<i64> bounds(nd, 0);
    const i64 total_s = numel(*ssmall);
    for (i64 flat = 0; flat < total_s; flat++) {
        const double v = small_p[flat];
        if (v != 0.0) {
            bool ok = true;
            i64 coff = 0;
            for (size_t d = 0; d < nd; d++) {
                i64 bd = sc[d] - idx[d];
                if ((*sbig)[d] < bd) bd = (*sbig)[d];
                if (bd <= 0) {
                    ok = false;
                    break;
                }
                bounds[d] = bd;
                coff += idx[d] * str_c[d];
            }
            if (ok) scatter_rec(big_p, str_big, c, str_c, bounds, v, 0, 0, coff, nd);
        }
        size_t d = nd;
        while (d > 0) {
            d--;
            if (++idx[d] < (*ssmall)[d]) break;
            idx[d] = 0;
        }
    }
}

Poly conv_trunc_poly(const Poly& a, const Poly& b,
                     const std::vector<i64>& out_shape,
                     const std::vector<i64>& degrees) {
    if (a.size() == 1 || b.size() == 1) {
        // numpy path: elementwise product then slice/pad, as one
        // odometer pass (zero pad region, v * big inside)
        const Poly& big = a.size() == 1 ? b : a;
        double v = a.size() == 1 ? a.data()[0] : b.data()[0];
        Poly out = mk(out_shape, degrees, make_buf_raw(numel(out_shape)));
        const int nd = (int)out_shape.size();
        if (nd == 0) {
            out.data()[0] = big.data()[0] * v;
            return out;
        }
        const auto strb = strides_of(big.shape);
        std::vector<i64> idx(nd, 0);
        const i64 n = numel(out_shape);
        const i64 run = out_shape[nd - 1];
        const i64 b_run = std::min(big.shape[nd - 1], run);
        double* dp = out.data();
        const double* bp = big.data();
        for (i64 base = 0; base < n; base += run) {
            bool in_b = true;
            i64 boff = 0;
            for (int d = 0; d + 1 < nd; d++) {
                if (idx[d] < big.shape[d]) boff += idx[d] * strb[d];
                else in_b = false;
            }
            i64 j = 0;
            if (in_b)
                for (; j < b_run; j++) dp[base + j] = bp[boff + j] * v;
            for (; j < run; j++) dp[base + j] = 0.0;
            for (int d = nd - 2; d >= 0; d--) {
                if (++idx[d] < out_shape[d]) break;
                idx[d] = 0;
            }
        }
        return out;
    }
    Poly out = mk(out_shape, degrees, make_buf_raw(numel(out_shape)));
    if (out_shape.size() == 1) {
        conv_1d(a.data(), a.shape[0], b.data(), b.shape[0], out.data(),
                out_shape[0]);
    } else if (out_shape.empty()) {
        out.data()[0] = a.data()[0] * b.data()[0];
    } else {
        // conv_nd zero-fills the output before scattering
        conv_nd(a.data(), a.shape, b.data(), b.shape, out.data(), out.shape);
    }
    return out;
}

Poly mul_poly(Poly& sa, Poly& sb);
Poly add_op(const Poly& a, const Poly& b) { return add_poly(a, b, false); }

// mirrors mul_var (multiply by m * x_v)
Poly mul_var_poly(const Poly& self, double m, int v,
                  const std::vector<i64>& shape,
                  const std::vector<i64>& degrees) {
    i64 upper = std::min(shape[v] - 1, self.shape[v]);
    Poly coeffs = slice_axis(self, v, 0, upper);
    for (double& x : *coeffs.buf) x = x * m;
    for (int ax = 0; ax < (int)coeffs.shape.size(); ax++)
        if (coeffs.shape[ax] > shape[ax])
            coeffs = slice_axis(coeffs, ax, 0, shape[ax]);
    Poly out = embed_poly(coeffs, shape, v, 1, degrees);
    out.has_c0 = true;
    out.c0 = 0.0;
    out.has_hc = false;
    out.has_lin = false;
    return out;
}

Poly mul_linear_poly(Poly& self, double c, double m, int v,
                     const std::vector<i64>& shape,
                     const std::vector<i64>& degrees) {
    if (c == 0.0) return mul_var_poly(self, m, v, shape, degrees);
    Poly mv = mul_var_poly(self, m, v, shape, degrees);
    Poly cs = from_scalar(c);
    Poly prod = mul_poly(self, cs);
    return add_op(mv, prod);
}

// mirrors __mul__
Poly mul_poly(Poly& sa, Poly& sb) {
    std::vector<i64> degrees = min_degrees(sa, sb);
    if (is_zero(sa) || is_zero(sb)) return zero_with(degrees);
    Poly a2 = sa, b2 = sb;
    broadcast_pair(a2, b2);
    std::vector<i64> shape = sum_shape_of(a2, b2);
    a2 = trunc_degrees(a2, degrees);
    b2 = trunc_degrees(b2, degrees);
    if (is_one(a2)) return with_degrees(b2, degrees);
    if (is_one(b2)) return with_degrees(a2, degrees);
    bool has_hc = a2.has_hc && b2.has_hc;
    double hc = a2.hc * b2.hc;
    bool has_c0 = a2.has_c0 && b2.has_c0;
    double c0 = a2.c0 * b2.c0;
    // constant fast paths (shape-based)
    if (is_constant(a2)) {
        double ca = a2.data()[0];
        Poly out = scale_poly_raw(b2, ca, degrees);
        // numpy order is ca * coeffs; IEEE mul is commutative bitwise
        out.has_hc = has_hc;
        out.hc = hc;
        if (b2.has_lin && a2.has_hc) {
            out.has_lin = true;
            out.lin_c = a2.hc * b2.lin_c;
            out.lin_m = a2.hc * b2.lin_m;
            out.lin_v = b2.lin_v;
        }
        out.has_c0 = has_c0;
        out.c0 = c0;
        finish_meta(out);
        return out;
    }
    if (is_constant(b2)) {
        double cb = b2.data()[0];
        Poly out = scale_poly_raw(a2, cb, degrees);
        out.has_hc = has_hc;
        out.hc = hc;
        if (a2.has_lin && b2.has_hc) {
            out.has_lin = true;
            out.lin_c = b2.hc * a2.lin_c;
            out.lin_m = b2.hc * a2.lin_m;
            out.lin_v = a2.lin_v;
        }
        out.has_c0 = has_c0;
        out.c0 = c0;
        finish_meta(out);
        return out;
    }
    // linear fast paths
    if (a2.has_lin) {
        double c = a2.lin_c, m = a2.lin_m;
        int v = a2.lin_v;
        std::vector<i64> s = b2.shape;
        s[v] = (i64)std::min(degrees[v], s[v] + 1);
        return mul_linear_poly(b2, c, m, v, s, degrees);
    }
    if (b2.has_lin) {
        double c = b2.lin_c, m = b2.lin_m;
        int v = b2.lin_v;
        std::vector<i64> s = a2.shape;
        s[v] = (i64)std::min(degrees[v], s[v] + 1);
        return mul_linear_poly(a2, c, m, v, s, degrees);
    }
    if (g_max_conv_flops > 0.0) {
        // mirrors HybridBackend._conv_flops: per-axis truncated pair
        // counts; above the offload threshold the Python path wins
        double total = 1.0;
        for (size_t i = 0; i < shape.size(); i++) {
            i64 sa = i < a2.shape.size() ? a2.shape[i] : 1;
            i64 sb = i < b2.shape.size() ? b2.shape[i] : 1;
            double pairs = 0.0;
            for (i64 k = 0; k < shape[i]; k++) {
                i64 lo = k + 1 - sb > 0 ? k + 1 - sb : 0;
                i64 hi = k + 1 < sa ? k + 1 : sa;
                if (hi > lo) pairs += (double)(hi - lo);
            }
            total *= pairs > 1.0 ? pairs : 1.0;
        }
        if (total >= g_max_conv_flops)
            throw Unsupported{"conv above the accelerator-offload threshold"};
    }
    Poly out = conv_trunc_poly(a2, b2, shape, degrees);
    out.has_c0 = has_c0;
    out.c0 = c0;
    finish_meta(out);
    return out;
}

std::vector<int> effective_axes(const std::vector<i64>& shape) {
    std::vector<int> out;
    for (size_t i = 0; i < shape.size(); i++)
        if (shape[i] != 1) out.push_back((int)i);
    return out;
}

// F64.__truediv__ semantics for host scalars
double f64_div(double a, double b) {
    if (b == 0.0) {
        if (a == 0.0 || std::isnan(a)) return NAN;
        return std::copysign(HUGE_VAL, a) * std::copysign(1.0, b);
    }
    return a / b;
}

// div_1d recurrence over lanes: out[k, r] = (x[k,r] - sum out[j,r]*y[k-j]) / y[0]
void div_1d_lanes(const double* xs, i64 lx, const double* ys, i64 ly,
                  double* out, i64 n, i64 R) {
    for (i64 k = 0; k < n; k++) {
        i64 lo = k + 1 - ly > 0 ? k + 1 - ly : 0;
        for (i64 r = 0; r < R; r++) {
            double acc = k < lx ? xs[k * R + r] : 0.0;
            for (i64 j = lo; j < k; j++) acc -= out[j * R + r] * ys[k - j];
            out[k * R + r] = acc / ys[0];
        }
    }
}

// moveaxis(arr, axis, 0) materialized into a contiguous (n, R) layout
void moveaxis_to_front(const double* src, const std::vector<i64>& shape,
                       int axis, double* dst) {
    const auto str = strides_of(shape);
    const int nd = (int)shape.size();
    i64 R = 1;
    for (int d = 0; d < nd; d++)
        if (d != axis) R *= shape[d];
    const i64 n = shape[axis];
    // dst[k, r]: r iterates the non-axis axes in their original order
    std::vector<i64> idx(nd, 0);
    for (i64 r = 0; r < R; r++) {
        i64 base = 0;
        for (int d = 0; d < nd; d++)
            if (d != axis) base += idx[d] * str[d];
        for (i64 k = 0; k < n; k++) dst[k * R + r] = src[base + k * str[axis]];
        for (int d = nd - 1; d >= 0; d--) {
            if (d == axis) continue;
            if (++idx[d] < shape[d]) break;
            idx[d] = 0;
        }
    }
}

void moveaxis_from_front(const double* src, i64 n, i64 R,
                         const std::vector<i64>& shape, int axis, double* dst) {
    const auto str = strides_of(shape);
    const int nd = (int)shape.size();
    std::vector<i64> idx(nd, 0);
    for (i64 r = 0; r < R; r++) {
        i64 base = 0;
        for (int d = 0; d < nd; d++)
            if (d != axis) base += idx[d] * str[d];
        for (i64 k = 0; k < n; k++) dst[base + k * str[axis]] = src[k * R + r];
        for (int d = nd - 1; d >= 0; d--) {
            if (d == axis) continue;
            if (++idx[d] < shape[d]) break;
            idx[d] = 0;
        }
    }
}

Poly extend_to_dim(const Poly& p, int ndim, i64 fill_degree) {
    Poly out = p;
    while ((int)out.shape.size() < ndim) out.shape.push_back(1);
    while ((int)out.deg.size() < ndim) out.deg.push_back(fill_degree);
    return out;
}

// mirrors __truediv__
Poly div_poly(Poly& sa, Poly& sb) {
    Poly a2 = sa, b2 = sb;
    broadcast_pair(a2, b2);
    std::vector<i64> degrees = min_degrees(a2, b2);
    a2 = trunc_degrees(a2, degrees);
    b2 = trunc_degrees(b2, degrees);
    if (is_one(b2)) return with_degrees(a2, degrees);
    bool has_hc = a2.has_hc && b2.has_hc;
    double hc = f64_div(a2.hc, b2.hc);
    bool has_c0 = a2.has_c0 && b2.has_c0;
    double c0 = f64_div(a2.c0, b2.c0);
    if (is_constant(b2)) {
        double cb = b2.data()[0];
        Poly out = a2;
        out.buf = make_buf_raw((i64)a2.buf->size());
        {
            const double* sp = a2.data();
            double* dp = out.buf->data();
            for (size_t i = 0; i < a2.buf->size(); i++)
                dp[i] = sp[i] / cb;  // numpy IEEE semantics
        }
        out.deg = degrees;
        out.has_hc = has_hc;
        out.hc = hc;
        out.has_lin = false;
        if (a2.has_lin && b2.has_hc) {
            out.has_lin = true;
            out.lin_c = f64_div(a2.lin_c, b2.hc);
            out.lin_m = f64_div(a2.lin_m, b2.hc);
            out.lin_v = a2.lin_v;
        }
        out.has_c0 = has_c0;
        out.c0 = c0;
        finish_meta(out);
        return out;
    }
    int n = (int)degrees.size();
    if (a2.nd() < n) a2 = extend_to_dim(a2, n, 1);
    if (b2.nd() < n) b2 = extend_to_dim(b2, n, 1);
    std::vector<i64> result_shape(n);
    for (int i = 0; i < n; i++)
        result_shape[i] = as_int(b2.shape[i] == 1 ? a2.shape[i] : degrees[i]);
    // poly_div dispatch (NumpyF64Backend.poly_div)
    auto eff = effective_axes(b2.shape);
    Poly out = mk(result_shape, degrees, make_buf(numel(result_shape)));
    if (eff.empty()) {
        BufPtr padded = pad_to_buf(a2.data(), a2.shape, result_shape);
        double yv = b2.data()[0];
        for (double& x : *padded) x = x / yv;
        out.buf = padded;
    } else if (eff.size() == 1) {
        int axis = eff[0];
        i64 nn = result_shape[axis];
        i64 R = 1;
        for (int d = 0; d < n; d++)
            if (d != axis) R *= result_shape[d];
        // xs moved to front; lanes of xs correspond to result lanes only
        // if non-axis shapes match; numpy path reshapes xs (lx, -1) --
        // requires non-axis xs shapes == result lanes. They are: result
        // non-axis dims = a2 dims where b2==1 (all, since eff axis only).
        std::vector<double> xm((size_t)(a2.shape[axis] * R));
        moveaxis_to_front(a2.data(), a2.shape, axis, xm.data());
        i64 lx = a2.shape[axis];
        std::vector<double> xpad((size_t)(nn * R), 0.0);
        std::memcpy(xpad.data(), xm.data(),
                    (size_t)std::min(lx, nn) * R * sizeof(double));
        // gather y vector
        std::vector<double> yv((size_t)b2.shape[axis]);
        {
            const auto bstr = strides_of(b2.shape);
            for (i64 k = 0; k < b2.shape[axis]; k++)
                yv[k] = b2.data()[k * bstr[axis]];
        }
        std::vector<double> sol((size_t)(nn * R), 0.0);
        div_1d_lanes(xpad.data(), nn, yv.data(), (i64)yv.size(), sol.data(), nn, R);
        moveaxis_from_front(sol.data(), nn, R, result_shape, axis, out.data());
    } else {
        throw Unsupported{"multivariate poly_div (Newton path)"};
    }
    out.has_c0 = has_c0;
    out.c0 = c0;
    finish_meta(out);
    return out;
}

// exp_1d / log_1d recurrences (mirror _seriesops kernels)
void exp_1d_vec(const double* x, i64 lx, double* out, i64 n) {
    out[0] = std::exp(x[0]);
    for (i64 k = 1; k < n; k++) {
        double acc = 0.0;
        i64 hi = lx < k + 1 ? lx : k + 1;
        for (i64 j = 1; j < hi; j++) acc += (double)j * x[j] * out[k - j];
        out[k] = acc / (double)k;
    }
}

void log_1d_vec(const double* x, i64 lx, double* out, i64 n) {
    out[0] = x[0] > 0.0 ? std::log(x[0]) : (x[0] == 0.0 ? -HUGE_VAL : NAN);
    for (i64 k = 1; k < n; k++) {
        double acc = 0.0;
        i64 lo = k + 1 - lx > 0 ? k + 1 - lx : 1;
        for (i64 j = lo; j < k; j++)
            acc += ((k - j) < lx ? x[k - j] : 0.0) * (double)j * out[j];
        double xk = k < lx ? x[k] : 0.0;
        out[k] = (xk * (double)k - acc) / x[0] / (double)k;
    }
}

double f64_exp(double v) { return std::exp(v); }
double f64_log(double v) {
    if (v > 0.0) return std::log(v);
    if (v == 0.0) return -HUGE_VAL;
    return NAN;
}
// np.log semantics (log(0) = -inf, log(neg) = nan) == IEEE std::log
double np_log(double v) { return std::log(v); }

// mirrors TaylorPoly.exp / .log
Poly exp_log_poly(Poly& self, bool is_exp) {
    if (self.has_hc && is_constant(self)) {
        Poly out = self;
        out.buf = make_buf(1);
        double raw = self.data()[0];
        out.data()[0] = is_exp ? std::exp(raw) : np_log(raw);
        out.has_hc = true;
        out.hc = is_exp ? f64_exp(self.hc) : f64_log(self.hc);
        out.has_lin = false;
        out.has_c0 = false;
        out.c0 = 0;
        finish_meta(out);
        return out;
    }
    Poly me = extend_to_dim(self, (int)self.deg.size(), 1);
    std::vector<i64> shape(me.deg.size());
    for (size_t i = 0; i < me.deg.size(); i++)
        shape[i] = me.shape[i] == 1 ? 1 : as_int(me.deg[i]);
    auto eff = effective_axes(me.shape);
    Poly out = mk(shape, self.deg, make_buf(numel(shape)));
    if (eff.empty()) {
        double v = me.data()[0];
        double r = is_exp ? std::exp(v) : np_log(v);
        for (double& x : *out.buf) x = r;
    } else if (eff.size() == 1) {
        int axis = eff[0];
        i64 n = shape[axis];
        std::vector<double> x((size_t)n, 0.0);
        {
            const auto str = strides_of(me.shape);
            i64 lx = std::min(me.shape[axis], n);
            for (i64 k = 0; k < lx; k++) x[(size_t)k] = me.data()[k * str[axis]];
        }
        std::vector<double> res((size_t)n, 0.0);
        if (is_exp)
            exp_1d_vec(x.data(), n, res.data(), n);
        else {
            // the numpy path guards the native kernel on finiteness and
            // x[0] > 0; the fallback recurrence computes the same values
            // with the same formula, so a single recurrence suffices
            log_1d_vec(x.data(), n, res.data(), n);
        }
        // result placed along `axis`, other dims 1 -- but `shape` may
        // have other non-1 dims? no: eff.size()==1 means only `axis`
        // is non-1 in me.shape, so shape has deg at axis... careful:
        // shape[i] = 1 where me.shape[i]==1, deg where >1. Only axis >1.
        const auto ostr = strides_of(shape);
        for (i64 k = 0; k < n; k++) out.data()[k * ostr[axis]] = res[(size_t)k];
    } else {
        throw Unsupported{"multivariate poly_exp/poly_log (Newton path)"};
    }
    out.has_c0 = self.has_c0;
    out.c0 = is_exp ? f64_exp(self.c0) : f64_log(self.c0);
    if (!self.has_c0) {
        out.has_c0 = false;
        finish_meta(out);
    }
    return out;
}

Poly pow_poly(Poly& self, i64 n) {
    if (n == 0) return one_poly();
    if (n == 1) return self;
    Poly res = one_poly();
    Poly base = self;
    while (n > 0) {
        if (n & 1) res = mul_poly(res, base);
        Poly sq = mul_poly(base, base);
        base = sq;
        n >>= 1;
    }
    return res;
}

i64 isat_sub(i64 d, i64 n) {
    if (d == INF) return INF;
    return std::max((i64)0, d - n);
}

// scale along axis by a factor vector
void scale_axis_inplace(Poly& p, int axis, const std::vector<double>& factors) {
    const auto str = strides_of(p.shape);
    const int nd = p.nd();
    const i64 n = p.shape[axis];
    const i64 total = p.size();
    double* dp = p.data();
    // iterate all elements; factor index = (flat / str[axis]) % n
    const i64 sa = str[axis];
    for (i64 i = 0; i < total; i++) {
        i64 k = (i / sa) % n;
        dp[i] = dp[i] * factors[(size_t)k];
    }
    (void)nd;
}

// mirrors derivative(v, n): slice off n, scale by falling factors
Poly derivative_poly(const Poly& self, int v, i64 n) {
    std::vector<i64> degrees = self.deg;
    if (v >= self.nd()) {
        if (n == 0) return self;
        return zero_with(degrees);
    }
    degrees[v] = isat_sub(degrees[v], n);
    if (n >= self.shape[v]) return zero_with(degrees);
    Poly sliced = slice_axis(self, v, n, self.shape[v]);
    sliced.deg = degrees;
    i64 m = sliced.shape[v];
    // falling factors, pure-double sequence (_falling_factors_f64)
    std::vector<double> factors((size_t)m);
    double ff = 1.0;
    for (i64 i = 1; i <= n; i++) ff = ff * (double)i;
    for (i64 k = 0; k < m; k++) {
        factors[(size_t)k] = ff;
        ff = ff * (double)(n + k + 1) / (double)(k + 1);
    }
    scale_axis_inplace(sliced, v, factors);
    sliced.has_hc = false;
    sliced.has_lin = false;
    sliced.has_c0 = false;
    return sliced;
}

// mirrors taylor_expansion_of_coeff(v, n): binomial factors
Poly taylor_expansion_of_coeff_poly(const Poly& self, int v, i64 n) {
    std::vector<i64> degrees = self.deg;
    if (v >= self.nd()) {
        if (n == 0) return self;
        return zero_with(degrees);
    }
    degrees[v] = isat_sub(degrees[v], n);
    if (n >= self.shape[v]) return zero_with(degrees);
    Poly sliced = slice_axis(self, v, n, self.shape[v]);
    sliced.deg = degrees;
    i64 m = sliced.shape[v];
    std::vector<double> factors((size_t)std::max(m, (i64)1));
    factors[0] = 1.0;
    double factor = 1.0;
    for (i64 k = 1; k < m; k++) {
        factor = factor * (double)(n + k) / (double)k;
        factors[(size_t)k] = factor;
    }
    scale_axis_inplace(sliced, v, factors);
    sliced.has_hc = false;
    sliced.has_lin = false;
    sliced.has_c0 = false;
    return sliced;
}

// mirrors coefficients_of_term(v, order): slice [order, order+1), degrees kept
Poly coefficients_of_term_poly(const Poly& self, int v, i64 order) {
    if (v >= self.nd()) {
        if (order == 0) return self;
        return zero_with(self.deg);
    }
    if (order >= self.shape[v]) return zero_with(self.deg);
    Poly out = slice_axis(self, v, order, order + 1);
    out.deg = self.deg;
    out.has_hc = false;
    out.has_lin = false;
    out.has_c0 = order == 0 && self.has_c0;
    out.c0 = self.c0;
    return out;
}

// mirrors taylor_polynomial_terms(v, orders)
Poly taylor_polynomial_terms_poly(const Poly& self, int v,
                                  const std::vector<i64>& orders) {
    i64 max_order_p1 = 1;
    for (i64 o : orders) max_order_p1 = std::max(max_order_p1, o + 1);
    if (v >= self.nd()) {
        for (i64 o : orders)
            if (o == 0) return self;
        return zero_with(self.deg);
    }
    i64 upper = std::min(self.shape[v], max_order_p1);
    Poly out = slice_axis(self, v, 0, upper);
    out.deg = self.deg;
    // zero the non-kept slices
    std::vector<bool> keep((size_t)upper, false);
    for (i64 o : orders)
        if (o < upper) keep[(size_t)o] = true;
    const auto str = strides_of(out.shape);
    const i64 sa = str[v];
    const i64 n = out.shape[v];
    double* dp = out.data();
    const i64 total = out.size();
    for (i64 i = 0; i < total; i++) {
        i64 k = (i / sa) % n;
        if (!keep[(size_t)k]) dp[i] = 0.0;
    }
    out.has_hc = false;
    out.has_lin = false;
    out.has_c0 = false;
    return out;
}

// mirrors shift_down(v, n)
Poly shift_down_poly(const Poly& self, int v, i64 n) {
    if (v >= self.nd()) return self;
    std::vector<i64> degrees = self.deg;
    degrees[v] = isat_sub(degrees[v], n);
    i64 length = self.shape[v];
    Poly out;
    if (length <= n + 1) {
        // sum the whole axis (keepdims)
        std::vector<i64> ns = self.shape;
        ns[v] = 1;
        out = mk(ns, degrees, make_buf_raw(numel(ns)));
        const auto str = strides_of(self.shape);
        const auto ostr = strides_of(ns);
        const i64 total = out.size();
        std::vector<i64> idx(self.nd(), 0);
        for (i64 oi = 0; oi < total; oi++) {
            // decode oi into idx over ns, sum over axis v
            i64 rem = oi;
            i64 soff = 0;
            for (int d = 0; d < self.nd(); d++) {
                i64 q = rem / ostr[d];
                rem = rem % ostr[d];
                soff += q * str[d];
            }
            double acc = self.data()[soff];
            for (i64 k = 1; k < length; k++) acc += self.data()[soff + k * str[v]];
            out.data()[oi] = acc;
        }
    } else {
        i64 newlen = length - n;
        std::vector<i64> ns = self.shape;
        ns[v] = newlen;
        out = mk(ns, degrees, make_buf_raw(numel(ns)));
        const auto str = strides_of(self.shape);
        const auto ostr = strides_of(ns);
        const i64 lanes = out.size() / newlen;
        // iterate lanes (all non-v indices)
        std::vector<i64> idx(self.nd(), 0);
        for (i64 l = 0; l < lanes; l++) {
            i64 soff = 0, ooff = 0;
            for (int d = 0; d < self.nd(); d++) {
                if (d == v) continue;
                soff += idx[d] * str[d];
                ooff += idx[d] * ostr[d];
            }
            double head = 0.0;
            for (i64 k = 0; k < n; k++) head += self.data()[soff + k * str[v]];
            out.data()[ooff] =
                n > 0 ? self.data()[soff + n * str[v]] + head
                      : self.data()[soff + n * str[v]];
            for (i64 k = 1; k < newlen; k++)
                out.data()[ooff + k * ostr[v]] = self.data()[soff + (n + k) * str[v]];
            for (int d = self.nd() - 1; d >= 0; d--) {
                if (d == v) continue;
                if (++idx[d] < self.shape[d]) break;
                idx[d] = 0;
            }
        }
    }
    out.has_hc = false;
    out.has_lin = false;
    out.has_c0 = false;
    return out;
}

Poly remove_last_variable_poly(const Poly& self) {
    int v = (int)self.deg.size() - 1;
    Poly out = self;
    if (v < self.nd()) {
        out = slice_axis(self, v, 0, 1);
        out.shape.pop_back();
    }
    out.deg = std::vector<i64>(self.deg.begin(), self.deg.end() - 1);
    out.has_hc = self.has_hc;
    out.hc = self.hc;
    out.has_lin = false;
    out.has_c0 = self.has_c0;
    out.c0 = self.c0;
    return out;
}

// mirrors _const_term_host
double const_term_host(const Poly& p) {
    if (p.has_c0) return p.c0;
    if (p.has_hc && is_constant(p)) return p.hc;
    if (p.has_lin) return p.lin_c;
    return p.data()[0];
}

// mirrors _tp_var: TaylorPoly.var with demand-derived degrees
Poly tp_var(int v, double x, const Demand& d) {
    i64 length = d.axis(v);
    i64 sv = (length == INF || length >= 2) ? 2 : as_int(length);
    std::vector<i64> shape((size_t)v + 1, 1);
    shape[v] = sv;
    std::vector<i64> degs((size_t)v + 1);
    for (int i = 0; i <= v; i++) degs[i] = d.axis(i);
    Poly p = mk(shape, degs, make_buf(numel(shape)));
    p.data()[0] = x;
    if (sv > 1) {
        p.data()[1] = 1.0;
        p.has_lin = true;
        p.lin_c = x;
        p.lin_m = 1.0;
        p.lin_v = v;
    } else {
        p.has_hc = true;
        p.hc = x;
    }
    finish_meta(p);
    return p;
}

// mirrors _tp_var_at_zero (shape[v] = 2 always)
Poly tp_var_at_zero(int v, const Demand& d) {
    i64 length = d.axis(v);
    std::vector<i64> shape((size_t)v + 1, 1);
    shape[v] = 2;
    std::vector<i64> degs((size_t)v + 1);
    for (int i = 0; i <= v; i++) degs[i] = d.axis(i);
    Poly p = mk(shape, degs, make_buf(numel(shape)));
    p.data()[0] = 0.0;
    bool slope = (length == INF || length > 1);
    p.data()[1] = slope ? 1.0 : 0.0;
    if (slope) {
        p.has_lin = true;
        p.lin_c = 0.0;
        p.lin_m = 1.0;
        p.lin_v = v;
    }
    finish_meta(p);
    return p;
}

bool all_finite(const Poly& p) {
    for (double x : *p.buf)
        if (!std::isfinite(x)) return false;
    return true;
}

// forward declaration
Poly subst_var_poly(Poly& self, int v, Poly& subst);

// mirrors _subst_shift_scale (Pascal transform); returns false if the
// pattern does not match
bool subst_shift_scale(Poly& self, int v, Poly& subst,
                       const std::vector<i64>& degrees, Poly* result) {
    const Poly& g = subst;
    if (v >= g.nd() || g.shape[v] != 2) return false;
    int u = -1;
    for (int i = 0; i < g.nd(); i++) {
        if (g.shape[i] != 1 && i != v) {
            if (u != -1) return false;
            u = i;
        }
    }
    if (u != -1 && (g.shape[u] != 2 || u == v)) return false;
    const auto gstr = strides_of(g.shape);
    i64 off1 = gstr[v] + (u != -1 ? gstr[u] : 0);
    double alpha = g.data()[0];
    double beta = g.data()[off1];
    // verify no other nonzeros and finiteness
    for (i64 i = 0; i < g.size(); i++) {
        double want = i == 0 ? alpha : (i == off1 ? beta : 0.0);
        if (g.data()[i] != want) return false;
        if (!std::isfinite(g.data()[i])) return false;
    }
    Poly a = self;
    while ((int)a.shape.size() < (int)degrees.size()) a.shape.push_back(1);
    if (!all_finite(a)) return false;
    // truncate input to result degrees on every axis but v
    for (int ax = 0; ax < a.nd(); ax++) {
        i64 dd = degrees[ax];
        if (ax != v && dd != INF && a.shape[ax] > dd)
            a = slice_axis(a, ax, 0, as_int(dd));
    }
    i64 n_in = a.shape[v];
    i64 dv = degrees[v];
    i64 n_out = dv == INF ? n_in : std::min(n_in, as_int(dv));
    // Pascal matrix by recurrence
    std::vector<double> B((size_t)(n_in * n_out), 0.0);
    B[0] = 1.0;
    std::vector<double> row((size_t)n_out, 0.0);
    row[0] = 1.0;
    for (i64 i = 1; i < n_in; i++) {
        std::vector<double> nw((size_t)n_out);
        for (i64 j = 0; j < n_out; j++) nw[(size_t)j] = alpha * row[(size_t)j];
        for (i64 j = 1; j < n_out; j++) nw[(size_t)j] += beta * row[(size_t)(j - 1)];
        std::memcpy(&B[(size_t)(i * n_out)], nw.data(),
                    (size_t)n_out * sizeof(double));
        row = nw;
    }
    // T = moveaxis(a, v, -1) @ B : lanes x n_in times n_in x n_out
    i64 R = a.size() / std::max(n_in, (i64)1);
    std::vector<double> am((size_t)(n_in * R));
    moveaxis_to_front(a.data(), a.shape, v, am.data());  // (n_in, R)
    // result T in (n_out, R) front layout: T[j, r] = sum_i am[i,r]*B[i,j]
    std::vector<double> T((size_t)(n_out * R), 0.0);
    for (i64 i = 0; i < n_in; i++)
        for (i64 j = 0; j < n_out; j++) {
            double bij = B[(size_t)(i * n_out + j)];
            if (bij == 0.0) continue;
            const double* arow = &am[(size_t)(i * R)];
            double* trow = &T[(size_t)(j * R)];
            for (i64 r = 0; r < R; r++) trow[r] += arow[r] * bij;
        }
    if (u == -1) {
        std::vector<i64> oshape = a.shape;
        oshape[v] = n_out;
        Poly out = mk(oshape, degrees, make_buf_raw(numel(oshape)));
        moveaxis_from_front(T.data(), n_out, R, oshape, v, out.data());
        *result = out;
        return true;
    }
    // bilinear: column j also shifts the u axis by j
    i64 du = degrees[u];
    i64 u_in = a.shape[u];
    i64 u_out = u_in + n_out - 1;
    if (du != INF) u_out = std::min(u_out, as_int(du));
    std::vector<i64> oshape = a.shape;
    oshape[v] = n_out;
    oshape[u] = u_out;
    Poly out = mk(oshape, degrees, make_buf(numel(oshape)));
    // build per-column: out[..., u=lo+t, v=j] = T[j, lane with u=t]
    // Work in index space directly.
    const auto ostr = strides_of(oshape);
    const auto astr_shape = a.shape;  // lanes of T follow a's non-v axes order
    // lane decomposition of r: a's axes except v, in original order
    std::vector<int> lane_axes;
    std::vector<i64> lane_dims;
    for (int d = 0; d < (int)a.shape.size(); d++)
        if (d != v) {
            lane_axes.push_back(d);
            lane_dims.push_back(a.shape[d]);
        }
    for (i64 j = 0; j < n_out; j++) {
        i64 lo = j;
        i64 hi = std::min(u_out, j + u_in);
        if (lo >= hi) break;
        const double* trow = &T[(size_t)(j * R)];
        // iterate lanes
        std::vector<i64> li(lane_dims.size(), 0);
        for (i64 r = 0; r < R; r++) {
            // u index within lane
            i64 ui = 0;
            i64 ooff = j * ostr[v];
            bool in_range = true;
            for (size_t d = 0; d < lane_axes.size(); d++) {
                int ax = lane_axes[d];
                i64 iv = li[d];
                if (ax == u) {
                    ui = iv;
                    if (lo + iv >= u_out) {
                        in_range = false;
                    }
                    ooff += (lo + iv) * ostr[ax];
                } else {
                    ooff += iv * ostr[ax];
                }
            }
            (void)ui;
            if (in_range) out.data()[ooff] = trow[r];
            for (int d = (int)lane_dims.size() - 1; d >= 0; d--) {
                if (++li[d] < lane_dims[d]) break;
                li[d] = 0;
            }
        }
    }
    *result = out;
    return true;
}

// mirrors _subst_horner_native preconditions + kernel (fused Horner)
bool subst_horner_native(Poly& self, int v, Poly& subst,
                         const std::vector<i64>& degrees, Poly* result) {
    Poly a = self;
    Poly g = subst;
    if (g.size() > 64) return false;
    if (!all_finite(a) || !all_finite(g)) return false;
    int nd = (int)degrees.size();
    while (a.nd() < nd) a.shape.push_back(1);
    while (g.nd() < nd) g.shape.push_back(1);
    if (v >= nd) return false;
    // clip a to result degrees on non-v axes
    for (int ax = 0; ax < nd; ax++) {
        i64 dd = degrees[ax];
        if (ax != v && dd != INF && a.shape[ax] > dd)
            a = slice_axis(a, ax, 0, as_int(dd));
    }
    auto clip = [&](int ax, i64 n) {
        i64 dd = degrees[ax];
        return dd == INF ? n : std::min(n, as_int(dd));
    };
    std::vector<i64> chunk_shape(nd);
    for (int ax = 0; ax < nd; ax++)
        chunk_shape[ax] = ax == v ? 1 : clip(ax, a.shape[ax]);
    i64 cn = numel(chunk_shape);
    if (cn <= g.size()) return false;
    std::vector<i64> s_res = chunk_shape;
    for (i64 it = 0; it < a.shape[v] - 1; it++) {
        for (int ax = 0; ax < nd; ax++)
            s_res[ax] = std::max(clip(ax, s_res[ax] + g.shape[ax] - 1),
                                 chunk_shape[ax]);
    }
    // fused Horner: res <- res (*) g + a_i for i = sa[v]-1 .. 0 ; one
    // output-centric gather pass over g's nonzeros per step (same
    // accumulation order as _seriesops.subst_horner)
    const auto str_a = strides_of(a.shape);
    const auto str_o = strides_of(s_res);
    const i64 total = numel(s_res);
    struct Nz {
        i64 off;
        std::vector<i64> idx;
        double val;
    };
    std::vector<Nz> nzs;
    {
        std::vector<i64> gi(nd, 0);
        const i64 gt = g.size();
        for (i64 flat = 0; flat < gt; flat++) {
            double val = g.data()[flat];
            bool inside = true;
            for (int d = 0; d < nd; d++)
                if (gi[d] >= s_res[d]) {
                    inside = false;
                    break;
                }
            if (val != 0.0 && inside) {
                i64 off = 0;
                for (int d = 0; d < nd; d++) off += gi[d] * str_o[d];
                nzs.push_back({off, gi, val});
            }
            int d = nd;
            while (d > 0) {
                d--;
                if (++gi[d] < g.shape[d]) break;
                gi[d] = 0;
            }
        }
    }
    std::vector<double> buf_a((size_t)total, 0.0), buf_b((size_t)total, 0.0);
    double* cur = buf_a.data();
    double* nxt = buf_b.data();
    const double* ap = a.data();
    const int last = nd - 1;
    for (i64 i = a.shape[v] - 1; i >= 0; i--) {
        std::vector<i64> x(nd, 0);
        for (i64 base = 0; base < total; base += s_res[last]) {
            const i64 run = s_res[last];
            double* np_ = nxt + base;
            for (i64 j = 0; j < run; j++) np_[j] = 0.0;
            for (const Nz& nz : nzs) {
                bool ok = true;
                for (int d = 0; d + 1 < nd; d++)
                    if (x[d] < nz.idx[d]) {
                        ok = false;
                        break;
                    }
                if (!ok) continue;
                const double* cp = cur + base - (nz.off - nz.idx[last]);
                const double val = nz.val;
                for (i64 j = nz.idx[last]; j < run; j++)
                    np_[j] += cp[j - nz.idx[last]] * val;
            }
            if (v == nd - 1) {
                bool in_a = true;
                i64 aoff = 0;
                for (int d = 0; d + 1 < nd; d++) {
                    if (x[d] >= a.shape[d]) {
                        in_a = false;
                        break;
                    }
                    aoff += x[d] * str_a[d];
                }
                if (in_a) np_[0] += ap[aoff + i * str_a[v]];
            } else if (x[v] == 0) {
                bool in_a = true;
                i64 aoff = i * str_a[v];
                for (int d = 0; d + 1 < nd; d++) {
                    if (d == v) continue;
                    if (x[d] >= a.shape[d]) {
                        in_a = false;
                        break;
                    }
                    aoff += x[d] * str_a[d];
                }
                if (in_a) {
                    const i64 arun = std::min(a.shape[last], run);
                    const double* arow = ap + aoff;
                    for (i64 j = 0; j < arun; j++) np_[j] += arow[j];
                }
            }
            int d = nd - 1;
            while (d > 0) {
                d--;
                if (++x[d] < s_res[d]) break;
                x[d] = 0;
            }
        }
        std::swap(cur, nxt);
    }
    Poly out = mk(s_res, degrees, make_buf_raw(total));
    std::memcpy(out.data(), cur, (size_t)total * sizeof(double));
    *result = out;
    return true;
}

// mirrors subst_var (Horner composition along axis v)
Poly subst_var_poly(Poly& self, int v, Poly& subst) {
    if (v >= self.nd()) return self;
    std::vector<i64> degrees = min_degrees(self, subst);
    if (is_zero(subst)) {
        if (g_stats) g_stats->subst_zero++;
        Poly out = slice_axis(self, v, 0, 1);
        out.deg = degrees;
        out.has_hc = false;
        out.has_lin = false;
        out.has_c0 = self.has_c0;
        out.c0 = self.c0;
        return out;
    }
    // subst-at-1: sequential right-to-left sum along v
    if (subst.has_hc && is_constant(subst) && subst.hc == 1.0) {
        if (g_stats) g_stats->subst_at1++;
        Poly coeffs = self;
        while ((int)coeffs.shape.size() < (int)degrees.size())
            coeffs.shape.push_back(1);
        for (int ax = 0; ax < coeffs.nd(); ax++) {
            i64 dd = degrees[ax];
            if (ax != v && dd != INF && coeffs.shape[ax] > dd)
                coeffs = slice_axis(coeffs, ax, 0, as_int(dd));
        }
        // seq_sum_axis: acc order a[n-1], +a[n-2], ..., +a[0]
        std::vector<i64> ns = coeffs.shape;
        i64 n = ns[v];
        ns[v] = 1;
        Poly out = mk(ns, degrees, make_buf_raw(numel(ns)));
        const auto str = strides_of(coeffs.shape);
        const auto ostr = strides_of(ns);
        const i64 lanes = numel(ns);
        std::vector<i64> idx(coeffs.nd(), 0);
        for (i64 l = 0; l < lanes; l++) {
            i64 soff = 0, ooff = 0;
            i64 rem = l;
            for (int d = 0; d < coeffs.nd(); d++) {
                i64 q = rem / ostr[d];
                rem = rem % ostr[d];
                soff += q * str[d];
                ooff += q * ostr[d];
            }
            double acc = coeffs.data()[soff + (n - 1) * str[v]];
            for (i64 k = n - 2; k >= 0; k--) acc += coeffs.data()[soff + k * str[v]];
            out.data()[ooff] = acc;
        }
        out.has_hc = false;
        out.has_lin = false;
        out.has_c0 = false;
        return out;
    }
    // diagonal scaling by powers of m (linear replacement in the same var
    // with zero constant)
    if (subst.has_lin && v == subst.lin_v && subst.lin_c == 0.0) {
        if (g_stats) g_stats->subst_diag++;
        double m = subst.lin_m;
        Poly coeffs = self;
        for (int ax = 0; ax < coeffs.nd(); ax++) {
            i64 dd = ax < (int)degrees.size() ? degrees[ax] : INF;
            if (dd != INF && coeffs.shape[ax] > dd)
                coeffs = slice_axis(coeffs, ax, 0, as_int(dd));
        }
        i64 n = coeffs.shape[v];
        std::vector<double> factors((size_t)n);
        double f = 1.0;
        for (i64 k = 0; k < n; k++) {
            factors[(size_t)k] = f;
            f = f * m;
        }
        Poly out = coeffs;
        out.buf = make_buf_raw((i64)coeffs.buf->size());
        {
            // single-pass scaled copy: factor index = (i / stride_v) % n
            const auto str = strides_of(coeffs.shape);
            const i64 sa = str[(size_t)v];
            const double* sp = coeffs.data();
            double* dp = out.buf->data();
            const i64 total = (i64)coeffs.buf->size();
            for (i64 i = 0; i < total; i++)
                dp[i] = sp[i] * factors[(size_t)((i / sa) % n)];
        }
        out.deg = degrees;
        out.has_hc = false;
        out.has_lin = false;
        out.has_c0 = self.has_c0;
        out.c0 = self.c0;
        return out;
    }
    Poly fast;
    if (subst_shift_scale(self, v, subst, degrees, &fast)) {
        if (g_stats) g_stats->subst_pascal++;
        fast.has_hc = false;
        fast.has_lin = false;
        fast.has_c0 = false;
        return fast;
    }
    if (subst_horner_native(self, v, subst, degrees, &fast)) {
        if (g_stats) g_stats->subst_horner++;
        fast.has_hc = false;
        fast.has_lin = false;
        fast.has_c0 = false;
        return fast;
    }
    // general Horner
    if (g_stats) g_stats->subst_generic++;
    Poly res = zero_with(degrees);
    Poly coeffs = self;
    while ((int)coeffs.shape.size() < (int)degrees.size())
        coeffs.shape.push_back(1);
    for (i64 i = coeffs.shape[v] - 1; i >= 0; i--) {
        Poly chunk = slice_axis(coeffs, v, i, i + 1);
        for (int ax = 0; ax < chunk.nd(); ax++) {
            i64 dd = degrees[ax];
            if (dd != INF && chunk.shape[ax] > dd)
                chunk = slice_axis(chunk, ax, 0, as_int(dd));
        }
        chunk.deg = degrees;
        chunk.has_hc = false;
        chunk.has_lin = false;
        chunk.has_c0 = false;
        Poly prod = mul_poly(res, subst);
        res = add_op(prod, chunk);
    }
    return res;
}

}  // namespace

// The evaluator core continues in evaltape_eval.inc (same TU) to keep
// this file navigable: node table, memo/LRU, _eval mirror, Python glue.
#include "evaltape_eval.inc"
