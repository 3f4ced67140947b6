// Native series-arithmetic kernels for the host runtime.
//
// The reference implements its entire runtime natively (Rust); in the
// TPU-native design the accelerator path is JAX/XLA, and this extension is
// the native host path used by the numpy/hybrid backends for the
// power-series kernels at small-to-medium orders where Python/numpy
// dispatch overhead dominates:
//
//   * conv_trunc_f64 - truncated n-D Cauchy product
//     (reference: src/multivariate_taylor.rs:972-1012)
//   * div_1d_f64     - power-series long division (forward substitution,
//     reference: multivariate_taylor.rs:1162-1192)
//   * exp_1d_f64     - exp ODE recurrence (multivariate_taylor.rs:1270-1283)
//   * log_1d_f64     - log recurrence (multivariate_taylor.rs:1319-1333)
//
// Exposed through the buffer protocol (no numpy C API dependency): inputs
// are C-contiguous float64 buffers plus shape tuples.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BufView {
    Py_buffer view{};
    bool ok = false;
    ~BufView() {
        if (ok) PyBuffer_Release(&view);
    }
    const double* data() const { return static_cast<const double*>(view.buf); }
    double* mut_data() const { return static_cast<double*>(view.buf); }
    Py_ssize_t len() const { return view.len / (Py_ssize_t)sizeof(double); }
};

bool get_f64_buffer(PyObject* obj, BufView* out, bool writable = false) {
    int flags = PyBUF_C_CONTIGUOUS | PyBUF_FORMAT;
    if (writable) flags |= PyBUF_WRITABLE;
    if (PyObject_GetBuffer(obj, &out->view, flags) != 0) return false;
    out->ok = true;
    if (out->view.itemsize != sizeof(double) ||
        (out->view.format && strcmp(out->view.format, "d") != 0)) {
        PyErr_SetString(PyExc_TypeError, "expected a float64 buffer");
        return false;
    }
    return true;
}

bool parse_shape(PyObject* tup, std::vector<int64_t>* out) {
    if (!PyTuple_Check(tup)) {
        PyErr_SetString(PyExc_TypeError, "shape must be a tuple");
        return false;
    }
    Py_ssize_t n = PyTuple_GET_SIZE(tup);
    out->resize(n);
    for (Py_ssize_t i = 0; i < n; i++) {
        long long v = PyLong_AsLongLong(PyTuple_GET_ITEM(tup, i));
        if (v < 0 && PyErr_Occurred()) return false;
        (*out)[i] = v;
    }
    return true;
}

std::vector<int64_t> strides_of(const std::vector<int64_t>& shape) {
    std::vector<int64_t> s(shape.size());
    int64_t acc = 1;
    for (Py_ssize_t i = (Py_ssize_t)shape.size() - 1; i >= 0; i--) {
        s[i] = acc;
        acc *= shape[i];
    }
    return s;
}

int64_t numel(const std::vector<int64_t>& shape) {
    int64_t n = 1;
    for (int64_t s : shape) n *= s;
    return n;
}

// Truncated n-D Cauchy product.  Iterate the elements of the *smaller*
// operand and scatter val * other into the clipped output box; the last
// dimension is a contiguous run (no per-element index arithmetic, no
// allocations inside the loops).
void scatter_rec(const double* big, const std::vector<int64_t>& sbig,
                 const std::vector<int64_t>& strb,
                 double* c, const std::vector<int64_t>& sc,
                 const std::vector<int64_t>& strc,
                 const std::vector<int64_t>& bounds, double v,
                 size_t d, int64_t boff, int64_t coff) {
    const size_t nd = sc.size();
    if (d == nd - 1) {
        const int64_t run = bounds[d];
        const double* bp = big + boff;
        double* cp = c + coff;
        for (int64_t j = 0; j < run; j++) cp[j] += v * bp[j];
        return;
    }
    for (int64_t j = 0; j < bounds[d]; j++) {
        scatter_rec(big, sbig, strb, c, sc, strc, bounds, v, d + 1,
                    boff + j * strb[d], coff + j * strc[d]);
    }
}

void conv_nd(const double* a, const std::vector<int64_t>& sa,
             const double* b, const std::vector<int64_t>& sb,
             double* c, const std::vector<int64_t>& sc) {
    const size_t nd = sc.size();
    // choose the smaller operand as the scatter source
    const double* small_p = a;
    const double* big_p = b;
    const std::vector<int64_t>* ssmall = &sa;
    const std::vector<int64_t>* sbig = &sb;
    if (numel(sb) < numel(sa)) {
        small_p = b;
        big_p = a;
        ssmall = &sb;
        sbig = &sa;
    }
    const auto str_small = strides_of(*ssmall);
    const auto str_big = strides_of(*sbig);
    const auto str_c = strides_of(sc);
    const int64_t total_c = numel(sc);
    for (int64_t i = 0; i < total_c; i++) c[i] = 0.0;
    std::vector<int64_t> idx(nd, 0);
    std::vector<int64_t> bounds(nd, 0);
    const int64_t total_s = numel(*ssmall);
    for (int64_t flat = 0; flat < total_s; flat++) {
        const double v = small_p[flat];
        if (v != 0.0) {
            bool ok = true;
            int64_t coff = 0;
            for (size_t d = 0; d < nd; d++) {
                int64_t bd = sc[d] - idx[d];
                if ((*sbig)[d] < bd) bd = (*sbig)[d];
                if (bd <= 0) {
                    ok = false;
                    break;
                }
                bounds[d] = bd;
                coff += idx[d] * str_c[d];
            }
            if (ok) {
                scatter_rec(big_p, *sbig, str_big, c, sc, str_c, bounds, v,
                            0, 0, coff);
            }
        }
        // advance the odometer over the small operand
        size_t d = nd;
        while (d > 0) {
            d--;
            if (++idx[d] < (*ssmall)[d]) break;
            idx[d] = 0;
        }
    }
}

// Specialized fast 1-D truncated convolution.
void conv_1d(const double* a, int64_t la, const double* b, int64_t lb,
             double* c, int64_t lc) {
    for (int64_t k = 0; k < lc; k++) {
        int64_t lo = k - (lb - 1) > 0 ? k - (lb - 1) : 0;
        int64_t hi = k < la - 1 ? k : la - 1;
        double acc = 0.0;
        for (int64_t j = lo; j <= hi; j++) acc += a[j] * b[k - j];
        c[k] = acc;
    }
}

PyObject* py_conv_trunc(PyObject*, PyObject* args) {
    PyObject *a_obj, *b_obj, *out_obj, *sa_t, *sb_t, *sc_t;
    if (!PyArg_ParseTuple(args, "OOOOOO", &a_obj, &sa_t, &b_obj, &sb_t,
                          &out_obj, &sc_t))
        return nullptr;
    BufView a, b, c;
    if (!get_f64_buffer(a_obj, &a) || !get_f64_buffer(b_obj, &b) ||
        !get_f64_buffer(out_obj, &c, true))
        return nullptr;
    std::vector<int64_t> sa, sb, sc;
    if (!parse_shape(sa_t, &sa) || !parse_shape(sb_t, &sb) ||
        !parse_shape(sc_t, &sc))
        return nullptr;
    if (sa.size() != sb.size() || sa.size() != sc.size()) {
        PyErr_SetString(PyExc_ValueError, "rank mismatch");
        return nullptr;
    }
    Py_BEGIN_ALLOW_THREADS;
    if (sc.size() == 1) {
        conv_1d(a.data(), sa[0], b.data(), sb[0], c.mut_data(), sc[0]);
    } else {
        conv_nd(a.data(), sa, b.data(), sb, c.mut_data(), sc);
    }
    Py_END_ALLOW_THREADS;
    Py_RETURN_NONE;
}

// Power-series division along one axis with trailing lanes R:
// out[k, r] = (x[k, r] - sum_{j<k} out[j, r] * y[k-j]) / y[0]
PyObject* py_div_1d(PyObject*, PyObject* args) {
    PyObject *x_obj, *y_obj, *out_obj;
    Py_ssize_t n, R, ly, lx;
    if (!PyArg_ParseTuple(args, "OnOnOnn", &x_obj, &lx, &y_obj, &ly, &out_obj,
                          &n, &R))
        return nullptr;
    BufView x, y, o;
    if (!get_f64_buffer(x_obj, &x) || !get_f64_buffer(y_obj, &y) ||
        !get_f64_buffer(out_obj, &o, true))
        return nullptr;
    const double* xs = x.data();
    const double* ys = y.data();
    double* out = o.mut_data();
    Py_BEGIN_ALLOW_THREADS;
    for (Py_ssize_t k = 0; k < n; k++) {
        Py_ssize_t lo = k + 1 - ly > 0 ? k + 1 - ly : 0;
        for (Py_ssize_t r = 0; r < R; r++) {
            double acc = k < lx ? xs[k * R + r] : 0.0;
            for (Py_ssize_t j = lo; j < k; j++)
                acc -= out[j * R + r] * ys[k - j];
            out[k * R + r] = acc / ys[0];
        }
    }
    Py_END_ALLOW_THREADS;
    Py_RETURN_NONE;
}

// exp recurrence: out[0] = exp(x[0]); out[k] = (sum_{j>=1} j x[j] out[k-j])/k
PyObject* py_exp_1d(PyObject*, PyObject* args) {
    PyObject *x_obj, *out_obj;
    Py_ssize_t n, lx;
    if (!PyArg_ParseTuple(args, "OnOn", &x_obj, &lx, &out_obj, &n))
        return nullptr;
    BufView x, o;
    if (!get_f64_buffer(x_obj, &x) || !get_f64_buffer(out_obj, &o, true))
        return nullptr;
    const double* xs = x.data();
    double* out = o.mut_data();
    Py_BEGIN_ALLOW_THREADS;
    out[0] = std::exp(xs[0]);
    for (Py_ssize_t k = 1; k < n; k++) {
        double acc = 0.0;
        Py_ssize_t hi = lx < k + 1 ? lx : k + 1;
        for (Py_ssize_t j = 1; j < hi; j++)
            acc += (double)j * xs[j] * out[k - j];
        out[k] = acc / (double)k;
    }
    Py_END_ALLOW_THREADS;
    Py_RETURN_NONE;
}

// log recurrence: out[0] = log(x[0]);
// out[k] = (k*x[k] - sum_{1<=j<k} x[k-j]*j*out[j]) / x[0] / k
PyObject* py_log_1d(PyObject*, PyObject* args) {
    PyObject *x_obj, *out_obj;
    Py_ssize_t n, lx;
    if (!PyArg_ParseTuple(args, "OnOn", &x_obj, &lx, &out_obj, &n))
        return nullptr;
    BufView x, o;
    if (!get_f64_buffer(x_obj, &x) || !get_f64_buffer(out_obj, &o, true))
        return nullptr;
    const double* xs = x.data();
    double* out = o.mut_data();
    Py_BEGIN_ALLOW_THREADS;
    out[0] = xs[0] > 0.0 ? std::log(xs[0])
                         : (xs[0] == 0.0 ? -HUGE_VAL : NAN);
    for (Py_ssize_t k = 1; k < n; k++) {
        double acc = 0.0;
        Py_ssize_t lo = k + 1 - lx > 0 ? k + 1 - lx : 1;
        for (Py_ssize_t j = lo; j < k; j++)
            acc += ((k - j) < lx ? xs[k - j] : 0.0) * (double)j * out[j];
        double xk = k < lx ? xs[k] : 0.0;
        out[k] = (xk * (double)k - acc) / xs[0] / (double)k;
    }
    Py_END_ALLOW_THREADS;
    Py_RETURN_NONE;
}

// Fused Horner substitution: out = sum_i a[..., i, ...] * g^i along axis
// v (reference subst loop, multivariate_taylor.rs:569-579), computed as
//   res <- res (*) g + a_i            for i = sa[v]-1 .. 0
// with the truncated product (*) done as ONE output-centric gather pass
// per step over the few nonzeros of g (the replacement series of real
// programs is tiny: 1 + p*v, 1 - p + p*v*u, w + c*(v-1), ...).  The
// per-element accumulation visits g's nonzeros in flat order, matching
// the scatter order of conv_nd / the Python Horner loop bit for bit on
// finite inputs.
PyObject* py_subst_horner(PyObject*, PyObject* args) {
    PyObject *a_obj, *g_obj, *out_obj, *sa_t, *sg_t, *so_t;
    Py_ssize_t v;
    if (!PyArg_ParseTuple(args, "OOOOOOn", &a_obj, &sa_t, &g_obj, &sg_t,
                          &out_obj, &so_t, &v))
        return nullptr;
    BufView a, g, o;
    if (!get_f64_buffer(a_obj, &a) || !get_f64_buffer(g_obj, &g) ||
        !get_f64_buffer(out_obj, &o, true))
        return nullptr;
    std::vector<int64_t> sa, sg, so;
    if (!parse_shape(sa_t, &sa) || !parse_shape(sg_t, &sg) ||
        !parse_shape(so_t, &so))
        return nullptr;
    const size_t nd = so.size();
    if (sa.size() != nd || sg.size() != nd || v < 0 || (size_t)v >= nd) {
        PyErr_SetString(PyExc_ValueError, "rank/axis mismatch");
        return nullptr;
    }
    Py_BEGIN_ALLOW_THREADS;
    const auto str_a = strides_of(sa);
    const auto str_o = strides_of(so);
    const int64_t total = numel(so);
    // nonzeros of g as (flat-offset-in-out-strides, per-axis index, value)
    struct Nz {
        int64_t off;
        std::vector<int64_t> idx;
        double val;
    };
    std::vector<Nz> nzs;
    {
        std::vector<int64_t> gi(nd, 0);
        const int64_t gt = numel(sg);
        for (int64_t flat = 0; flat < gt; flat++) {
            const double val = static_cast<const double*>(g.view.buf)[flat];
            bool inside = true;
            for (size_t d = 0; d < nd; d++)
                if (gi[d] >= so[d]) { inside = false; break; }
            if (val != 0.0 && inside) {
                int64_t off = 0;
                for (size_t d = 0; d < nd; d++) off += gi[d] * str_o[d];
                nzs.push_back({off, gi, val});
            }
            size_t d = nd;
            while (d > 0) {
                d--;
                if (++gi[d] < sg[d]) break;
                gi[d] = 0;
            }
        }
    }
    std::vector<double> buf_a(total, 0.0), buf_b(total, 0.0);
    double* cur = buf_a.data();
    double* nxt = buf_b.data();
    const double* ap = a.data();
    const int64_t last = (int64_t)nd - 1;
    for (int64_t i = sa[v] - 1; i >= 0; i--) {
        // nxt[x] = sum_nz cur[x - delta] * val  (+ a-slice when x_v == 0)
        std::vector<int64_t> x(nd, 0);
        for (int64_t base = 0; base < total; base += so[last]) {
            // run over the contiguous last axis
            const int64_t run = so[last];
            double* np_ = nxt + base;
            for (int64_t j = 0; j < run; j++) np_[j] = 0.0;
            for (const Nz& nz : nzs) {
                bool ok = true;
                for (size_t d = 0; d + 1 < nd; d++)
                    if (x[d] < nz.idx[d]) { ok = false; break; }
                if (!ok) continue;
                const double* cp = cur + base - (nz.off - nz.idx[last]);
                const double val = nz.val;
                for (int64_t j = nz.idx[last]; j < run; j++)
                    np_[j] += cp[j - nz.idx[last]] * val;
            }
            // add the a-slice at x_v == 0 (v may be the last axis)
            if ((size_t)v == nd - 1) {
                bool in_a = true;
                int64_t aoff = 0;
                for (size_t d = 0; d + 1 < nd; d++) {
                    if (x[d] >= sa[d]) { in_a = false; break; }
                    aoff += x[d] * str_a[d];
                }
                if (in_a) np_[0] += ap[aoff + i * str_a[v]];
            } else if (x[v] == 0) {
                bool in_a = true;
                int64_t aoff = i * str_a[v];
                for (size_t d = 0; d + 1 < nd; d++) {
                    if (d == (size_t)v) continue;
                    if (x[d] >= sa[d]) { in_a = false; break; }
                    aoff += x[d] * str_a[d];
                }
                if (in_a) {
                    const int64_t arun = sa[last] < run ? sa[last] : run;
                    const double* arow = ap + aoff;
                    for (int64_t j = 0; j < arun; j++)
                        np_[j] += arow[j];
                }
            }
            // advance the odometer over the leading axes
            size_t d = nd - 1;
            while (d > 0) {
                d--;
                if (++x[d] < so[d]) break;
                x[d] = 0;
            }
        }
        std::swap(cur, nxt);
    }
    std::memcpy(o.mut_data(), cur, (size_t)total * sizeof(double));
    Py_END_ALLOW_THREADS;
    Py_RETURN_NONE;
}

// The chain arithmetic must match numpy's separate mul-then-add rounding
// bit-for-bit, so FMA contraction is disabled for this loop only (the
// conv/Horner kernels keep the default flags).
__attribute__((optimize("fp-contract=off"))) void chain_rows(
    const double* in, double* out, const std::vector<int64_t>& shape,
    size_t v, int64_t fin, double lam, double c, int discrete,
    const int64_t* Ls, const int64_t* newLs, size_t steps) {
    const size_t nd = shape.size();
    const int64_t L0 = shape[v];
    std::vector<int64_t> istr = strides_of(shape);
    std::vector<int64_t> oshape(shape);
    oshape[v] = fin;
    std::vector<int64_t> ostr = strides_of(oshape);
    const int64_t isv = istr[v], osv = ostr[v];
    std::vector<double> bufa((size_t)L0), bufb((size_t)L0);
    double* cur = bufa.data();
    double* nxt = bufb.data();
    std::vector<int64_t> idx(nd, 0);
    int64_t rows = 1;
    for (size_t d = 0; d < nd; d++)
        if (d != v) rows *= shape[d];
    int64_t ioff = 0, ooff = 0;
    for (int64_t r = 0; r < rows; r++) {
        const double* irow = in + ioff;
        if (isv == 1) {
            std::memcpy(cur, irow, (size_t)L0 * sizeof(double));
        } else {
            for (int64_t i = 0; i < L0; i++) cur[i] = irow[i * isv];
        }
        for (size_t k = 0; k < steps; k++) {
            const double s = lam / (double)(k + 1);
            const int64_t L = Ls[k];
            const int64_t newL = newLs[k];
            if (discrete) {
                if (newL > 0)
                    nxt[0] = (L > 0 ? 0.0 + c * (cur[1] * 1.0) : 0.0) * s;
                for (int64_t i = 1; i < newL; i++) {
                    double t = cur[i] * (double)i;  // D[i-1]
                    if (i < L) t += c * (cur[i + 1] * (double)(i + 1));
                    nxt[i] = t * s;
                }
            } else {
                for (int64_t i = 0; i < newL; i++)
                    nxt[i] = (cur[i + 1] * (double)(i + 1)) * s;
            }
            std::swap(cur, nxt);
        }
        double* orow = out + ooff;
        if (osv == 1) {
            std::memcpy(orow, cur, (size_t)fin * sizeof(double));
        } else {
            for (int64_t i = 0; i < fin; i++) orow[i * osv] = cur[i];
        }
        // advance the odometer over the non-v axes (last axis fastest)
        for (Py_ssize_t d = (Py_ssize_t)nd - 1; d >= 0; d--) {
            if ((size_t)d == v) continue;
            ioff += istr[d];
            ooff += ostr[d];
            if (++idx[d] < shape[d]) break;
            idx[d] = 0;
            ioff -= istr[d] * shape[d];
            ooff -= ostr[d] * shape[d];
        }
    }
}

// Fused compound-Poisson observation chain (reference:
// src/generating_function.rs:684-694 -- the per-step 1/k! folding).
//
// in is a C-contiguous f64 tensor of the given shape; for every 1-D lane
// along axis v the whole `steps`-deep derivative chain runs in cache with
// double-buffered rows:
//
//   discrete:   R[i] = (lam/k) * (c*(i+1)*G[i+1] + i*G[i])
//   continuous: R[i] = (lam/k) * (i+1)*G[i+1]
//
// with per-step result lengths precomputed by the caller (Ls = derivative
// length after truncation, newLs = result length).  Results are written to
// the C-contiguous out tensor whose axis v has length newLs[last]; no
// transpose/copy passes are needed for any axis position.  The arithmetic
// association matches the numpy fused path in gf/ir.py:_fused_chain_f64
// bit-for-bit on finite inputs.
PyObject* py_obs_chain(PyObject*, PyObject* args) {
    PyObject *in_obj, *shape_obj, *out_obj, *ls_obj, *nls_obj;
    Py_ssize_t v;
    double lam, c;
    int discrete;
    if (!PyArg_ParseTuple(args, "OOnOddpOO", &in_obj, &shape_obj, &v,
                          &out_obj, &lam, &c, &discrete, &ls_obj, &nls_obj))
        return nullptr;
    BufView bin, bout;
    if (!get_f64_buffer(in_obj, &bin)) return nullptr;
    if (!get_f64_buffer(out_obj, &bout, /*writable=*/true)) return nullptr;
    std::vector<int64_t> shape, Ls, newLs;
    if (!parse_shape(shape_obj, &shape) || !parse_shape(ls_obj, &Ls) ||
        !parse_shape(nls_obj, &newLs))
        return nullptr;
    if (Ls.size() != newLs.size() || Ls.empty()) {
        PyErr_SetString(PyExc_ValueError, "Ls/newLs length mismatch/empty");
        return nullptr;
    }
    if (v < 0 || (size_t)v >= shape.size()) {
        PyErr_SetString(PyExc_ValueError, "axis out of range");
        return nullptr;
    }
    const size_t steps = Ls.size();
    const int64_t L0 = shape[v];
    for (size_t k = 0; k < steps; k++) {
        const int64_t cap = k == 0 ? L0 : newLs[k - 1];
        if (Ls[k] < 0 || Ls[k] >= cap || newLs[k] < 0 || newLs[k] > L0 ||
            (discrete ? newLs[k] < Ls[k] : newLs[k] != Ls[k])) {
            PyErr_SetString(PyExc_ValueError, "inconsistent step lengths");
            return nullptr;
        }
    }
    const int64_t fin = newLs[steps - 1];
    if (bin.len() < numel(shape)) {
        PyErr_SetString(PyExc_ValueError, "input buffer too small");
        return nullptr;
    }
    std::vector<int64_t> oshape(shape);
    oshape[(size_t)v] = fin;
    if (bout.len() < numel(oshape)) {
        PyErr_SetString(PyExc_ValueError, "output buffer too small");
        return nullptr;
    }
    Py_BEGIN_ALLOW_THREADS;
    chain_rows(bin.data(), bout.mut_data(), shape, (size_t)v, fin, lam, c,
               discrete, Ls.data(), newLs.data(), steps);
    Py_END_ALLOW_THREADS;
    Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"conv_trunc", py_conv_trunc, METH_VARARGS,
     "Truncated n-D Cauchy product (f64, C-contiguous buffers)."},
    {"obs_chain", py_obs_chain, METH_VARARGS,
     "Fused compound-Poisson observation derivative chain over rows."},
    {"subst_horner", py_subst_horner, METH_VARARGS,
     "Fused Horner substitution of a small series into one axis."},
    {"div_1d", py_div_1d, METH_VARARGS,
     "Power-series division along the leading axis with trailing lanes."},
    {"exp_1d", py_exp_1d, METH_VARARGS, "Power-series exp recurrence."},
    {"log_1d", py_log_1d, METH_VARARGS, "Power-series log recurrence."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "genfer_tpu_torch._seriesops",
                         "Native power-series kernels for genfer_tpu_torch.",
                         -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__seriesops(void) { return PyModule_Create(&moduledef); }
