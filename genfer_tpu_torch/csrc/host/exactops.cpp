// Exact-arithmetic scalar types and power-series kernels backed by the
// system GMP/MPFR libraries.
//
// The reference runs its exact modes on rug (GMP/MPFR bindings):
//   * --rational    reference: src/number/rational.rs (rug::Rational)
//   * --precision N reference: src/number/multi_precision.rs (rug::Float)
// This module supplies the same machinery for the rebuild's host runtime:
//
//   * `mpq`  - immutable arbitrary-precision rational scalar
//   * `mpfr` - immutable floating-point scalar at a global precision
//   * conv_mpq / div_mpq           - exact truncated Cauchy product and
//     power-series long division over flat arrays of `mpq`
//     (reference recursions: src/multivariate_taylor.rs:972-1012, 1162-1192)
//   * conv_mpfr / div_mpfr / exp_mpfr / log_mpfr - the same four kernels
//     over `mpfr` coefficients (multivariate_taylor.rs:1270-1386)
//
// The Cauchy product over rationals reduces to a common-denominator
// integer convolution (one gcd per *output* element instead of one per
// multiply-add), mirroring the optimization in
// genfer_tpu_torch/taylor/host.py:conv_trunc.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>
#include <new>
#include <string>
#include <vector>

#include "exactops_abi.h"

namespace {

// =====================================================================
// RAII helpers
// =====================================================================

struct Mpz {
    mpz_t z;
    Mpz() { mpz_init(z); }
    explicit Mpz(long v) { mpz_init_set_si(z, v); }
    ~Mpz() { mpz_clear(z); }
    Mpz(const Mpz&) = delete;
    Mpz& operator=(const Mpz&) = delete;
};

struct Mpq {
    mpq_t q;
    Mpq() { mpq_init(q); }
    ~Mpq() { mpq_clear(q); }
    Mpq(const Mpq&) = delete;
    Mpq& operator=(const Mpq&) = delete;
};

// arrays of mpz/mpq/mpfr with bulk init/clear
struct MpzArray {
    std::vector<__mpz_struct> v;
    explicit MpzArray(size_t n) : v(n) {
        for (auto& e : v) mpz_init(&e);
    }
    ~MpzArray() {
        for (auto& e : v) mpz_clear(&e);
    }
    mpz_ptr operator[](size_t i) { return &v[i]; }
};

struct MpqArray {
    std::vector<__mpq_struct> v;
    explicit MpqArray(size_t n) : v(n) {
        for (auto& e : v) mpq_init(&e);
    }
    ~MpqArray() {
        for (auto& e : v) mpq_clear(&e);
    }
    mpq_ptr operator[](size_t i) { return &v[i]; }
};

static mpfr_prec_t g_prec = 53;

struct MpfrArray {
    std::vector<__mpfr_struct> v;
    explicit MpfrArray(size_t n) : v(n) {
        for (auto& e : v) {
            mpfr_init2(&e, g_prec);
            mpfr_set_zero(&e, 1);
        }
    }
    ~MpfrArray() {
        for (auto& e : v) mpfr_clear(&e);
    }
    mpfr_ptr operator[](size_t i) { return &v[i]; }
};

// =====================================================================
// Python int <-> mpz
// =====================================================================

static PyObject* s_zero_long = nullptr;  // cached int(0)

// obj must be a PyLong; fills z. Returns false + Python error on failure.
static bool pylong_to_mpz(PyObject* obj, mpz_ptr z) {
    int overflow = 0;
    long v = PyLong_AsLongAndOverflow(obj, &overflow);
    if (!overflow) {
        if (v == -1 && PyErr_Occurred()) return false;
        mpz_set_si(z, v);
        return true;
    }
    // big integer: go through bytes (little-endian magnitude)
    PyObject* bl = PyObject_CallMethod(obj, "bit_length", nullptr);
    if (!bl) return false;
    size_t nbits = PyLong_AsSize_t(bl);
    Py_DECREF(bl);
    if (nbits == (size_t)-1 && PyErr_Occurred()) return false;
    size_t nbytes = nbits / 8 + 1;
    PyObject* absv = PyNumber_Absolute(obj);
    if (!absv) return false;
    PyObject* bytes =
        PyObject_CallMethod(absv, "to_bytes", "ns", (Py_ssize_t)nbytes, "little");
    Py_DECREF(absv);
    if (!bytes) return false;
    char* buf = nullptr;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(bytes, &buf, &len) != 0) {
        Py_DECREF(bytes);
        return false;
    }
    mpz_import(z, (size_t)len, -1, 1, 0, 0, buf);
    Py_DECREF(bytes);
    int neg = PyObject_RichCompareBool(obj, s_zero_long, Py_LT);
    if (neg < 0) return false;
    if (neg) mpz_neg(z, z);
    return true;
}

static PyObject* mpz_to_pylong(mpz_srcptr z) {
    if (mpz_fits_slong_p(z)) return PyLong_FromLong(mpz_get_si(z));
    size_t nbytes = (mpz_sizeinbase(z, 2) + 7) / 8;
    std::vector<unsigned char> buf(nbytes);
    size_t count = 0;
    mpz_export(buf.data(), &count, -1, 1, 0, 0, z);
    PyObject* bytes =
        PyBytes_FromStringAndSize((const char*)buf.data(), (Py_ssize_t)count);
    if (!bytes) return nullptr;
    PyObject* res = PyObject_CallMethod((PyObject*)&PyLong_Type, "from_bytes",
                                        "Os", bytes, "little");
    Py_DECREF(bytes);
    if (!res) return nullptr;
    if (mpz_sgn(z) < 0) {
        PyObject* negd = PyNumber_Negative(res);
        Py_DECREF(res);
        return negd;
    }
    return res;
}

// =====================================================================
// mpq scalar type
// =====================================================================

typedef struct {
    PyObject_HEAD
    mpq_t q;
} MpqObject;

static PyTypeObject MpqType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "genfer_tpu_torch._exactops.mpq",          /* tp_name */
    sizeof(MpqObject),                   /* tp_basicsize */
};

static inline bool Mpq_CheckObj(PyObject* o) {
    return PyObject_TypeCheck(o, &MpqType);
}

static MpqObject* mpq_alloc() {
    MpqObject* o = PyObject_New(MpqObject, &MpqType);
    if (o) mpq_init(o->q);
    return o;
}

static void Mpq_dealloc(MpqObject* self) {
    mpq_clear(self->q);
    PyObject_Free(self);
}

// Convert `o` to an mpq view. Returns:
//   1  -> *view points at the value (either borrowed from an MpqObject or
//         stored in *storage)
//   0  -> not convertible (caller returns NotImplemented)
//  -1  -> Python error set
static int as_mpq_view(PyObject* o, mpq_srcptr* view, Mpq& storage) {
    if (Mpq_CheckObj(o)) {
        *view = ((MpqObject*)o)->q;
        return 1;
    }
    if (PyLong_Check(o)) {
        if (!pylong_to_mpz(o, mpq_numref(storage.q))) return -1;
        mpz_set_si(mpq_denref(storage.q), 1);
        *view = storage.q;
        return 1;
    }
    // Fraction-like: has integer numerator/denominator attributes
    if (PyObject_HasAttrString(o, "numerator") &&
        PyObject_HasAttrString(o, "denominator") && !PyFloat_Check(o)) {
        PyObject* num = PyObject_GetAttrString(o, "numerator");
        if (!num) return -1;
        PyObject* den = PyObject_GetAttrString(o, "denominator");
        if (!den) {
            Py_DECREF(num);
            return -1;
        }
        bool ok = PyLong_Check(num) && PyLong_Check(den) &&
                  pylong_to_mpz(num, mpq_numref(storage.q)) &&
                  pylong_to_mpz(den, mpq_denref(storage.q));
        Py_DECREF(num);
        Py_DECREF(den);
        if (!ok) return PyErr_Occurred() ? -1 : 0;
        mpq_canonicalize(storage.q);
        *view = storage.q;
        return 1;
    }
    return 0;
}

static PyObject* Mpq_new(PyTypeObject*, PyObject* args, PyObject*) {
    PyObject* num = nullptr;
    PyObject* den = nullptr;
    if (!PyArg_ParseTuple(args, "|OO", &num, &den)) return nullptr;
    MpqObject* self = mpq_alloc();
    if (!self) return nullptr;
    if (num == nullptr) return (PyObject*)self;  // mpq() == 0
    if (den == nullptr) {
        if (Mpq_CheckObj(num)) {
            mpq_set(self->q, ((MpqObject*)num)->q);
            return (PyObject*)self;
        }
        if (PyFloat_Check(num)) {
            double d = PyFloat_AsDouble(num);
            if (d != d || d == (1.0 / 0.0) || d == (-1.0 / 0.0)) {
                Py_DECREF(self);
                PyErr_SetString(PyExc_ValueError,
                                "cannot convert non-finite float to mpq");
                return nullptr;
            }
            mpq_set_d(self->q, d);
            return (PyObject*)self;
        }
        if (PyUnicode_Check(num)) {
            const char* s = PyUnicode_AsUTF8(num);
            if (!s || mpq_set_str(self->q, s, 10) != 0 ||
                mpz_sgn(mpq_denref(self->q)) == 0) {
                Py_DECREF(self);
                if (!PyErr_Occurred())
                    PyErr_SetString(PyExc_ValueError, "invalid mpq string");
                return nullptr;
            }
            mpq_canonicalize(self->q);
            return (PyObject*)self;
        }
        mpq_srcptr v;
        Mpq tmp;
        int r = as_mpq_view(num, &v, tmp);
        if (r < 0) {
            Py_DECREF(self);
            return nullptr;
        }
        if (r == 0) {
            Py_DECREF(self);
            PyErr_Format(PyExc_TypeError, "cannot convert %s to mpq",
                         Py_TYPE(num)->tp_name);
            return nullptr;
        }
        mpq_set(self->q, v);
        return (PyObject*)self;
    }
    // two-argument form: mpq(num, den)
    mpq_srcptr vn;
    mpq_srcptr vd;
    Mpq tn, td;
    int rn = as_mpq_view(num, &vn, tn);
    int rd = as_mpq_view(den, &vd, td);
    if (rn < 0 || rd < 0) {
        Py_DECREF(self);
        return nullptr;
    }
    if (rn == 0 || rd == 0) {
        Py_DECREF(self);
        PyErr_SetString(PyExc_TypeError, "mpq(num, den) expects integers");
        return nullptr;
    }
    if (mpq_sgn(vd) == 0) {
        Py_DECREF(self);
        PyErr_SetString(PyExc_ZeroDivisionError, "mpq with zero denominator");
        return nullptr;
    }
    mpq_div(self->q, vn, vd);
    return (PyObject*)self;
}

#define MPQ_BINOP(name, op)                                               \
    static PyObject* Mpq_##name(PyObject* a, PyObject* b) {               \
        Mpq sa, sb;                                                       \
        mpq_srcptr va, vb;                                                \
        int ra = as_mpq_view(a, &va, sa);                                 \
        if (ra < 0) return nullptr;                                       \
        if (ra == 0) Py_RETURN_NOTIMPLEMENTED;                            \
        int rb = as_mpq_view(b, &vb, sb);                                 \
        if (rb < 0) return nullptr;                                       \
        if (rb == 0) Py_RETURN_NOTIMPLEMENTED;                            \
        MpqObject* r = mpq_alloc();                                       \
        if (!r) return nullptr;                                           \
        op(r->q, va, vb);                                                 \
        return (PyObject*)r;                                              \
    }

MPQ_BINOP(add, mpq_add)
MPQ_BINOP(sub, mpq_sub)
MPQ_BINOP(mul, mpq_mul)

static PyObject* Mpq_div(PyObject* a, PyObject* b) {
    Mpq sa, sb;
    mpq_srcptr va, vb;
    int ra = as_mpq_view(a, &va, sa);
    if (ra < 0) return nullptr;
    if (ra == 0) Py_RETURN_NOTIMPLEMENTED;
    int rb = as_mpq_view(b, &vb, sb);
    if (rb < 0) return nullptr;
    if (rb == 0) Py_RETURN_NOTIMPLEMENTED;
    if (mpq_sgn(vb) == 0) {
        PyErr_SetString(PyExc_ZeroDivisionError, "mpq division by zero");
        return nullptr;
    }
    MpqObject* r = mpq_alloc();
    if (!r) return nullptr;
    mpq_div(r->q, va, vb);
    return (PyObject*)r;
}

static PyObject* Mpq_neg(PyObject* a) {
    MpqObject* r = mpq_alloc();
    if (!r) return nullptr;
    mpq_neg(r->q, ((MpqObject*)a)->q);
    return (PyObject*)r;
}

static PyObject* Mpq_absfn(PyObject* a) {
    MpqObject* r = mpq_alloc();
    if (!r) return nullptr;
    mpq_abs(r->q, ((MpqObject*)a)->q);
    return (PyObject*)r;
}

static PyObject* Mpq_pow(PyObject* a, PyObject* e, PyObject* mod) {
    if (mod != Py_None || !Mpq_CheckObj(a) || !PyLong_Check(e))
        Py_RETURN_NOTIMPLEMENTED;
    long n = PyLong_AsLong(e);
    if (n == -1 && PyErr_Occurred()) return nullptr;
    mpq_srcptr base = ((MpqObject*)a)->q;
    bool invert = n < 0;
    unsigned long un = invert ? (unsigned long)(-(n + 1)) + 1ul : (unsigned long)n;
    if (invert && mpq_sgn(base) == 0) {
        PyErr_SetString(PyExc_ZeroDivisionError,
                        "0 cannot be raised to a negative power");
        return nullptr;
    }
    MpqObject* r = mpq_alloc();
    if (!r) return nullptr;
    mpz_pow_ui(mpq_numref(r->q), mpq_numref(base), un);
    mpz_pow_ui(mpq_denref(r->q), mpq_denref(base), un);
    if (invert) {
        mpz_swap(mpq_numref(r->q), mpq_denref(r->q));
        if (mpz_sgn(mpq_denref(r->q)) < 0) {
            mpz_neg(mpq_numref(r->q), mpq_numref(r->q));
            mpz_neg(mpq_denref(r->q), mpq_denref(r->q));
        }
    }
    return (PyObject*)r;
}

static PyObject* Mpq_float(PyObject* a) {
    return PyFloat_FromDouble(mpq_get_d(((MpqObject*)a)->q));
}

static int Mpq_bool(PyObject* a) {
    return mpq_sgn(((MpqObject*)a)->q) != 0;
}

static PyObject* Mpq_richcompare(PyObject* a, PyObject* b, int op) {
    Mpq sa, sb;
    mpq_srcptr va, vb;
    int ra = as_mpq_view(a, &va, sa);
    if (ra < 0) return nullptr;
    if (ra == 0) Py_RETURN_NOTIMPLEMENTED;
    int rb = as_mpq_view(b, &vb, sb);
    if (rb < 0) return nullptr;
    if (rb == 0) Py_RETURN_NOTIMPLEMENTED;
    int c;
    if (op == Py_EQ || op == Py_NE) {
        c = mpq_equal(va, vb) ? 0 : 1;
    } else {
        c = mpq_cmp(va, vb);
    }
    bool res = false;
    switch (op) {
        case Py_EQ: res = c == 0; break;
        case Py_NE: res = c != 0; break;
        case Py_LT: res = c < 0; break;
        case Py_LE: res = c <= 0; break;
        case Py_GT: res = c > 0; break;
        case Py_GE: res = c >= 0; break;
    }
    if (res) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

static Py_hash_t Mpq_hash(PyObject* self) {
    // CPython's numeric hash (matches fractions.Fraction.__hash__)
    mpq_srcptr q = ((MpqObject*)self)->q;
    const unsigned long MOD = ((unsigned long)1 << 61) - 1;  // _PyHASH_MODULUS
    Mpz P, dinv, n, h, e;
    mpz_set_si(P.z, (long)MOD);
    mpz_mod(n.z, mpq_denref(q), P.z);
    Py_hash_t base;
    if (mpz_sgn(n.z) == 0) {
        base = 314159;  // _PyHASH_INF
    } else {
        mpz_set_si(e.z, (long)(MOD - 2));
        mpz_powm(dinv.z, mpq_denref(q), e.z, P.z);
        mpz_abs(n.z, mpq_numref(q));
        mpz_mod(n.z, n.z, P.z);
        mpz_mul(h.z, n.z, dinv.z);
        mpz_mod(h.z, h.z, P.z);
        base = (Py_hash_t)mpz_get_si(h.z);
    }
    Py_hash_t r = mpq_sgn(q) < 0 ? -base : base;
    return r == -1 ? -2 : r;
}

static PyObject* Mpq_str(PyObject* self) {
    mpq_srcptr q = ((MpqObject*)self)->q;
    char* ns = mpz_get_str(nullptr, 10, mpq_numref(q));
    PyObject* res;
    if (mpz_cmp_si(mpq_denref(q), 1) == 0) {
        res = PyUnicode_FromString(ns);
    } else {
        char* ds = mpz_get_str(nullptr, 10, mpq_denref(q));
        res = PyUnicode_FromFormat("%s/%s", ns, ds);
        free(ds);
    }
    free(ns);
    return res;
}

static PyObject* Mpq_repr(PyObject* self) {
    PyObject* s = Mpq_str(self);
    if (!s) return nullptr;
    PyObject* r = PyUnicode_FromFormat("mpq(%U)", s);
    Py_DECREF(s);
    return r;
}

static PyObject* Mpq_get_numerator(MpqObject* self, void*) {
    return mpz_to_pylong(mpq_numref(self->q));
}

static PyObject* Mpq_get_denominator(MpqObject* self, void*) {
    return mpz_to_pylong(mpq_denref(self->q));
}

// exact square root: returns mpq or None when not a perfect square
// (reference: src/number/rational.rs:399-422)
static PyObject* Mpq_sqrt_exact(MpqObject* self, PyObject*) {
    if (mpq_sgn(self->q) < 0) Py_RETURN_NONE;
    Mpz sn, rn, sd, rd;
    mpz_sqrtrem(sn.z, rn.z, mpq_numref(self->q));
    mpz_sqrtrem(sd.z, rd.z, mpq_denref(self->q));
    if (mpz_sgn(rn.z) != 0 || mpz_sgn(rd.z) != 0) Py_RETURN_NONE;
    MpqObject* r = mpq_alloc();
    if (!r) return nullptr;
    mpz_set(mpq_numref(r->q), sn.z);
    mpz_set(mpq_denref(r->q), sd.z);
    return (PyObject*)r;
}

static PyGetSetDef Mpq_getset[] = {
    {"numerator", (getter)Mpq_get_numerator, nullptr, nullptr, nullptr},
    {"denominator", (getter)Mpq_get_denominator, nullptr, nullptr, nullptr},
    {nullptr, nullptr, nullptr, nullptr, nullptr},
};

static PyMethodDef Mpq_methods[] = {
    {"sqrt_exact", (PyCFunction)Mpq_sqrt_exact, METH_NOARGS,
     "Exact square root, or None if irrational."},
    {nullptr, nullptr, 0, nullptr},
};

static PyNumberMethods Mpq_as_number = {};

// =====================================================================
// mpfr scalar type
// =====================================================================

typedef struct {
    PyObject_HEAD
    mpfr_t f;
} MpfrObject;

static PyTypeObject MpfrType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "genfer_tpu_torch._exactops.mpfr",         /* tp_name */
    sizeof(MpfrObject),                  /* tp_basicsize */
};

static inline bool Mpfr_CheckObj(PyObject* o) {
    return PyObject_TypeCheck(o, &MpfrType);
}

static MpfrObject* mpfr_alloc() {
    MpfrObject* o = PyObject_New(MpfrObject, &MpfrType);
    if (o) mpfr_init2(o->f, g_prec);
    return o;
}

static void Mpfr_dealloc(MpfrObject* self) {
    mpfr_clear(self->f);
    PyObject_Free(self);
}

// Convert o to an mpfr view (exact for ints; NotImplemented for others).
static int as_mpfr_view(PyObject* o, mpfr_srcptr* view, MpfrObject** owned) {
    *owned = nullptr;
    if (Mpfr_CheckObj(o)) {
        *view = ((MpfrObject*)o)->f;
        return 1;
    }
    if (PyFloat_Check(o)) {
        MpfrObject* t = mpfr_alloc();
        if (!t) return -1;
        mpfr_set_d(t->f, PyFloat_AsDouble(o), MPFR_RNDN);
        *owned = t;
        *view = t->f;
        return 1;
    }
    if (PyLong_Check(o)) {
        Mpz z;
        if (!pylong_to_mpz(o, z.z)) return -1;
        MpfrObject* t = mpfr_alloc();
        if (!t) return -1;
        mpfr_set_z(t->f, z.z, MPFR_RNDN);
        *owned = t;
        *view = t->f;
        return 1;
    }
    return 0;
}

static PyObject* Mpfr_new(PyTypeObject*, PyObject* args, PyObject*) {
    PyObject* v = nullptr;
    if (!PyArg_ParseTuple(args, "|O", &v)) return nullptr;
    MpfrObject* self = mpfr_alloc();
    if (!self) return nullptr;
    if (v == nullptr) {
        mpfr_set_zero(self->f, 1);
        return (PyObject*)self;
    }
    if (Mpfr_CheckObj(v)) {
        mpfr_set(self->f, ((MpfrObject*)v)->f, MPFR_RNDN);
        return (PyObject*)self;
    }
    if (PyFloat_Check(v)) {
        mpfr_set_d(self->f, PyFloat_AsDouble(v), MPFR_RNDN);
        return (PyObject*)self;
    }
    if (PyLong_Check(v)) {
        Mpz z;
        if (!pylong_to_mpz(v, z.z)) {
            Py_DECREF(self);
            return nullptr;
        }
        mpfr_set_z(self->f, z.z, MPFR_RNDN);
        return (PyObject*)self;
    }
    if (Mpq_CheckObj(v)) {
        mpfr_set_q(self->f, ((MpqObject*)v)->q, MPFR_RNDN);
        return (PyObject*)self;
    }
    if (PyUnicode_Check(v)) {
        const char* s = PyUnicode_AsUTF8(v);
        if (!s || mpfr_set_str(self->f, s, 10, MPFR_RNDN) != 0) {
            Py_DECREF(self);
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_ValueError, "invalid mpfr string");
            return nullptr;
        }
        return (PyObject*)self;
    }
    // Fraction-like
    {
        Mpq tmp;
        mpq_srcptr view;
        int r = as_mpq_view(v, &view, tmp);
        if (r < 0) {
            Py_DECREF(self);
            return nullptr;
        }
        if (r == 1) {
            mpfr_set_q(self->f, view, MPFR_RNDN);
            return (PyObject*)self;
        }
    }
    Py_DECREF(self);
    PyErr_Format(PyExc_TypeError, "cannot convert %s to mpfr",
                 Py_TYPE(v)->tp_name);
    return nullptr;
}

#define MPFR_BINOP(name, op)                                                \
    static PyObject* Mpfr_##name(PyObject* a, PyObject* b) {                \
        mpfr_srcptr va, vb;                                                 \
        MpfrObject *oa = nullptr, *ob = nullptr;                            \
        int ra = as_mpfr_view(a, &va, &oa);                                 \
        if (ra < 0) return nullptr;                                         \
        if (ra == 0) Py_RETURN_NOTIMPLEMENTED;                              \
        int rb = as_mpfr_view(b, &vb, &ob);                                 \
        if (rb < 0) {                                                       \
            Py_XDECREF(oa);                                                 \
            return nullptr;                                                 \
        }                                                                   \
        if (rb == 0) {                                                      \
            Py_XDECREF(oa);                                                 \
            Py_RETURN_NOTIMPLEMENTED;                                       \
        }                                                                   \
        MpfrObject* r = mpfr_alloc();                                       \
        if (r) op(r->f, va, vb, MPFR_RNDN);                                 \
        Py_XDECREF(oa);                                                     \
        Py_XDECREF(ob);                                                     \
        return (PyObject*)r;                                                \
    }

MPFR_BINOP(add, mpfr_add)
MPFR_BINOP(sub, mpfr_sub)
MPFR_BINOP(mul, mpfr_mul)
MPFR_BINOP(div, mpfr_div)

static PyObject* Mpfr_neg(PyObject* a) {
    MpfrObject* r = mpfr_alloc();
    if (!r) return nullptr;
    mpfr_neg(r->f, ((MpfrObject*)a)->f, MPFR_RNDN);
    return (PyObject*)r;
}

static PyObject* Mpfr_absfn(PyObject* a) {
    MpfrObject* r = mpfr_alloc();
    if (!r) return nullptr;
    mpfr_abs(r->f, ((MpfrObject*)a)->f, MPFR_RNDN);
    return (PyObject*)r;
}

static PyObject* Mpfr_pow(PyObject* a, PyObject* e, PyObject* mod) {
    if (mod != Py_None || !Mpfr_CheckObj(a) || !PyLong_Check(e))
        Py_RETURN_NOTIMPLEMENTED;
    long n = PyLong_AsLong(e);
    if (n == -1 && PyErr_Occurred()) return nullptr;
    MpfrObject* r = mpfr_alloc();
    if (!r) return nullptr;
    mpfr_pow_si(r->f, ((MpfrObject*)a)->f, n, MPFR_RNDN);
    return (PyObject*)r;
}

static PyObject* Mpfr_float(PyObject* a) {
    return PyFloat_FromDouble(mpfr_get_d(((MpfrObject*)a)->f, MPFR_RNDN));
}

static int Mpfr_bool(PyObject* a) {
    return !mpfr_zero_p(((MpfrObject*)a)->f);
}

static PyObject* Mpfr_richcompare(PyObject* a, PyObject* b, int op) {
    mpfr_srcptr va, vb;
    MpfrObject *oa = nullptr, *ob = nullptr;
    int ra = as_mpfr_view(a, &va, &oa);
    if (ra < 0) return nullptr;
    if (ra == 0) Py_RETURN_NOTIMPLEMENTED;
    int rb = as_mpfr_view(b, &vb, &ob);
    if (rb < 0) {
        Py_XDECREF(oa);
        return nullptr;
    }
    if (rb == 0) {
        Py_XDECREF(oa);
        Py_RETURN_NOTIMPLEMENTED;
    }
    bool res = false;
    switch (op) {
        case Py_EQ: res = mpfr_equal_p(va, vb); break;
        case Py_NE: res = !mpfr_equal_p(va, vb) ; break;
        case Py_LT: res = mpfr_less_p(va, vb); break;
        case Py_LE: res = mpfr_lessequal_p(va, vb); break;
        case Py_GT: res = mpfr_greater_p(va, vb); break;
        case Py_GE: res = mpfr_greaterequal_p(va, vb); break;
    }
    // IEEE semantics: NaN != NaN is true, all ordered comparisons false
    if (op == Py_NE && (mpfr_nan_p(va) || mpfr_nan_p(vb))) res = true;
    Py_XDECREF(oa);
    Py_XDECREF(ob);
    if (res) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

static Py_hash_t Mpfr_hash(PyObject* self) {
    double d = mpfr_get_d(((MpfrObject*)self)->f, MPFR_RNDN);
    PyObject* f = PyFloat_FromDouble(d);
    if (!f) return -1;
    Py_hash_t h = PyObject_Hash(f);
    Py_DECREF(f);
    return h;
}

static PyObject* mpfr_format(mpfr_srcptr f, int digits) {
    if (mpfr_nan_p(f)) return PyUnicode_FromString("NaN");
    if (mpfr_inf_p(f))
        return PyUnicode_FromString(mpfr_signbit(f) ? "-inf" : "inf");
    char* s = nullptr;
    if (mpfr_asprintf(&s, "%.*Rg", digits, f) < 0) {
        PyErr_SetString(PyExc_RuntimeError, "mpfr_asprintf failed");
        return nullptr;
    }
    PyObject* res = PyUnicode_FromString(s);
    mpfr_free_str(s);
    return res;
}

static PyObject* Mpfr_str(PyObject* self) {
    int digits = (int)((double)g_prec * 0.30103) + 1;
    if (digits < 1) digits = 1;
    return mpfr_format(((MpfrObject*)self)->f, digits);
}

static PyObject* Mpfr_digits(MpfrObject* self, PyObject* arg) {
    long n = PyLong_AsLong(arg);
    if (n == -1 && PyErr_Occurred()) return nullptr;
    if (n < 1) n = 1;
    return mpfr_format(self->f, (int)n);
}

#define MPFR_UNARY_METHOD(name, op)                                    \
    static PyObject* Mpfr_##name(MpfrObject* self, PyObject*) {        \
        MpfrObject* r = mpfr_alloc();                                  \
        if (!r) return nullptr;                                        \
        op(r->f, self->f, MPFR_RNDN);                                  \
        return (PyObject*)r;                                           \
    }

MPFR_UNARY_METHOD(exp, mpfr_exp)
MPFR_UNARY_METHOD(log, mpfr_log)
MPFR_UNARY_METHOD(sqrt, mpfr_sqrt)

static PyObject* Mpfr_is_nan(MpfrObject* self, PyObject*) {
    return PyBool_FromLong(mpfr_nan_p(self->f));
}
static PyObject* Mpfr_is_inf(MpfrObject* self, PyObject*) {
    return PyBool_FromLong(mpfr_inf_p(self->f));
}
static PyObject* Mpfr_is_finite(MpfrObject* self, PyObject*) {
    return PyBool_FromLong(mpfr_number_p(self->f));
}

static PyObject* Mpfr_next_up(MpfrObject* self, PyObject*) {
    MpfrObject* r = mpfr_alloc();
    if (!r) return nullptr;
    mpfr_set(r->f, self->f, MPFR_RNDN);
    mpfr_nextabove(r->f);
    return (PyObject*)r;
}

static PyObject* Mpfr_next_down(MpfrObject* self, PyObject*) {
    MpfrObject* r = mpfr_alloc();
    if (!r) return nullptr;
    mpfr_set(r->f, self->f, MPFR_RNDN);
    mpfr_nextbelow(r->f);
    return (PyObject*)r;
}

static PyMethodDef Mpfr_methods[] = {
    {"exp", (PyCFunction)Mpfr_exp, METH_NOARGS, nullptr},
    {"log", (PyCFunction)Mpfr_log, METH_NOARGS, nullptr},
    {"sqrt", (PyCFunction)Mpfr_sqrt, METH_NOARGS, nullptr},
    {"is_nan", (PyCFunction)Mpfr_is_nan, METH_NOARGS, nullptr},
    {"is_inf", (PyCFunction)Mpfr_is_inf, METH_NOARGS, nullptr},
    {"is_finite", (PyCFunction)Mpfr_is_finite, METH_NOARGS, nullptr},
    {"next_up", (PyCFunction)Mpfr_next_up, METH_NOARGS, nullptr},
    {"next_down", (PyCFunction)Mpfr_next_down, METH_NOARGS, nullptr},
    {"digits", (PyCFunction)Mpfr_digits, METH_O,
     "Decimal string with the given number of significant digits."},
    {nullptr, nullptr, 0, nullptr},
};

static PyNumberMethods Mpfr_as_number = {};

// =====================================================================
// shape utilities for the kernels
// =====================================================================

struct Shape {
    std::vector<long> dims;
    long total() const {
        long t = 1;
        for (long d : dims) t *= d;
        return t;
    }
    int nd() const { return (int)dims.size(); }
    // row-major strides
    std::vector<long> strides() const {
        std::vector<long> st(dims.size(), 1);
        for (int i = (int)dims.size() - 2; i >= 0; i--)
            st[i] = st[i + 1] * dims[i + 1];
        return st;
    }
    Shape tail() const {
        Shape s;
        s.dims.assign(dims.begin() + 1, dims.end());
        return s;
    }
};

static bool parse_shape(PyObject* tup, Shape* out) {
    if (!PyTuple_Check(tup)) {
        PyErr_SetString(PyExc_TypeError, "shape must be a tuple");
        return false;
    }
    Py_ssize_t n = PyTuple_GET_SIZE(tup);
    out->dims.resize((size_t)n);
    for (Py_ssize_t i = 0; i < n; i++) {
        long v = PyLong_AsLong(PyTuple_GET_ITEM(tup, i));
        if (v == -1 && PyErr_Occurred()) return false;
        if (v < 0) {
            PyErr_SetString(PyExc_ValueError, "negative dimension");
            return false;
        }
        out->dims[(size_t)i] = v;
    }
    return true;
}

// iterate over all multi-indices of `shape`; calls fn(flat_offsets...) with
// the current index vector
struct Odometer {
    const Shape& shape;
    std::vector<long> idx;
    bool done;
    explicit Odometer(const Shape& s)
        : shape(s), idx(s.dims.size(), 0), done(s.total() == 0) {}
    bool next() {
        for (int d = (int)idx.size() - 1; d >= 0; d--) {
            if (++idx[(size_t)d] < shape.dims[(size_t)d]) return true;
            idx[(size_t)d] = 0;
        }
        done = true;
        return false;
    }
};

// extract a flat list of mpq element pointers
static bool mpq_list(PyObject* list, std::vector<mpq_srcptr>* out,
                     long expect) {
    if (!PyList_Check(list)) {
        PyErr_SetString(PyExc_TypeError, "expected a list");
        return false;
    }
    Py_ssize_t n = PyList_GET_SIZE(list);
    if (n != expect) {
        PyErr_Format(PyExc_ValueError, "expected %ld elements, got %zd",
                     expect, n);
        return false;
    }
    out->resize((size_t)n);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* e = PyList_GET_ITEM(list, i);
        if (!Mpq_CheckObj(e)) {
            PyErr_Format(PyExc_TypeError, "element %zd is not mpq", i);
            return false;
        }
        (*out)[(size_t)i] = ((MpqObject*)e)->q;
    }
    return true;
}

static bool mpfr_list(PyObject* list, std::vector<mpfr_srcptr>* out,
                      long expect) {
    if (!PyList_Check(list)) {
        PyErr_SetString(PyExc_TypeError, "expected a list");
        return false;
    }
    Py_ssize_t n = PyList_GET_SIZE(list);
    if (n != expect) {
        PyErr_Format(PyExc_ValueError, "expected %ld elements, got %zd",
                     expect, n);
        return false;
    }
    out->resize((size_t)n);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* e = PyList_GET_ITEM(list, i);
        if (!Mpfr_CheckObj(e)) {
            PyErr_Format(PyExc_TypeError, "element %zd is not mpfr", i);
            return false;
        }
        (*out)[(size_t)i] = ((MpfrObject*)e)->f;
    }
    return true;
}

static PyObject* mpq_array_to_list(MpqArray& arr, long n) {
    PyObject* out = PyList_New(n);
    if (!out) return nullptr;
    for (long i = 0; i < n; i++) {
        MpqObject* o = mpq_alloc();
        if (!o) {
            Py_DECREF(out);
            return nullptr;
        }
        mpq_set(o->q, arr[(size_t)i]);
        PyList_SET_ITEM(out, i, (PyObject*)o);
    }
    return out;
}

static PyObject* mpfr_array_to_list(MpfrArray& arr, long n) {
    PyObject* out = PyList_New(n);
    if (!out) return nullptr;
    for (long i = 0; i < n; i++) {
        MpfrObject* o = mpfr_alloc();
        if (!o) {
            Py_DECREF(out);
            return nullptr;
        }
        mpfr_set(o->f, arr[(size_t)i], MPFR_RNDN);
        PyList_SET_ITEM(out, i, (PyObject*)o);
    }
    return out;
}

// =====================================================================
// integer scatter convolution (core of conv_mpq)
// =====================================================================

// out[k] += sum_{i+j=k, valid} a[i] * b[j], all shapes row-major flat.
// `out` must be zero-initialized by the caller.
static void zconv_scatter(const __mpz_struct* a, const Shape& sa,
                          const __mpz_struct* b, const Shape& sb,
                          __mpz_struct* out, const Shape& so) {
    int nd = so.nd();
    if (nd == 0) {
        mpz_addmul(out, a, b);
        return;
    }
    std::vector<long> stb = sb.strides(), stc = so.strides();
    Odometer it(sa);
    if (it.done) return;
    std::vector<long> bounds((size_t)nd);
    // innermost axis handled as a contiguous run
    do {
        long oa = 0;
        {
            std::vector<long> sta = sa.strides();
            for (int d = 0; d < nd; d++) oa += it.idx[(size_t)d] * sta[(size_t)d];
        }
        const __mpz_struct* v = &a[oa];
        if (mpz_sgn(v) == 0) continue;
        bool empty = false;
        for (int d = 0; d < nd; d++) {
            bounds[(size_t)d] =
                std::min(sb.dims[(size_t)d], so.dims[(size_t)d] - it.idx[(size_t)d]);
            if (bounds[(size_t)d] <= 0) empty = true;
        }
        if (empty) continue;
        long base_c = 0;
        for (int d = 0; d < nd; d++) base_c += it.idx[(size_t)d] * stc[(size_t)d];
        // iterate over b indices within bounds
        std::vector<long> j((size_t)nd, 0);
        for (;;) {
            long boff = 0, coff = base_c;
            for (int d = 0; d < nd - 1; d++) {
                boff += j[(size_t)d] * stb[(size_t)d];
                coff += j[(size_t)d] * stc[(size_t)d];
            }
            long run = bounds[(size_t)(nd - 1)];
            for (long t = 0; t < run; t++) {
                mpz_addmul(&out[coff + t], v, &b[boff + t]);
            }
            // advance the outer dims
            int d = nd - 2;
            for (; d >= 0; d--) {
                if (++j[(size_t)d] < bounds[(size_t)d]) break;
                j[(size_t)d] = 0;
            }
            if (d < 0) break;
        }
    } while (it.next());
}

// =====================================================================
// mpq kernels
// =====================================================================

// direct mpq scatter conv; accumulates into out (caller zeroes)
static void qconv_scatter(const __mpq_struct* const* a, const Shape& sa,
                          const __mpq_struct* const* b, const Shape& sb,
                          __mpq_struct* out, const Shape& so, mpq_ptr tmp) {
    int nd = so.nd();
    if (nd == 0) {
        mpq_mul(tmp, a[0], b[0]);
        mpq_add(out, out, tmp);
        return;
    }
    std::vector<long> sta = sa.strides(), stb = sb.strides(), stc = so.strides();
    Odometer it(sa);
    if (it.done) return;
    std::vector<long> bounds((size_t)nd);
    do {
        long oa = 0;
        for (int d = 0; d < nd; d++) oa += it.idx[(size_t)d] * sta[(size_t)d];
        mpq_srcptr v = a[oa];
        if (mpq_sgn(v) == 0) continue;
        bool empty = false;
        for (int d = 0; d < nd; d++) {
            bounds[(size_t)d] =
                std::min(sb.dims[(size_t)d], so.dims[(size_t)d] - it.idx[(size_t)d]);
            if (bounds[(size_t)d] <= 0) empty = true;
        }
        if (empty) continue;
        long base_c = 0;
        for (int d = 0; d < nd; d++) base_c += it.idx[(size_t)d] * stc[(size_t)d];
        std::vector<long> j((size_t)nd, 0);
        for (;;) {
            long boff = 0, coff = base_c;
            for (int d = 0; d < nd - 1; d++) {
                boff += j[(size_t)d] * stb[(size_t)d];
                coff += j[(size_t)d] * stc[(size_t)d];
            }
            long run = bounds[(size_t)(nd - 1)];
            for (long t = 0; t < run; t++) {
                if (mpq_sgn(b[boff + t]) == 0) continue;
                mpq_mul(tmp, v, b[boff + t]);
                mpq_add(&out[coff + t], &out[coff + t], tmp);
            }
            int d = nd - 2;
            for (; d >= 0; d--) {
                if (++j[(size_t)d] < bounds[(size_t)d]) break;
                j[(size_t)d] = 0;
            }
            if (d < 0) break;
        }
    } while (it.next());
}

struct DivByZero {};

// power-series long division over mpq; mirrors Backend._div_generic
// (reference: multivariate_taylor.rs:1162-1192)
static void qdiv_rec(const __mpq_struct* const* xs, const Shape& sxs,
                     const __mpq_struct* const* ys, const Shape& sys,
                     __mpq_struct* out, const Shape& so, mpq_ptr tmp) {
    if (so.nd() == 0) {
        if (mpq_sgn(ys[0]) == 0) throw DivByZero{};
        mpq_div(out, xs[0], ys[0]);
        return;
    }
    Shape rest = so.tail();
    Shape restx = sxs.tail();
    Shape resty = sys.tail();
    long rest_total = rest.total();
    long restx_total = restx.total();
    long resty_total = resty.total();
    long n0 = so.dims[0];
    long lxs = sxs.dims[0];
    long lys = sys.dims[0];

    MpqArray cur((size_t)rest_total);
    std::vector<const __mpq_struct*> ptrs((size_t)rest_total);
    std::vector<const __mpq_struct*> yslice(
        (size_t)std::max<long>(resty_total, 1));
    std::vector<const __mpq_struct*> y0((size_t)resty_total);
    for (long i = 0; i < resty_total; i++) y0[(size_t)i] = ys[i];

    // map restx multi-index -> flat index in rest (zero-padded embed)
    std::vector<long> embed((size_t)std::max<long>(restx_total, 1));
    {
        std::vector<long> str = rest.strides();
        Odometer ox(restx);
        long i = 0;
        if (!ox.done) {
            do {
                long off = 0;
                for (int d = 0; d < restx.nd(); d++)
                    off += ox.idx[(size_t)d] * str[(size_t)d];
                embed[(size_t)i++] = off;
            } while (ox.next());
        }
    }

    for (long k = 0; k < n0; k++) {
        // cur = (k < lxs ? pad(xs[k]) : 0) - sum_j res[j] (*) ys[k-j]
        for (long i = 0; i < rest_total; i++) mpq_set_si(cur[(size_t)i], 0, 1);
        if (k < lxs) {
            const __mpq_struct* const* xrow = xs + k * restx_total;
            for (long i = 0; i < restx_total; i++) {
                mpq_set(cur[(size_t)embed[(size_t)i]], xrow[i]);
            }
        }
        long lo = std::max<long>(0, k + 1 - lys);
        if (lo < k) {
            // acc = sum_j res[j] conv ys[k-j]; cur -= acc
            MpqArray scratch((size_t)rest_total);
            for (long j = lo; j < k; j++) {
                for (long i = 0; i < rest_total; i++)
                    ptrs[(size_t)i] = &out[j * rest_total + i];
                for (long i = 0; i < resty_total; i++)
                    yslice[(size_t)i] = ys[(k - j) * resty_total + i];
                qconv_scatter(ptrs.data(), rest, yslice.data(), resty,
                              scratch[(size_t)0], rest, tmp);
            }
            for (long i = 0; i < rest_total; i++)
                mpq_sub(cur[(size_t)i], cur[(size_t)i], scratch[(size_t)i]);
        }
        // res[k] = cur / ys0 (recursive power-series division)
        for (long i = 0; i < rest_total; i++) ptrs[(size_t)i] = cur[(size_t)i];
        qdiv_rec(ptrs.data(), rest, y0.data(), resty, &out[k * rest_total],
                 rest, tmp);
    }
}

// conv_mpq(a, sa, b, sb, so) -> list[mpq]
static PyObject* py_conv_mpq(PyObject*, PyObject* args) {
    PyObject *alist, *blist, *satup, *sbtup, *sotup;
    if (!PyArg_ParseTuple(args, "OOOOO", &alist, &satup, &blist, &sbtup,
                          &sotup))
        return nullptr;
    Shape sa, sb, so;
    if (!parse_shape(satup, &sa) || !parse_shape(sbtup, &sb) ||
        !parse_shape(sotup, &so))
        return nullptr;
    std::vector<mpq_srcptr> a, b;
    if (!mpq_list(alist, &a, sa.total()) || !mpq_list(blist, &b, sb.total()))
        return nullptr;

    long na = sa.total(), nb = sb.total(), nc = so.total();
    MpzArray ai((size_t)na), bi((size_t)nb), ci((size_t)nc);
    Mpz da, db, den, t;

    Py_BEGIN_ALLOW_THREADS;
    // common denominators
    mpz_set_si(da.z, 1);
    for (long i = 0; i < na; i++) mpz_lcm(da.z, da.z, mpq_denref(a[(size_t)i]));
    mpz_set_si(db.z, 1);
    for (long i = 0; i < nb; i++) mpz_lcm(db.z, db.z, mpq_denref(b[(size_t)i]));
    // scale numerators to the common denominator
    for (long i = 0; i < na; i++) {
        mpz_divexact(t.z, da.z, mpq_denref(a[(size_t)i]));
        mpz_mul(ai[(size_t)i], mpq_numref(a[(size_t)i]), t.z);
    }
    for (long i = 0; i < nb; i++) {
        mpz_divexact(t.z, db.z, mpq_denref(b[(size_t)i]));
        mpz_mul(bi[(size_t)i], mpq_numref(b[(size_t)i]), t.z);
    }
    zconv_scatter(ai[(size_t)0], sa, bi[(size_t)0], sb, ci[(size_t)0], so);
    mpz_mul(den.z, da.z, db.z);
    Py_END_ALLOW_THREADS;

    // build canonical mpq outputs
    PyObject* out = PyList_New(nc);
    if (!out) return nullptr;
    for (long i = 0; i < nc; i++) {
        MpqObject* o = mpq_alloc();
        if (!o) {
            Py_DECREF(out);
            return nullptr;
        }
        if (mpz_sgn(ci[(size_t)i]) != 0) {
            mpq_set_num(o->q, ci[(size_t)i]);
            mpq_set_den(o->q, den.z);
            mpq_canonicalize(o->q);
        }
        PyList_SET_ITEM(out, i, (PyObject*)o);
    }
    return out;
}

// div_mpq(xs, sxs, ys, sys, so) -> list[mpq]; raises ZeroDivisionError if a
// leading divisor coefficient is zero (caller falls back to the Python path
// that produces Rational specials)
static PyObject* py_div_mpq(PyObject*, PyObject* args) {
    PyObject *xlist, *ylist, *sxtup, *sytup, *sotup;
    if (!PyArg_ParseTuple(args, "OOOOO", &xlist, &sxtup, &ylist, &sytup,
                          &sotup))
        return nullptr;
    Shape sxs, sys, so;
    if (!parse_shape(sxtup, &sxs) || !parse_shape(sytup, &sys) ||
        !parse_shape(sotup, &so))
        return nullptr;
    std::vector<mpq_srcptr> xs, ys;
    if (!mpq_list(xlist, &xs, sxs.total()) ||
        !mpq_list(ylist, &ys, sys.total()))
        return nullptr;
    long nc = so.total();
    MpqArray res((size_t)nc);
    Mpq tmp;
    bool divzero = false;
    Py_BEGIN_ALLOW_THREADS;
    try {
        qdiv_rec(xs.data(), sxs, ys.data(), sys, res[(size_t)0], so, tmp.q);
    } catch (DivByZero&) {
        divzero = true;
    }
    Py_END_ALLOW_THREADS;
    if (divzero) {
        PyErr_SetString(PyExc_ZeroDivisionError,
                        "zero leading coefficient in power-series division");
        return nullptr;
    }
    return mpq_array_to_list(res, nc);
}

// =====================================================================
// mpfr kernels
// =====================================================================

static void fconv_scatter(const __mpfr_struct* const* a, const Shape& sa,
                          const __mpfr_struct* const* b, const Shape& sb,
                          __mpfr_struct* out, const Shape& so) {
    int nd = so.nd();
    if (nd == 0) {
        mpfr_fma(out, a[0], b[0], out, MPFR_RNDN);
        return;
    }
    std::vector<long> sta = sa.strides(), stb = sb.strides(), stc = so.strides();
    Odometer it(sa);
    if (it.done) return;
    std::vector<long> bounds((size_t)nd);
    do {
        long oa = 0;
        for (int d = 0; d < nd; d++) oa += it.idx[(size_t)d] * sta[(size_t)d];
        mpfr_srcptr v = a[oa];
        if (mpfr_zero_p(v)) continue;
        bool empty = false;
        for (int d = 0; d < nd; d++) {
            bounds[(size_t)d] =
                std::min(sb.dims[(size_t)d], so.dims[(size_t)d] - it.idx[(size_t)d]);
            if (bounds[(size_t)d] <= 0) empty = true;
        }
        if (empty) continue;
        long base_c = 0;
        for (int d = 0; d < nd; d++) base_c += it.idx[(size_t)d] * stc[(size_t)d];
        std::vector<long> j((size_t)nd, 0);
        for (;;) {
            long boff = 0, coff = base_c;
            for (int d = 0; d < nd - 1; d++) {
                boff += j[(size_t)d] * stb[(size_t)d];
                coff += j[(size_t)d] * stc[(size_t)d];
            }
            long run = bounds[(size_t)(nd - 1)];
            for (long t = 0; t < run; t++) {
                mpfr_fma(&out[coff + t], v, b[boff + t], &out[coff + t],
                         MPFR_RNDN);
            }
            int d = nd - 2;
            for (; d >= 0; d--) {
                if (++j[(size_t)d] < bounds[(size_t)d]) break;
                j[(size_t)d] = 0;
            }
            if (d < 0) break;
        }
    } while (it.next());
}

// recursive power-series division (IEEE semantics: div by zero -> inf/nan)
static void fdiv_rec(const __mpfr_struct* const* xs, const Shape& sxs,
                     const __mpfr_struct* const* ys, const Shape& sys,
                     __mpfr_struct* out, const Shape& so) {
    if (so.nd() == 0) {
        mpfr_div(out, xs[0], ys[0], MPFR_RNDN);
        return;
    }
    Shape rest = so.tail();
    Shape restx = sxs.tail();
    Shape resty = sys.tail();
    long rest_total = rest.total();
    long restx_total = restx.total();
    long resty_total = resty.total();
    long n0 = so.dims[0], lxs = sxs.dims[0], lys = sys.dims[0];

    MpfrArray cur((size_t)rest_total);
    std::vector<const __mpfr_struct*> ptrs((size_t)rest_total);
    std::vector<const __mpfr_struct*> yslice(
        (size_t)std::max<long>(resty_total, 1));
    std::vector<const __mpfr_struct*> y0((size_t)resty_total);
    for (long i = 0; i < resty_total; i++) y0[(size_t)i] = ys[i];

    std::vector<long> embed((size_t)std::max<long>(restx_total, 1));
    {
        std::vector<long> str = rest.strides();
        Odometer ox(restx);
        long i = 0;
        if (!ox.done) {
            do {
                long off = 0;
                for (int d = 0; d < restx.nd(); d++)
                    off += ox.idx[(size_t)d] * str[(size_t)d];
                embed[(size_t)i++] = off;
            } while (ox.next());
        }
    }

    for (long k = 0; k < n0; k++) {
        for (long i = 0; i < rest_total; i++)
            mpfr_set_zero(cur[(size_t)i], 1);
        if (k < lxs) {
            const __mpfr_struct* const* xrow = xs + k * restx_total;
            for (long i = 0; i < restx_total; i++)
                mpfr_set(cur[(size_t)embed[(size_t)i]], xrow[i], MPFR_RNDN);
        }
        long lo = std::max<long>(0, k + 1 - lys);
        if (lo < k) {
            MpfrArray scratch((size_t)rest_total);
            for (long j = lo; j < k; j++) {
                for (long i = 0; i < rest_total; i++)
                    ptrs[(size_t)i] = &out[j * rest_total + i];
                for (long i = 0; i < resty_total; i++)
                    yslice[(size_t)i] = ys[(k - j) * resty_total + i];
                fconv_scatter(ptrs.data(), rest, yslice.data(), resty,
                              scratch[(size_t)0], rest);
            }
            for (long i = 0; i < rest_total; i++)
                mpfr_sub(cur[(size_t)i], cur[(size_t)i], scratch[(size_t)i],
                         MPFR_RNDN);
        }
        for (long i = 0; i < rest_total; i++) ptrs[(size_t)i] = cur[(size_t)i];
        fdiv_rec(ptrs.data(), rest, y0.data(), resty, &out[k * rest_total],
                 rest);
    }
}

// power-series exp (reference recurrence multivariate_taylor.rs:1270-1317):
// res[0] = exp(xs[0]); res[k] = (sum_{j>=1} j*xs[j] (*) res[k-j]) / k
static void fexp_rec(const __mpfr_struct* const* xs, const Shape& sxs,
                     __mpfr_struct* out, const Shape& so) {
    if (so.nd() == 0) {
        mpfr_exp(out, xs[0], MPFR_RNDN);
        return;
    }
    Shape rest = so.tail();
    Shape restx = sxs.tail();
    long rest_total = rest.total();
    long restx_total = restx.total();
    long n0 = so.dims[0], lxs = sxs.dims[0];

    std::vector<const __mpfr_struct*> ptrs((size_t)rest_total);
    std::vector<const __mpfr_struct*> xrow((size_t)std::max<long>(restx_total, 1));

    // res[0] = exp_rec(xs[0])
    for (long i = 0; i < restx_total; i++) xrow[(size_t)i] = xs[i];
    fexp_rec(xrow.data(), restx, out, rest);

    MpfrArray jx((size_t)restx_total);  // j * xs[j]
    MpfrArray acc((size_t)rest_total);
    for (long k = 1; k < n0; k++) {
        for (long i = 0; i < rest_total; i++)
            mpfr_set_zero(acc[(size_t)i], 1);
        long hi = std::min(lxs, k + 1);
        for (long j = 1; j < hi; j++) {
            for (long i = 0; i < restx_total; i++)
                mpfr_mul_ui(jx[(size_t)i], xs[j * restx_total + i],
                            (unsigned long)j, MPFR_RNDN);
            std::vector<const __mpfr_struct*> jxp((size_t)restx_total);
            for (long i = 0; i < restx_total; i++) jxp[(size_t)i] = jx[(size_t)i];
            for (long i = 0; i < rest_total; i++)
                ptrs[(size_t)i] = &out[(k - j) * rest_total + i];
            fconv_scatter(jxp.data(), restx, ptrs.data(), rest,
                          acc[(size_t)0], rest);
        }
        for (long i = 0; i < rest_total; i++)
            mpfr_div_ui(&out[k * rest_total + i], acc[(size_t)i],
                        (unsigned long)k, MPFR_RNDN);
    }
}

// power-series log (reference recurrence multivariate_taylor.rs:1319-1386):
// res[0] = log(xs[0]);
// res[k] = ((k*xs[k] - sum_{j=lo}^{k-1} xs[k-j] (*) j*res[j]) / xs[0]) / k
static void flog_rec(const __mpfr_struct* const* xs, const Shape& sxs,
                     __mpfr_struct* out, const Shape& so) {
    if (so.nd() == 0) {
        mpfr_log(out, xs[0], MPFR_RNDN);
        return;
    }
    Shape rest = so.tail();
    Shape restx = sxs.tail();
    long rest_total = rest.total();
    long restx_total = restx.total();
    long n0 = so.dims[0], lxs = sxs.dims[0];

    std::vector<const __mpfr_struct*> x0((size_t)restx_total);
    for (long i = 0; i < restx_total; i++) x0[(size_t)i] = xs[i];

    flog_rec(x0.data(), restx, out, rest);

    std::vector<long> embed((size_t)std::max<long>(restx_total, 1));
    {
        std::vector<long> str = rest.strides();
        Odometer ox(restx);
        long i = 0;
        if (!ox.done) {
            do {
                long off = 0;
                for (int d = 0; d < restx.nd(); d++)
                    off += ox.idx[(size_t)d] * str[(size_t)d];
                embed[(size_t)i++] = off;
            } while (ox.next());
        }
    }

    MpfrArray cur((size_t)rest_total);
    MpfrArray jres((size_t)rest_total);
    std::vector<const __mpfr_struct*> ptrs((size_t)rest_total);
    std::vector<const __mpfr_struct*> xslice((size_t)restx_total);
    for (long k = 1; k < n0; k++) {
        for (long i = 0; i < rest_total; i++)
            mpfr_set_zero(cur[(size_t)i], 1);
        if (k < lxs) {
            const __mpfr_struct* const* xrow = xs + k * restx_total;
            for (long i = 0; i < restx_total; i++)
                mpfr_mul_ui(cur[(size_t)embed[(size_t)i]], xrow[i],
                            (unsigned long)k, MPFR_RNDN);
        }
        long lo = std::max<long>(1, k + 1 - lxs);
        if (lo < k) {
            // cur -= sum_j xs[k-j] (*) (j * res[j])
            MpfrArray scratch((size_t)rest_total);
            for (long j = lo; j < k; j++) {
                for (long i = 0; i < rest_total; i++)
                    mpfr_mul_ui(jres[(size_t)i], &out[j * rest_total + i],
                                (unsigned long)j, MPFR_RNDN);
                for (long i = 0; i < restx_total; i++)
                    xslice[(size_t)i] = xs[(k - j) * restx_total + i];
                for (long i = 0; i < rest_total; i++)
                    ptrs[(size_t)i] = jres[(size_t)i];
                fconv_scatter(xslice.data(), restx, ptrs.data(), rest,
                              scratch[(size_t)0], rest);
            }
            for (long i = 0; i < rest_total; i++)
                mpfr_sub(cur[(size_t)i], cur[(size_t)i], scratch[(size_t)i],
                         MPFR_RNDN);
        }
        // cur = cur / xs0 (power-series division), then /k
        for (long i = 0; i < rest_total; i++) ptrs[(size_t)i] = cur[(size_t)i];
        fdiv_rec(ptrs.data(), rest, x0.data(), restx, &out[k * rest_total],
                 rest);
        for (long i = 0; i < rest_total; i++)
            mpfr_div_ui(&out[k * rest_total + i], &out[k * rest_total + i],
                        (unsigned long)k, MPFR_RNDN);
    }
}

static PyObject* py_conv_mpfr(PyObject*, PyObject* args) {
    PyObject *alist, *blist, *satup, *sbtup, *sotup;
    if (!PyArg_ParseTuple(args, "OOOOO", &alist, &satup, &blist, &sbtup,
                          &sotup))
        return nullptr;
    Shape sa, sb, so;
    if (!parse_shape(satup, &sa) || !parse_shape(sbtup, &sb) ||
        !parse_shape(sotup, &so))
        return nullptr;
    std::vector<mpfr_srcptr> a, b;
    if (!mpfr_list(alist, &a, sa.total()) || !mpfr_list(blist, &b, sb.total()))
        return nullptr;
    long nc = so.total();
    MpfrArray out((size_t)nc);
    Py_BEGIN_ALLOW_THREADS;
    fconv_scatter(a.data(), sa, b.data(), sb, out[(size_t)0], so);
    Py_END_ALLOW_THREADS;
    return mpfr_array_to_list(out, nc);
}

static PyObject* py_div_mpfr(PyObject*, PyObject* args) {
    PyObject *xlist, *ylist, *sxtup, *sytup, *sotup;
    if (!PyArg_ParseTuple(args, "OOOOO", &xlist, &sxtup, &ylist, &sytup,
                          &sotup))
        return nullptr;
    Shape sxs, sys, so;
    if (!parse_shape(sxtup, &sxs) || !parse_shape(sytup, &sys) ||
        !parse_shape(sotup, &so))
        return nullptr;
    std::vector<mpfr_srcptr> xs, ys;
    if (!mpfr_list(xlist, &xs, sxs.total()) ||
        !mpfr_list(ylist, &ys, sys.total()))
        return nullptr;
    long nc = so.total();
    MpfrArray out((size_t)nc);
    Py_BEGIN_ALLOW_THREADS;
    fdiv_rec(xs.data(), sxs, ys.data(), sys, out[(size_t)0], so);
    Py_END_ALLOW_THREADS;
    return mpfr_array_to_list(out, nc);
}

static PyObject* py_exp_mpfr(PyObject*, PyObject* args) {
    PyObject *xlist, *sxtup, *sotup;
    if (!PyArg_ParseTuple(args, "OOO", &xlist, &sxtup, &sotup)) return nullptr;
    Shape sxs, so;
    if (!parse_shape(sxtup, &sxs) || !parse_shape(sotup, &so)) return nullptr;
    std::vector<mpfr_srcptr> xs;
    if (!mpfr_list(xlist, &xs, sxs.total())) return nullptr;
    long nc = so.total();
    MpfrArray out((size_t)nc);
    Py_BEGIN_ALLOW_THREADS;
    fexp_rec(xs.data(), sxs, out[(size_t)0], so);
    Py_END_ALLOW_THREADS;
    return mpfr_array_to_list(out, nc);
}

static PyObject* py_log_mpfr(PyObject*, PyObject* args) {
    PyObject *xlist, *sxtup, *sotup;
    if (!PyArg_ParseTuple(args, "OOO", &xlist, &sxtup, &sotup)) return nullptr;
    Shape sxs, so;
    if (!parse_shape(sxtup, &sxs) || !parse_shape(sotup, &so)) return nullptr;
    std::vector<mpfr_srcptr> xs;
    if (!mpfr_list(xlist, &xs, sxs.total())) return nullptr;
    long nc = so.total();
    MpfrArray out((size_t)nc);
    Py_BEGIN_ALLOW_THREADS;
    flog_rec(xs.data(), sxs, out[(size_t)0], so);
    Py_END_ALLOW_THREADS;
    return mpfr_array_to_list(out, nc);
}

// =====================================================================
// elementwise kernels over numpy object-array buffers
// =====================================================================
//
// The object backend's hot loops (TensorPoly add/sub/mul/neg, derivative
// scaling) are elementwise maps over object arrays of mpq/mpfr payloads;
// np.frompyfunc costs ~0.5us/element in Python dispatch.  These kernels
// walk the buffers directly (strided, so np.broadcast_to views work) and
// return None when an element is not a payload (caller falls back to the
// Python path that understands special values).

struct ObjBuf {
    Py_buffer view{};
    bool ok = false;
    ~ObjBuf() {
        if (ok) PyBuffer_Release(&view);
    }
};

static bool get_obj_buffer(PyObject* o, ObjBuf* out, bool writable) {
    int flags = PyBUF_STRIDES | PyBUF_FORMAT;
    if (writable) flags |= PyBUF_WRITABLE;
    if (PyObject_GetBuffer(o, &out->view, flags) != 0) return false;
    out->ok = true;
    if (out->view.itemsize != (Py_ssize_t)sizeof(PyObject*) ||
        !out->view.format || strcmp(out->view.format, "O") != 0) {
        PyErr_SetString(PyExc_TypeError, "expected an object array");
        return false;
    }
    return true;
}

// iterate three same-shape buffers (a, b may be broadcast views with zero
// strides); calls fn(pa, pb, pout) for each element; fn returns false to
// abort (non-payload element)
template <typename F>
static int ew_iterate(const Py_buffer& a, const Py_buffer& b,
                      const Py_buffer& o, F&& fn) {
    int nd = o.ndim;
    for (int d = 0; d < nd; d++) {
        if ((a.shape && a.shape[d] != o.shape[d]) ||
            (b.shape && b.shape[d] != o.shape[d])) {
            PyErr_SetString(PyExc_ValueError, "shape mismatch");
            return -1;
        }
    }
    std::vector<Py_ssize_t> idx((size_t)nd, 0);
    const char* pa = (const char*)a.buf;
    const char* pb = (const char*)b.buf;
    char* po = (char*)o.buf;
    Py_ssize_t total = 1;
    for (int d = 0; d < nd; d++) total *= o.shape[d];
    for (Py_ssize_t n = 0; n < total; n++) {
        if (!fn(*(PyObject* const*)pa, *(PyObject* const*)pb,
                (PyObject**)po))
            return 0;
        // odometer advance
        for (int d = nd - 1; d >= 0; d--) {
            idx[(size_t)d]++;
            pa += a.strides[d];
            pb += b.strides[d];
            po += o.strides[d];
            if (idx[(size_t)d] < o.shape[d]) break;
            idx[(size_t)d] = 0;
            pa -= a.strides[d] * o.shape[d];
            pb -= b.strides[d] * o.shape[d];
            po -= o.strides[d] * o.shape[d];
        }
    }
    return 1;
}

static void store_obj(PyObject** slot, PyObject* val) {
    PyObject* old = *slot;
    *slot = val;
    Py_XDECREF(old);
}

// ew_mpq(op, a, b, out) -> True | None; op: 0 add, 1 sub, 2 mul
static PyObject* py_ew_mpq(PyObject*, PyObject* args) {
    int op = 0;
    PyObject *ao, *bo, *oo;
    if (!PyArg_ParseTuple(args, "iOOO", &op, &ao, &bo, &oo)) return nullptr;
    ObjBuf a, b, o;
    if (!get_obj_buffer(ao, &a, false) || !get_obj_buffer(bo, &b, false) ||
        !get_obj_buffer(oo, &o, true))
        return nullptr;
    int rc = ew_iterate(a.view, b.view, o.view,
                        [op](PyObject* x, PyObject* y, PyObject** slot) {
                            if (!Mpq_CheckObj(x) || !Mpq_CheckObj(y))
                                return false;
                            MpqObject* r = mpq_alloc();
                            if (!r) return false;
                            mpq_srcptr qx = ((MpqObject*)x)->q;
                            mpq_srcptr qy = ((MpqObject*)y)->q;
                            if (op == 0)
                                mpq_add(r->q, qx, qy);
                            else if (op == 1)
                                mpq_sub(r->q, qx, qy);
                            else
                                mpq_mul(r->q, qx, qy);
                            store_obj(slot, (PyObject*)r);
                            return true;
                        });
    if (rc < 0 || PyErr_Occurred()) return nullptr;
    if (rc == 0) Py_RETURN_NONE;
    Py_RETURN_TRUE;
}

static PyObject* py_ew_mpfr(PyObject*, PyObject* args) {
    int op = 0;
    PyObject *ao, *bo, *oo;
    if (!PyArg_ParseTuple(args, "iOOO", &op, &ao, &bo, &oo)) return nullptr;
    ObjBuf a, b, o;
    if (!get_obj_buffer(ao, &a, false) || !get_obj_buffer(bo, &b, false) ||
        !get_obj_buffer(oo, &o, true))
        return nullptr;
    int rc = ew_iterate(a.view, b.view, o.view,
                        [op](PyObject* x, PyObject* y, PyObject** slot) {
                            if (!Mpfr_CheckObj(x) || !Mpfr_CheckObj(y))
                                return false;
                            MpfrObject* r = mpfr_alloc();
                            if (!r) return false;
                            mpfr_srcptr fx = ((MpfrObject*)x)->f;
                            mpfr_srcptr fy = ((MpfrObject*)y)->f;
                            if (op == 0)
                                mpfr_add(r->f, fx, fy, MPFR_RNDN);
                            else if (op == 1)
                                mpfr_sub(r->f, fx, fy, MPFR_RNDN);
                            else
                                mpfr_mul(r->f, fx, fy, MPFR_RNDN);
                            store_obj(slot, (PyObject*)r);
                            return true;
                        });
    if (rc < 0 || PyErr_Occurred()) return nullptr;
    if (rc == 0) Py_RETURN_NONE;
    Py_RETURN_TRUE;
}

// ew_neg_mpq(a, out) / ew_neg_mpfr(a, out) -> True | None
static PyObject* py_ew_neg_mpq(PyObject*, PyObject* args) {
    PyObject *ao, *oo;
    if (!PyArg_ParseTuple(args, "OO", &ao, &oo)) return nullptr;
    ObjBuf a, o;
    if (!get_obj_buffer(ao, &a, false) || !get_obj_buffer(oo, &o, true))
        return nullptr;
    int rc = ew_iterate(a.view, a.view, o.view,
                        [](PyObject* x, PyObject*, PyObject** slot) {
                            if (!Mpq_CheckObj(x)) return false;
                            MpqObject* r = mpq_alloc();
                            if (!r) return false;
                            mpq_neg(r->q, ((MpqObject*)x)->q);
                            store_obj(slot, (PyObject*)r);
                            return true;
                        });
    if (rc < 0 || PyErr_Occurred()) return nullptr;
    if (rc == 0) Py_RETURN_NONE;
    Py_RETURN_TRUE;
}

static PyObject* py_ew_neg_mpfr(PyObject*, PyObject* args) {
    PyObject *ao, *oo;
    if (!PyArg_ParseTuple(args, "OO", &ao, &oo)) return nullptr;
    ObjBuf a, o;
    if (!get_obj_buffer(ao, &a, false) || !get_obj_buffer(oo, &o, true))
        return nullptr;
    int rc = ew_iterate(a.view, a.view, o.view,
                        [](PyObject* x, PyObject*, PyObject** slot) {
                            if (!Mpfr_CheckObj(x)) return false;
                            MpfrObject* r = mpfr_alloc();
                            if (!r) return false;
                            mpfr_neg(r->f, ((MpfrObject*)x)->f, MPFR_RNDN);
                            store_obj(slot, (PyObject*)r);
                            return true;
                        });
    if (rc < 0 || PyErr_Occurred()) return nullptr;
    if (rc == 0) Py_RETURN_NONE;
    Py_RETURN_TRUE;
}

// =====================================================================
// precision control
// =====================================================================

static PyObject* py_set_precision(PyObject*, PyObject* arg) {
    long bits = PyLong_AsLong(arg);
    if (bits == -1 && PyErr_Occurred()) return nullptr;
    if (bits < 2 || bits > (1l << 30)) {
        PyErr_SetString(PyExc_ValueError, "precision out of range");
        return nullptr;
    }
    g_prec = (mpfr_prec_t)bits;
    Py_RETURN_NONE;
}

static PyObject* py_get_precision(PyObject*, PyObject*) {
    return PyLong_FromLong((long)g_prec);
}

// =====================================================================
// module
// =====================================================================

static PyMethodDef module_methods[] = {
    {"conv_mpq", py_conv_mpq, METH_VARARGS,
     "conv_mpq(a, sa, b, sb, so) -> exact truncated Cauchy product"},
    {"div_mpq", py_div_mpq, METH_VARARGS,
     "div_mpq(xs, sxs, ys, sys, so) -> exact power-series division"},
    {"conv_mpfr", py_conv_mpfr, METH_VARARGS,
     "conv_mpfr(a, sa, b, sb, so) -> truncated Cauchy product"},
    {"div_mpfr", py_div_mpfr, METH_VARARGS,
     "div_mpfr(xs, sxs, ys, sys, so) -> power-series division"},
    {"exp_mpfr", py_exp_mpfr, METH_VARARGS,
     "exp_mpfr(xs, sxs, so) -> power-series exp"},
    {"log_mpfr", py_log_mpfr, METH_VARARGS,
     "log_mpfr(xs, sxs, so) -> power-series log"},
    {"ew_mpq", py_ew_mpq, METH_VARARGS,
     "ew_mpq(op, a, b, out) -> True|None; op: 0 add, 1 sub, 2 mul"},
    {"ew_mpfr", py_ew_mpfr, METH_VARARGS,
     "ew_mpfr(op, a, b, out) -> True|None; op: 0 add, 1 sub, 2 mul"},
    {"ew_neg_mpq", py_ew_neg_mpq, METH_VARARGS,
     "ew_neg_mpq(a, out) -> True|None"},
    {"ew_neg_mpfr", py_ew_neg_mpfr, METH_VARARGS,
     "ew_neg_mpfr(a, out) -> True|None"},
    {"set_precision", py_set_precision, METH_O,
     "Set the global mpfr precision in bits."},
    {"get_precision", py_get_precision, METH_NOARGS,
     "Get the global mpfr precision in bits."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef exactops_module = {
    PyModuleDef_HEAD_INIT,
    "genfer_tpu_torch._exactops",
    "GMP/MPFR-backed exact scalars and power-series kernels.",
    -1,
    module_methods,
    nullptr,
    nullptr,
    nullptr,
    nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__exactops(void) {
    s_zero_long = PyLong_FromLong(0);
    if (!s_zero_long) return nullptr;

    // mpq type setup
    Mpq_as_number.nb_add = Mpq_add;
    Mpq_as_number.nb_subtract = Mpq_sub;
    Mpq_as_number.nb_multiply = Mpq_mul;
    Mpq_as_number.nb_true_divide = Mpq_div;
    Mpq_as_number.nb_negative = Mpq_neg;
    Mpq_as_number.nb_absolute = Mpq_absfn;
    Mpq_as_number.nb_power = Mpq_pow;
    Mpq_as_number.nb_float = Mpq_float;
    Mpq_as_number.nb_bool = Mpq_bool;
    MpqType.tp_dealloc = (destructor)Mpq_dealloc;
    MpqType.tp_flags = Py_TPFLAGS_DEFAULT;
    MpqType.tp_doc = "Immutable GMP rational.";
    MpqType.tp_new = Mpq_new;
    MpqType.tp_as_number = &Mpq_as_number;
    MpqType.tp_richcompare = Mpq_richcompare;
    MpqType.tp_hash = Mpq_hash;
    MpqType.tp_str = Mpq_str;
    MpqType.tp_repr = Mpq_repr;
    MpqType.tp_getset = Mpq_getset;
    MpqType.tp_methods = Mpq_methods;
    if (PyType_Ready(&MpqType) < 0) return nullptr;

    // mpfr type setup
    Mpfr_as_number.nb_add = Mpfr_add;
    Mpfr_as_number.nb_subtract = Mpfr_sub;
    Mpfr_as_number.nb_multiply = Mpfr_mul;
    Mpfr_as_number.nb_true_divide = Mpfr_div;
    Mpfr_as_number.nb_negative = Mpfr_neg;
    Mpfr_as_number.nb_absolute = Mpfr_absfn;
    Mpfr_as_number.nb_power = Mpfr_pow;
    Mpfr_as_number.nb_float = Mpfr_float;
    Mpfr_as_number.nb_bool = Mpfr_bool;
    MpfrType.tp_dealloc = (destructor)Mpfr_dealloc;
    MpfrType.tp_flags = Py_TPFLAGS_DEFAULT;
    MpfrType.tp_doc = "Immutable MPFR float at the global precision.";
    MpfrType.tp_new = Mpfr_new;
    MpfrType.tp_as_number = &Mpfr_as_number;
    MpfrType.tp_richcompare = Mpfr_richcompare;
    MpfrType.tp_hash = Mpfr_hash;
    MpfrType.tp_str = Mpfr_str;
    MpfrType.tp_repr = Mpfr_str;
    MpfrType.tp_methods = Mpfr_methods;
    if (PyType_Ready(&MpfrType) < 0) return nullptr;

    PyObject* m = PyModule_Create(&exactops_module);
    if (!m) return nullptr;
    Py_INCREF(&MpqType);
    if (PyModule_AddObject(m, "mpq", (PyObject*)&MpqType) < 0) {
        Py_DECREF(&MpqType);
        Py_DECREF(m);
        return nullptr;
    }
    Py_INCREF(&MpfrType);
    if (PyModule_AddObject(m, "mpfr", (PyObject*)&MpfrType) < 0) {
        Py_DECREF(&MpfrType);
        Py_DECREF(m);
        return nullptr;
    }
    return m;
}
