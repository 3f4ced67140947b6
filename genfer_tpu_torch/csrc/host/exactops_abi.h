// Minimal GMP / MPFR ABI declarations for linking against the system
// libgmp.so.10 / libmpfr.so.6 shipped with the toolchain (no dev headers in
// this image).  Struct layouts and symbol names are the documented stable
// ABI of GMP >= 5 and MPFR >= 4 on LP64 Linux.
//
// This re-declares only what native/exactops.cpp uses; it is NOT a copy of
// gmp.h/mpfr.h (which are many thousands of lines of macros and inlines).
#pragma once

#include <cstddef>

extern "C" {

// ---------------------------------------------------------------- GMP ----
typedef unsigned long mp_limb_t;   // 64-bit limbs on x86-64 Linux
typedef long mp_size_t;
typedef unsigned long mp_bitcnt_t;

typedef struct {
    int _mp_alloc;
    int _mp_size;
    mp_limb_t* _mp_d;
} __mpz_struct;

typedef __mpz_struct mpz_t[1];
typedef __mpz_struct* mpz_ptr;
typedef const __mpz_struct* mpz_srcptr;

typedef struct {
    __mpz_struct _mp_num;
    __mpz_struct _mp_den;
} __mpq_struct;

typedef __mpq_struct mpq_t[1];
typedef __mpq_struct* mpq_ptr;
typedef const __mpq_struct* mpq_srcptr;

// mpz
void __gmpz_init(mpz_ptr);
void __gmpz_init2(mpz_ptr, mp_bitcnt_t);
void __gmpz_clear(mpz_ptr);
void __gmpz_set(mpz_ptr, mpz_srcptr);
void __gmpz_init_set(mpz_ptr, mpz_srcptr);
void __gmpz_set_si(mpz_ptr, long);
void __gmpz_init_set_si(mpz_ptr, long);
void __gmpz_set_d(mpz_ptr, double);
int __gmpz_set_str(mpz_ptr, const char*, int);
void __gmpz_swap(mpz_ptr, mpz_ptr);
void __gmpz_add(mpz_ptr, mpz_srcptr, mpz_srcptr);
void __gmpz_sub(mpz_ptr, mpz_srcptr, mpz_srcptr);
void __gmpz_mul(mpz_ptr, mpz_srcptr, mpz_srcptr);
void __gmpz_mul_si(mpz_ptr, mpz_srcptr, long);
void __gmpz_mul_ui(mpz_ptr, mpz_srcptr, unsigned long);
void __gmpz_addmul(mpz_ptr, mpz_srcptr, mpz_srcptr);
void __gmpz_neg(mpz_ptr, mpz_srcptr);
void __gmpz_abs(mpz_ptr, mpz_srcptr);
int __gmpz_cmp(mpz_srcptr, mpz_srcptr);
int __gmpz_cmp_si(mpz_srcptr, long);
void __gmpz_lcm(mpz_ptr, mpz_srcptr, mpz_srcptr);
void __gmpz_gcd(mpz_ptr, mpz_srcptr, mpz_srcptr);
void __gmpz_divexact(mpz_ptr, mpz_srcptr, mpz_srcptr);
void __gmpz_pow_ui(mpz_ptr, mpz_srcptr, unsigned long);
void __gmpz_powm(mpz_ptr, mpz_srcptr, mpz_srcptr, mpz_srcptr);
void __gmpz_mod(mpz_ptr, mpz_srcptr, mpz_srcptr);
void __gmpz_sqrtrem(mpz_ptr, mpz_ptr, mpz_srcptr);
void __gmpz_import(mpz_ptr, size_t, int, size_t, int, size_t, const void*);
void* __gmpz_export(void*, size_t*, int, size_t, int, size_t, mpz_srcptr);
size_t __gmpz_sizeinbase(mpz_srcptr, int);
char* __gmpz_get_str(char*, int, mpz_srcptr);
long __gmpz_get_si(mpz_srcptr);
double __gmpz_get_d(mpz_srcptr);
int __gmpz_fits_slong_p(mpz_srcptr);

// mpq
void __gmpq_init(mpq_ptr);
void __gmpq_clear(mpq_ptr);
void __gmpq_set(mpq_ptr, mpq_srcptr);
void __gmpq_set_si(mpq_ptr, long, unsigned long);
void __gmpq_set_z(mpq_ptr, mpz_srcptr);
void __gmpq_set_d(mpq_ptr, double);
int __gmpq_set_str(mpq_ptr, const char*, int);
void __gmpq_set_num(mpq_ptr, mpz_srcptr);
void __gmpq_set_den(mpq_ptr, mpz_srcptr);
void __gmpq_canonicalize(mpq_ptr);
void __gmpq_add(mpq_ptr, mpq_srcptr, mpq_srcptr);
void __gmpq_sub(mpq_ptr, mpq_srcptr, mpq_srcptr);
void __gmpq_mul(mpq_ptr, mpq_srcptr, mpq_srcptr);
void __gmpq_div(mpq_ptr, mpq_srcptr, mpq_srcptr);
void __gmpq_neg(mpq_ptr, mpq_srcptr);
void __gmpq_abs(mpq_ptr, mpq_srcptr);
int __gmpq_cmp(mpq_srcptr, mpq_srcptr);
int __gmpq_cmp_si(mpq_srcptr, long, unsigned long);
int __gmpq_equal(mpq_srcptr, mpq_srcptr);
double __gmpq_get_d(mpq_srcptr);

// ---------------------------------------------------------------- MPFR ---
typedef long mpfr_prec_t;
typedef int mpfr_sign_t;
typedef long mpfr_exp_t;

typedef struct {
    mpfr_prec_t _mpfr_prec;
    mpfr_sign_t _mpfr_sign;
    mpfr_exp_t _mpfr_exp;
    mp_limb_t* _mpfr_d;
} __mpfr_struct;

typedef __mpfr_struct mpfr_t[1];
typedef __mpfr_struct* mpfr_ptr;
typedef const __mpfr_struct* mpfr_srcptr;

typedef int mpfr_rnd_t;  // MPFR_RNDN == 0

void mpfr_init2(mpfr_ptr, mpfr_prec_t);
void mpfr_clear(mpfr_ptr);
mpfr_prec_t mpfr_get_prec(mpfr_srcptr);
int mpfr_set(mpfr_ptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_set_si(mpfr_ptr, long, mpfr_rnd_t);
int mpfr_set_d(mpfr_ptr, double, mpfr_rnd_t);
int mpfr_set_z(mpfr_ptr, mpz_srcptr, mpfr_rnd_t);
int mpfr_set_q(mpfr_ptr, mpq_srcptr, mpfr_rnd_t);
int mpfr_set_str(mpfr_ptr, const char*, int, mpfr_rnd_t);
void mpfr_set_inf(mpfr_ptr, int);
void mpfr_set_nan(mpfr_ptr);
void mpfr_set_zero(mpfr_ptr, int);
int mpfr_add(mpfr_ptr, mpfr_srcptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_sub(mpfr_ptr, mpfr_srcptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_mul(mpfr_ptr, mpfr_srcptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_div(mpfr_ptr, mpfr_srcptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_mul_ui(mpfr_ptr, mpfr_srcptr, unsigned long, mpfr_rnd_t);
int mpfr_div_ui(mpfr_ptr, mpfr_srcptr, unsigned long, mpfr_rnd_t);
int mpfr_fma(mpfr_ptr, mpfr_srcptr, mpfr_srcptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_neg(mpfr_ptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_abs(mpfr_ptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_exp(mpfr_ptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_log(mpfr_ptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_sqrt(mpfr_ptr, mpfr_srcptr, mpfr_rnd_t);
int mpfr_pow_ui(mpfr_ptr, mpfr_srcptr, unsigned long, mpfr_rnd_t);
int mpfr_pow_si(mpfr_ptr, mpfr_srcptr, long, mpfr_rnd_t);
int mpfr_cmp(mpfr_srcptr, mpfr_srcptr);
int mpfr_cmp_si(mpfr_srcptr, long);
int mpfr_equal_p(mpfr_srcptr, mpfr_srcptr);
int mpfr_less_p(mpfr_srcptr, mpfr_srcptr);
int mpfr_lessequal_p(mpfr_srcptr, mpfr_srcptr);
int mpfr_greater_p(mpfr_srcptr, mpfr_srcptr);
int mpfr_greaterequal_p(mpfr_srcptr, mpfr_srcptr);
int mpfr_nan_p(mpfr_srcptr);
int mpfr_inf_p(mpfr_srcptr);
int mpfr_number_p(mpfr_srcptr);
int mpfr_zero_p(mpfr_srcptr);
int mpfr_signbit(mpfr_srcptr);
void mpfr_nextabove(mpfr_ptr);
void mpfr_nextbelow(mpfr_ptr);
double mpfr_get_d(mpfr_srcptr, mpfr_rnd_t);
int mpfr_asprintf(char**, const char*, ...);
void mpfr_free_str(char*);

}  // extern "C"

// Convenience aliases matching the documented GMP API names.
#define mpz_init __gmpz_init
#define mpz_init2 __gmpz_init2
#define mpz_clear __gmpz_clear
#define mpz_set __gmpz_set
#define mpz_init_set __gmpz_init_set
#define mpz_set_si __gmpz_set_si
#define mpz_init_set_si __gmpz_init_set_si
#define mpz_set_d __gmpz_set_d
#define mpz_set_str __gmpz_set_str
#define mpz_swap __gmpz_swap
#define mpz_add __gmpz_add
#define mpz_sub __gmpz_sub
#define mpz_mul __gmpz_mul
#define mpz_mul_si __gmpz_mul_si
#define mpz_mul_ui __gmpz_mul_ui
#define mpz_addmul __gmpz_addmul
#define mpz_neg __gmpz_neg
#define mpz_abs __gmpz_abs
#define mpz_cmp __gmpz_cmp
#define mpz_cmp_si __gmpz_cmp_si
#define mpz_lcm __gmpz_lcm
#define mpz_gcd __gmpz_gcd
#define mpz_divexact __gmpz_divexact
#define mpz_pow_ui __gmpz_pow_ui
#define mpz_powm __gmpz_powm
#define mpz_mod __gmpz_mod
#define mpz_sqrtrem __gmpz_sqrtrem
#define mpz_import __gmpz_import
#define mpz_export __gmpz_export
#define mpz_sizeinbase __gmpz_sizeinbase
#define mpz_get_str __gmpz_get_str
#define mpz_get_si __gmpz_get_si
#define mpz_get_d __gmpz_get_d
#define mpz_fits_slong_p __gmpz_fits_slong_p
#define mpz_sgn(z) ((z)->_mp_size < 0 ? -1 : ((z)->_mp_size > 0 ? 1 : 0))

#define mpq_init __gmpq_init
#define mpq_clear __gmpq_clear
#define mpq_set __gmpq_set
#define mpq_set_si __gmpq_set_si
#define mpq_set_z __gmpq_set_z
#define mpq_set_d __gmpq_set_d
#define mpq_set_str __gmpq_set_str
#define mpq_set_num __gmpq_set_num
#define mpq_set_den __gmpq_set_den
#define mpq_canonicalize __gmpq_canonicalize
#define mpq_add __gmpq_add
#define mpq_sub __gmpq_sub
#define mpq_mul __gmpq_mul
#define mpq_div __gmpq_div
#define mpq_neg __gmpq_neg
#define mpq_abs __gmpq_abs
#define mpq_cmp __gmpq_cmp
#define mpq_cmp_si __gmpq_cmp_si
#define mpq_equal __gmpq_equal
#define mpq_get_d __gmpq_get_d
#define mpq_numref(q) (&(q)->_mp_num)
#define mpq_denref(q) (&(q)->_mp_den)
#define mpq_sgn(q) mpz_sgn(mpq_numref(q))

#define MPFR_RNDN 0
