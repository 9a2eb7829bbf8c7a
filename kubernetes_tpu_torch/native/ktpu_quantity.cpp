// Native quantity parsing: k8s resource.Quantity strings -> canonical int64.
// The port's own copy of the repository root's native/ktpu_quantity.cpp,
// built by kubernetes_tpu_torch/native/loader.py.
//
// The host runtime parses resource quantities on every pod/node encode
// (apimachinery pkg/api/resource Quantity semantics). The Python
// implementation (api/resource.py) uses Fraction for exactness; this is the
// same math in exact __int128 integer arithmetic.
//
// Canonical units (must match api/resource.py module doc):
//   class 0: plain integer count, ceil        (pods, extended resources)
//   class 1: millicores, ceil                 (cpu)
//   class 2: KiB, ceil                        (memory)
//   class 3: MiB, ceil                        (ephemeral-storage, hugepages-*)
//
// Exported C ABI (ctypes):
//   int kt_canonical(const char* s, int cls, long long* out)
//     returns 0 on success, nonzero on parse error.
//   long long kt_version()

#include <cstdint>
#include <cstring>

extern "C" {

static const long long KT_ABI_VERSION = 1;

long long kt_version() { return KT_ABI_VERSION; }

// ceil(a / b) for positive b, any-sign a
static __int128 ceil_div(__int128 a, __int128 b) {
    __int128 q = a / b;
    if (a % b != 0 && ((a > 0) == (b > 0))) q += 1;
    return q;
}

int kt_canonical(const char* s, int cls, long long* out) {
    if (!s || !out) return 1;
    // skip leading whitespace
    while (*s == ' ' || *s == '\t') s++;
    int neg = 0;
    if (*s == '+') s++;
    else if (*s == '-') { neg = 1; s++; }

    // mantissa: digits [. digits]; cap significant digits to avoid overflow
    __int128 mant = 0;
    int frac_digits = 0, seen_digit = 0, in_frac = 0, sig = 0;
    for (; *s; s++) {
        char c = *s;
        if (c >= '0' && c <= '9') {
            seen_digit = 1;
            if (sig < 18) {
                mant = mant * 10 + (c - '0');
                sig++;
                if (in_frac) frac_digits++;
            } else if (!in_frac) {
                return 2; // integer part too large to represent
            } else if (c != '0') {
                // A nonzero fractional digit beyond 18 significant digits
                // cannot be represented; silently dropping it can under-shoot
                // the exact ceiling by far more than 1 ulp for large suffixes
                // (e.g. Ei on cpu). Signal failure so the caller falls back to
                // the exact Fraction path in api/resource.py.
                return 7;
            } // trailing fractional zeros beyond 18 sig digits: exactly representable
        } else if (c == '.') {
            if (in_frac) return 3;
            in_frac = 1;
        } else {
            break;
        }
    }
    if (!seen_digit) return 4;

    // suffix: "", Ki..Ei, n/u/m/k/M/G/T/P/E
    __int128 mult_num = 1, mult_den = 1;
    const char* suf = s;
    size_t sl = strlen(suf);
    // trim trailing whitespace
    while (sl > 0 && (suf[sl-1] == ' ' || suf[sl-1] == '\t' || suf[sl-1] == '\n')) sl--;
    if (sl == 2 && suf[1] == 'i') {
        int shift;
        switch (suf[0]) {
            case 'K': shift = 10; break;
            case 'M': shift = 20; break;
            case 'G': shift = 30; break;
            case 'T': shift = 40; break;
            case 'P': shift = 50; break;
            case 'E': shift = 60; break;
            default: return 5;
        }
        mult_num = ((__int128)1) << shift;
    } else if (sl == 1) {
        switch (suf[0]) {
            case 'n': mult_den = 1000000000LL; break;
            case 'u': mult_den = 1000000LL; break;
            case 'm': mult_den = 1000LL; break;
            case 'k': mult_num = 1000LL; break;
            case 'M': mult_num = 1000000LL; break;
            case 'G': mult_num = 1000000000LL; break;
            case 'T': mult_num = 1000000000000LL; break;
            case 'P': mult_num = 1000000000000000LL; break;
            case 'E': mult_num = 1000000000000000000LL; break;
            default: return 5;
        }
    } else if (sl != 0) {
        return 5;
    }

    // unit scale per canonical class
    __int128 un = 1, ud = 1;
    switch (cls) {
        case 0: break;
        case 1: un = 1000; break;                 // cpu -> milli
        case 2: ud = ((__int128)1) << 10; break;  // memory -> KiB
        case 3: ud = ((__int128)1) << 20; break;  // eph/hugepages -> MiB
        default: return 6;
    }

    // 10^frac_digits (frac_digits <= 18)
    __int128 pow10 = 1;
    for (int i = 0; i < frac_digits; i++) pow10 *= 10;

    // result = ceil(mant * mult_num * un / (pow10 * mult_den * ud))
    // overflow guard: mant<=1e18, mult_num<=1e18 -> product <= 1e36; *1000 -> 1e39
    // exceeds int128 (~1.7e38) only for >=15-sig-digit mantissa with E/Ei on cpu;
    // detect and reject that corner rather than wrap.
    __int128 num = mant;
    if (mult_num > 1) {
        if (sig > 18) return 2;
        // mant*mult_num overflow check via division bound
        __int128 lim = (__int128)1;
        lim <<= 126;
        if (mant != 0 && mult_num > lim / (mant ? mant : 1) / (un ? un : 1)) return 2;
        num *= mult_num;
    }
    num *= un;
    __int128 den = pow10 * mult_den * ud;
    __int128 r = ceil_div(neg ? -num : num, den);

    if (r > (__int128)0x7fffffffffffffffLL || r < -(__int128)0x7fffffffffffffffLL) return 2;
    *out = (long long)r;
    return 0;
}

}  // extern "C"
