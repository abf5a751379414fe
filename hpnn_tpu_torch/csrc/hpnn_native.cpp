// hpnn_tpu_torch native host library (a copy of the JAX package's).
//
// The reference is a pure-C library end to end; this module keeps the
// framework's host-side runtime native where it is hot:
//
//  * glibc TYPE_3 random() clone — seed-for-seed parity of weight
//    init (ref: libhpnn src/ann.c:653-677) and of the
//    sample-shuffle draw (ref: src/libhpnn.c:1218-1229), at C speed
//    (the MNIST shuffle draws ~60k slots with rejection; the Python
//    fallback spends seconds here per round).
//  * text number parsing / formatting — the sample and kernel file
//    formats are whitespace text (%7.5f / %17.15f); bulk-loading 60k
//    MNIST samples or dumping a 238k-weight kernel is strtod/snprintf
//    bound.
//
// Built on demand by hpnn_tpu_torch/native/__init__.py (g++ -O2 -shared),
// bound via ctypes; every entry point has a pure-Python fallback and
// an equality test in tests/test_torch_native.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int kDeg = 31;
constexpr int kSep = 3;
constexpr double kRandMax = 2147483647.0;

struct GlibcRng {
  int32_t r[kDeg];
  int f;
  int p;
};

void rng_seed(GlibcRng* g, uint32_t seed) {
  int32_t s = (int32_t)seed;
  if (s == 0) s = 1;
  g->r[0] = s;
  for (int i = 1; i < kDeg; ++i) {
    // glibc: s = 16807*s % 2147483647 via Schrage on int32
    int32_t hi = s / 127773;
    int32_t lo = s % 127773;
    s = 16807 * lo - 2836 * hi;
    if (s < 0) s += 2147483647;
    g->r[i] = s;
  }
  g->f = kSep;
  g->p = 0;
  for (int i = 0; i < 10 * kDeg; ++i) {
    uint32_t v = (uint32_t)g->r[g->f] + (uint32_t)g->r[g->p];
    g->r[g->f] = (int32_t)v;
    if (++g->f >= kDeg) g->f = 0;
    if (++g->p >= kDeg) g->p = 0;
  }
}

int32_t rng_next(GlibcRng* g) {
  uint32_t v = (uint32_t)g->r[g->f] + (uint32_t)g->r[g->p];
  g->r[g->f] = (int32_t)v;
  if (++g->f >= kDeg) g->f = 0;
  if (++g->p >= kDeg) g->p = 0;
  return (int32_t)(v >> 1);
}

}  // namespace

extern "C" {

void* glibc_new(uint32_t seed) {
  GlibcRng* g = new GlibcRng;
  rng_seed(g, seed);
  return g;
}

void glibc_delete(void* h) { delete (GlibcRng*)h; }

int32_t glibc_next(void* h) { return rng_next((GlibcRng*)h); }

// n raw draws into out
void glibc_fill(void* h, int64_t n, int32_t* out) {
  GlibcRng* g = (GlibcRng*)h;
  for (int64_t i = 0; i < n; ++i) out[i] = rng_next(g);
}

// n weights 2*(random()/RAND_MAX - 0.5)/sqrt_m — division, exactly as
// the reference computes it (ref: src/ann.c:677,702)
void glibc_weights(void* h, int64_t n, double sqrt_m, double* out) {
  GlibcRng* g = (GlibcRng*)h;
  for (int64_t i = 0; i < n; ++i)
    out[i] = 2.0 * ((double)rng_next(g) / kRandMax - 0.5) / sqrt_m;
}

// The training/eval file-visit order: draw slots in [0,n) with
// rejection of already-drawn slots (ref: src/libhpnn.c:1218-1229).
void glibc_shuffle(uint32_t seed, int64_t n, int32_t* out) {
  GlibcRng rng;
  rng_seed(&rng, seed);
  bool* taken = (bool*)calloc((size_t)n, 1);
  for (int64_t i = 0; i < n; ++i) {
    int64_t idx;
    do {
      idx = (int64_t)((double)rng_next(&rng) * (double)n / kRandMax);
      if (idx >= n) idx = n - 1;  // 2^-31 edge the C code would overrun
    } while (taken[idx]);
    taken[idx] = true;
    out[i] = (int32_t)idx;
  }
  free(taken);
}

// Parse up to maxn doubles from buf with the EXACT walk of the
// reference's GET_DOUBLE loops (ref: src/ann.c:438-444,
// src/libhpnn.c:1104-1110):
//   v = strtod(p, &end);        // 0.0 when end == p (failure)
//   ASSERT_GOTO(end, FAIL);     // NULL check — can never fire
//   p = end + 1; SKIP_BLANK(p); // skip non-graph except '\n'/'\0'
// A junk token therefore reads as 0.0 and the cursor advances one
// char; a junk-suffixed token ("0.25x") salvages its numeric prefix
// and scanning continues after it; a row can never be rejected.
// Returns how many slots were written before the line ran out (the C
// walks leftover buffer bytes past the NUL there — callers define the
// missing values as 0.0).
int64_t parse_doubles(const char* buf, int64_t maxn, double* out) {
  const char* lim = buf + strlen(buf);
  const char* p = buf;
  char* end;
  int64_t count = 0;
  // SKIP_BLANK runs once BEFORE the first GET_DOUBLE (ref:
  // src/ann.c:438, src/libhpnn.c:1104): leading non-graph bytes that
  // are not C whitespace (0x01, 0x7F, high bytes) must not make
  // strtod fail the first slot.
  while (p < lim && *p != '\n' && !(*p > ' ' && *p < 0x7f)) ++p;
  while (count < maxn && p <= lim) {
    double v = strtod(p, &end);
    out[count++] = (end == p) ? 0.0 : v;
    p = end + 1;  // end == p on failure, so this always advances 1+
    while (p < lim && *p != '\n' && !(*p > ' ' && *p < 0x7f)) ++p;
  }
  return count;
}

// Format m doubles as the kernel row "%17.15f %17.15f ...\n"
// (ref dump format: src/ann.c:770-857). Returns bytes written
// (excluding NUL), or -1 if cap is too small.
int64_t format_row(const double* w, int64_t m, char* out, int64_t cap) {
  int64_t pos = 0;
  for (int64_t i = 0; i < m; ++i) {
    if (cap - pos < 32) return -1;
    int k = snprintf(out + pos, (size_t)(cap - pos), i ? " %17.15f" : "%17.15f",
                     w[i]);
    if (k < 0) return -1;
    pos += k;
  }
  if (cap - pos < 2) return -1;
  out[pos++] = '\n';
  out[pos] = '\0';
  return pos;
}

}  // extern "C"
