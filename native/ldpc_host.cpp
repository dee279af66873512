// Native host-side runtime pieces: the reference simulators' deterministic
// channel generators, bit-exact, at native speed.
//
// The CUDA reference generates all noise on the host with a 3-seed combined
// LCG and Box-Muller transforms (bldpc_实习/LDPC_Encoder.cu:25-56,
// myNBLDPC/src/LDPC_Encoder.cpp:41-79).  The framework's production
// channel is jax.random on-device; this library reproduces the reference's
// exact sequences for golden-vector tests and reference-compatible runs
// (utils/lcg.py is the slow pure-Python equivalent; parity is tested).
//
// Build: make -C native    (produces libldpc_host.so; loaded via ctypes)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>

namespace {

constexpr double kPi = 3.1415926;  // the reference's PI macro, not M_PI

struct Lcg {
  int32_t s0, s1, s2;
  // bldpc_实习/LDPC_Encoder.cu:46-56: seeds x{249,251,252} mod
  // {61967,63443,63599}; sum of float ratios, fractional part.
  double next() {
    s0 = static_cast<int32_t>((static_cast<int64_t>(s0) * 249) % 61967);
    s1 = static_cast<int32_t>((static_cast<int64_t>(s1) * 251) % 63443);
    s2 = static_cast<int32_t>((static_cast<int64_t>(s2) * 252) % 63599);
    float t = static_cast<float>(s0) / 61967.0f +
              static_cast<float>(s1) / 63443.0f +
              static_cast<float>(s2) / 63599.0f;
    return static_cast<double>(t) - static_cast<int>(t);
  }
};

}  // namespace

extern "C" {

// Raw uniform stream (for tests).
void ref_lcg_uniforms(int32_t seed0, int32_t seed1, int32_t seed2, int64_t n,
                      double* out, int32_t* seeds_out) {
  Lcg lcg{seed0, seed1, seed2};
  for (int64_t i = 0; i < n; ++i) out[i] = lcg.next();
  seeds_out[0] = lcg.s0;
  seeds_out[1] = lcg.s1;
  seeds_out[2] = lcg.s2;
}

// Binary channel: y[b][f] = sigma*sin(2*pi*u2)*sqrt(-2*ln(1-u1)) + (1-2c[b]),
// frame-major draw order, frame-interleaved [bit][frame] output layout
// (bldpc_实习/LDPC_Encoder.cu:25-41).
void ref_awgn_binary(int32_t seed0, int32_t seed1, int32_t seed2,
                     const uint8_t* codeword, int64_t cw_len, int64_t n_frames,
                     double sigma, double* out, int32_t* seeds_out) {
  Lcg lcg{seed0, seed1, seed2};
  for (int64_t f = 0; f < n_frames; ++f) {
    for (int64_t b = 0; b < cw_len; ++b) {
      double u1 = lcg.next();
      double u2 = lcg.next();
      double amp = std::sqrt(-2.0 * std::log(1.0 - u1));
      out[b * n_frames + f] =
          sigma * std::sin(2.0 * kPi * u2) * amp + 1.0 - 2.0 * codeword[b];
    }
  }
  seeds_out[0] = lcg.s0;
  seeds_out[1] = lcg.s1;
  seeds_out[2] = lcg.s2;
}

// Complex channel: independent cos-variant Box-Muller per component
// (myNBLDPC/src/LDPC_Encoder.cpp:41-69).
void ref_awgn_complex(int32_t seed0, int32_t seed1, int32_t seed2,
                      const double* tx_re, const double* tx_im, int64_t n,
                      double sigma, double* out_re, double* out_im,
                      int32_t* seeds_out) {
  Lcg lcg{seed0, seed1, seed2};
  for (int64_t i = 0; i < n; ++i) {
    double u1 = lcg.next(), u2 = lcg.next();
    out_re[i] =
        sigma * std::cos(2.0 * kPi * u2) * std::sqrt(-2.0 * std::log(1.0 - u1)) +
        tx_re[i];
    u1 = lcg.next();
    u2 = lcg.next();
    out_im[i] =
        sigma * std::cos(2.0 * kPi * u2) * std::sqrt(-2.0 * std::log(1.0 - u1)) +
        tx_im[i];
  }
  seeds_out[0] = lcg.s0;
  seeds_out[1] = lcg.s1;
  seeds_out[2] = lcg.s2;
}

// Whitespace-separated integer scan of an entire file — the native loader
// for the reference's pure-numeric code-definition formats: BlockH base
// matrices (bldpc_实习/Simulation.cu:292-354 reads them with fscanf) and
// non-binary adjacency files (myNBLDPC/src/Simulation.cpp:347-467).
// Writes at most max_out values into out; returns the TOTAL number of
// integer tokens in the file (callers size-check), or -1 on IO error.
// Tokens are optionally-signed digit runs; any other byte is a separator.
int64_t ref_scan_ints(const char* path, int64_t* out, int64_t max_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(std::malloc(size + 1));
  if (!buf) {
    std::fclose(f);
    return -1;
  }
  size_t got = std::fread(buf, 1, size, f);
  std::fclose(f);
  buf[got] = '\0';
  int64_t n = 0;
  const char* p = buf;
  const char* end = buf + got;
  while (p < end) {
    bool neg = false;
    if (*p == '-' && p + 1 < end && p[1] >= '0' && p[1] <= '9') {
      neg = true;
      ++p;
    }
    if (*p >= '0' && *p <= '9') {
      int64_t v = 0;
      while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
      if (n < max_out) out[n] = neg ? -v : v;
      ++n;
    } else {
      ++p;
    }
  }
  std::free(buf);
  return n;
}

}  // extern "C"
