// ndsgen: native TPC-DS-shaped data generator for the nds-tpu framework.
//
// Counterpart of the external dsdgen toolkit the reference builds/patches
// (reference: nds/tpcds-gen/Makefile:14-22, nds/tpcds-gen/patches/code.patch).
// Unlike dsdgen's stateful stream RNG, generation here is COUNTER-BASED:
// every field value is a pure function hash(seed, table, unit, line, col),
// so any chunk [child of parallel] is generated independently with no
// skip-ahead cost, and re-generating a sales chunk lets the matching
// returns chunk be derived without storing the sales rows.
#pragma once

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace ndsgen {

// ---------------------------------------------------------------------------
// Counter-based RNG: splitmix64 finalizer over a mixed key.
// ---------------------------------------------------------------------------
inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

struct Rng {
  uint64_t key;
  explicit Rng(uint64_t seed, uint64_t table, uint64_t unit, uint64_t line = 0)
      : key(mix64(mix64(mix64(seed ^ (table << 48)) ^ unit) ^ (line * 0x9e3779b97f4a7c15ULL))) {}

  // Independent draw for column `col`, draw index `n` (for multi-draw columns).
  uint64_t raw(uint32_t col, uint32_t n = 0) const {
    return mix64(key ^ (static_cast<uint64_t>(col) << 32) ^ n);
  }
  // uniform integer in [lo, hi] inclusive
  int64_t range(uint32_t col, int64_t lo, int64_t hi, uint32_t n = 0) const {
    return lo + static_cast<int64_t>(raw(col, n) % static_cast<uint64_t>(hi - lo + 1));
  }
  // uniform double in [0,1)
  double unit_f(uint32_t col, uint32_t n = 0) const {
    return (raw(col, n) >> 11) * (1.0 / 9007199254740992.0);
  }
  // true with probability pct/100
  bool chance(uint32_t col, int pct, uint32_t n = 0) const {
    return static_cast<int>(raw(col, n) % 100) < pct;
  }
  // decimal with `scale` implied digits, uniform in [lo, hi] (as doubles)
  int64_t dec(uint32_t col, double lo, double hi, int64_t pow10, uint32_t n = 0) const {
    double v = lo + unit_f(col, n) * (hi - lo);
    return static_cast<int64_t>(v * static_cast<double>(pow10) + 0.5);
  }
};

// ---------------------------------------------------------------------------
// Civil-date helpers (days_from_civil / civil_from_days, Hinnant algorithm).
// TPC-DS date surrogate keys are Julian day numbers; d_date_sk 2415022 is
// 1900-01-02, the first row of date_dim.
// ---------------------------------------------------------------------------
constexpr int64_t kJulianOfEpoch = 2440588;  // Julian day number of 1970-01-01

inline int64_t days_from_civil(int y, int m, int d) {
  y -= m <= 2;
  const int64_t era = (y >= 0 ? y : y - 399) / 400;
  const unsigned yoe = static_cast<unsigned>(y - era * 400);
  const unsigned doy = (153u * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + static_cast<int64_t>(doe) - 719468;
}

inline void civil_from_days(int64_t z, int* y, unsigned* m, unsigned* d) {
  z += 719468;
  const int64_t era = (z >= 0 ? z : z - 146096) / 146097;
  const unsigned doe = static_cast<unsigned>(z - era * 146097);
  const unsigned yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const int yy = static_cast<int>(yoe) + static_cast<int>(era) * 400;
  const unsigned doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const unsigned mp = (5 * doy + 2) / 153;
  *d = doy - (153 * mp + 2) / 5 + 1;
  *m = mp + (mp < 10 ? 3 : -9);
  *y = yy + (*m <= 2);
}

inline int64_t julian_from_civil(int y, unsigned m, unsigned d) {
  return days_from_civil(y, static_cast<int>(m), static_cast<int>(d)) + kJulianOfEpoch;
}

// date_dim span: 1900-01-02 .. 2100-01-01, 73049 rows (spec row count).
constexpr int64_t kDateDimFirstSk = 2415022;  // 1900-01-02
constexpr int64_t kDateDimRows = 73049;
// Sales activity window used for fact-table date keys: 1998-01-01..2003-01-01.
constexpr int64_t kSalesFirstSk = 2450815;   // julian of 1998-01-01
constexpr int64_t kSalesLastSk = 2452642;    // julian of 2002-12-31

// ---------------------------------------------------------------------------
// Buffered pipe-delimited row writer (trailing '|' per dsdgen convention).
// ---------------------------------------------------------------------------
class RowWriter {
 public:
  explicit RowWriter(FILE* f) : f_(f) { buf_.reserve(1 << 16); }
  ~RowWriter() { flush(); }

  void null_field() { buf_.push_back('|'); }
  void i64(int64_t v) {
    char tmp[24];
    int n = snprintf(tmp, sizeof(tmp), "%lld", static_cast<long long>(v));
    buf_.append(tmp, n);
    buf_.push_back('|');
  }
  void str(const char* s) {
    buf_.append(s);
    buf_.push_back('|');
  }
  void str(const std::string& s) {
    buf_.append(s);
    buf_.push_back('|');
  }
  // scaled decimal with 2 fraction digits (the only scale TPC-DS uses)
  void dec2(int64_t scaled) {
    char tmp[32];
    int64_t a = scaled < 0 ? -scaled : scaled;
    int n = snprintf(tmp, sizeof(tmp), "%s%lld.%02lld", scaled < 0 ? "-" : "",
                     static_cast<long long>(a / 100), static_cast<long long>(a % 100));
    buf_.append(tmp, n);
    buf_.push_back('|');
  }
  void date_from_julian(int64_t jd) {
    int y;
    unsigned m, d;
    civil_from_days(jd - kJulianOfEpoch, &y, &m, &d);
    char tmp[16];
    int n = snprintf(tmp, sizeof(tmp), "%04d-%02u-%02u", y, m, d);
    buf_.append(tmp, n);
    buf_.push_back('|');
  }
  void end_row() {
    buf_.push_back('\n');
    if (buf_.size() > (1u << 20)) flush();
  }
  void flush() {
    if (!buf_.empty()) {
      fwrite(buf_.data(), 1, buf_.size(), f_);
      buf_.clear();
    }
  }

 private:
  FILE* f_;
  std::string buf_;
};

// 16-char business id: "AAAAAAAA" + base-16 suffix over A..P, per-table unique.
inline std::string business_id(int64_t idx) {
  char out[17];
  for (int i = 15; i >= 0; --i) {
    out[i] = static_cast<char>('A' + (idx & 0xF));
    idx >>= 4;
  }
  return std::string(out, 16);
}

}  // namespace ndsgen
