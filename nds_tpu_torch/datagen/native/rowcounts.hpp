// Row-count scaling model. Fact tables are derived from order counts that
// scale linearly with SF; dimension tables follow the spec's published
// row counts at the defined scale points with geometric interpolation
// in between (exact at SF=1). Fractional SF < 1 is supported for smoke
// tests (the reference toolkit does not allow this; we do, because fast
// tiny-scale runs are how the test suite stays green).
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <string>

namespace ndsgen {

struct ScalePoints {
  // row counts at SF = 1, 10, 100, 1000, 3000, 10000, 100000
  int64_t at[7];
};

inline constexpr double kScaleKnots[7] = {1, 10, 100, 1000, 3000, 10000, 100000};

inline int64_t interp_count(const ScalePoints& p, double sf) {
  if (sf <= 1.0) {
    // sub-SF1 smoke scales: shrink smoothly but keep at least a handful of rows
    double v = static_cast<double>(p.at[0]) * sf;
    return std::max<int64_t>(static_cast<int64_t>(std::ceil(v)), std::min<int64_t>(p.at[0], 2));
  }
  for (int i = 0; i < 6; ++i) {
    if (sf <= kScaleKnots[i + 1]) {
      double t = (std::log(sf) - std::log(kScaleKnots[i])) /
                 (std::log(kScaleKnots[i + 1]) - std::log(kScaleKnots[i]));
      double lo = std::log(static_cast<double>(p.at[i]));
      double hi = std::log(static_cast<double>(p.at[i + 1]));
      return static_cast<int64_t>(std::llround(std::exp(lo + t * (hi - lo))));
    }
  }
  return p.at[6];
}

// Spec row counts (TPC-DS v3.2.0 table 3-2) at the defined scale points.
inline int64_t dim_rows(const std::string& table, double sf) {
  static const struct {
    const char* name;
    ScalePoints p;
  } kCounts[] = {
      {"call_center", {{6, 24, 30, 42, 48, 54, 60}}},
      {"catalog_page", {{11718, 12000, 20400, 30000, 36000, 40000, 50000}}},
      {"customer", {{100000, 500000, 2000000, 12000000, 30000000, 65000000, 100000000}}},
      {"customer_address", {{50000, 250000, 1000000, 6000000, 15000000, 32500000, 50000000}}},
      {"item", {{18000, 102000, 204000, 300000, 360000, 402000, 502000}}},
      {"promotion", {{300, 500, 1000, 1500, 1800, 2000, 2500}}},
      {"reason", {{35, 45, 55, 65, 67, 70, 75}}},
      {"store", {{12, 102, 402, 1002, 1350, 1500, 1902}}},
      {"warehouse", {{5, 10, 15, 20, 22, 25, 30}}},
      {"web_page", {{60, 200, 2040, 3000, 3600, 4002, 5004}}},
      {"web_site", {{30, 42, 54, 60, 66, 78, 96}}},
  };
  for (const auto& e : kCounts) {
    if (table == e.name) return interp_count(e.p, sf);
  }
  // fixed-size tables
  if (table == "customer_demographics") return 1920800;  // full cross product
  if (table == "household_demographics") return 7200;    // full cross product
  if (table == "date_dim") return kDateDimRows;
  if (table == "time_dim") return 86400;
  if (table == "income_band") return 20;
  if (table == "ship_mode") return 20;
  return -1;
}

// Order (purchase-unit) counts for the three sales channels; lines per order
// are drawn uniformly from [lo,hi] so expected row counts match the spec
// (store 2,880,404 @SF1 via 240k orders x avg 12 lines, etc.).
struct Channel {
  int64_t orders_sf1;
  int lines_lo, lines_hi;
};
inline constexpr Channel kStore{240000, 8, 16};
inline constexpr Channel kCatalog{160000, 4, 14};
inline constexpr Channel kWeb{60000, 8, 16};

inline int64_t channel_orders(const Channel& c, double sf) {
  return std::max<int64_t>(1, static_cast<int64_t>(std::llround(c.orders_sf1 * sf)));
}

// Inventory is a full cross product: 261 weekly snapshots x items/2 x warehouses.
inline constexpr int64_t kInventoryWeeks = 261;
inline int64_t inventory_items(double sf) { return std::max<int64_t>(1, dim_rows("item", sf) / 2); }

}  // namespace ndsgen
