// Dimension-table row generators. Each generator is a pure function of
// (seed, table, row index) via the counter RNG, so chunks are independent.
// Column order matches nds_tpu/_schema_data.py exactly (TPC-DS spec order).
#pragma once

#include <string>

#include "ndsgen.hpp"
#include "rowcounts.hpp"
#include "vocab.hpp"

namespace ndsgen {

using namespace vocab;

struct Ctx {
  double sf = 1.0;
  uint64_t seed = 19620718;  // default RNGSEED, overridable via CLI
  // cached dimension cardinalities for FK draws
  int64_t n_customer, n_address, n_item, n_store, n_warehouse, n_web_page;
  int64_t n_web_site, n_call_center, n_catalog_page, n_promotion, n_reason;
  int64_t n_inv_items;

  explicit Ctx(double scale, uint64_t s) : sf(scale), seed(s) {
    n_customer = dim_rows("customer", sf);
    n_address = dim_rows("customer_address", sf);
    n_item = dim_rows("item", sf);
    n_store = dim_rows("store", sf);
    n_warehouse = dim_rows("warehouse", sf);
    n_web_page = dim_rows("web_page", sf);
    n_web_site = dim_rows("web_site", sf);
    n_call_center = dim_rows("call_center", sf);
    n_catalog_page = dim_rows("catalog_page", sf);
    n_promotion = dim_rows("promotion", sf);
    n_reason = dim_rows("reason", sf);
    n_inv_items = inventory_items(sf);
  }
};

enum TableId : uint64_t {
  T_CUSTOMER_ADDRESS = 1, T_CUSTOMER_DEMOGRAPHICS, T_DATE_DIM, T_WAREHOUSE,
  T_SHIP_MODE, T_TIME_DIM, T_REASON, T_INCOME_BAND, T_ITEM, T_STORE,
  T_CALL_CENTER, T_CUSTOMER, T_WEB_SITE, T_STORE_RETURNS, T_HOUSEHOLD_DEMOGRAPHICS,
  T_WEB_PAGE, T_PROMOTION, T_CATALOG_PAGE, T_INVENTORY, T_CATALOG_RETURNS,
  T_WEB_RETURNS, T_WEB_SALES, T_CATALOG_SALES, T_STORE_SALES,
  T_S_PURCHASE = 40, T_S_CATALOG_ORDER, T_S_WEB_ORDER, T_S_INVENTORY, T_DELETE,
};

// ---- small shared helpers -------------------------------------------------

inline const char* pick(const Rng& r, uint32_t col, const char* const* list, size_t n,
                        uint32_t draw = 0) {
  return list[r.raw(col, draw) % n];
}

inline std::string rand_word_text(const Rng& r, uint32_t col, int min_words, int max_words) {
  static const char* kWords[] = {
      "found", "early", "important", "public", "different", "small", "large", "national",
      "young", "major", "quiet", "certain", "social", "only", "special", "right",
      "results", "things", "years", "members", "police", "parts", "eyes", "forces",
      "levels", "times", "areas", "hands", "services", "words", "studies", "books",
      "come", "show", "take", "make", "give", "look", "work", "seem",
      "get", "feel", "pass", "carry", "remain", "however", "again", "never"};
  int n = min_words + static_cast<int>(r.raw(col, 900) % (max_words - min_words + 1));
  std::string out;
  for (int i = 0; i < n; ++i) {
    if (i) out.push_back(' ');
    out += kWords[r.raw(col, 901 + i) % vocab::len(kWords)];
  }
  return out;
}

inline std::string zip_for(const Rng& r, uint32_t col) {
  char z[6];
  snprintf(z, sizeof(z), "%05d", static_cast<int>(r.raw(col) % 100000));
  return z;
}

// Emits the 10-column address block used (in this order) by customer_address,
// warehouse, store, call_center, web_site: street_number, street_name,
// street_type, suite_number, city, county, state, zip, country, gmt_offset.
inline void emit_address(RowWriter& w, const Rng& r, uint32_t c0) {
  w.i64(r.range(c0 + 0, 1, 1000));
  {
    // street name: one or two words
    std::string name = pick(r, c0 + 1, kStreetNames, len(kStreetNames));
    if (r.chance(c0 + 1, 40, 7)) {
      name += " ";
      name += pick(r, c0 + 1, kStreetNames, len(kStreetNames), 8);
    }
    w.str(name);
  }
  w.str(pick(r, c0 + 2, kStreetTypes, len(kStreetTypes)));
  {
    char suite[16];
    if (r.chance(c0 + 3, 50))
      snprintf(suite, sizeof(suite), "Suite %d", static_cast<int>(r.raw(c0 + 3, 1) % 500));
    else
      snprintf(suite, sizeof(suite), "Suite %c", static_cast<char>('A' + r.raw(c0 + 3, 1) % 26));
    w.str(suite);
  }
  size_t state_ix = r.raw(c0 + 6) % len(kStates);
  w.str(pick(r, c0 + 4, kCities, len(kCities)));
  w.str(pick(r, c0 + 5, kCounties, len(kCounties)));
  w.str(kStates[state_ix]);
  w.str(zip_for(r, c0 + 7));
  w.str(kCountry);
  w.dec2(-500 - 100 * static_cast<int64_t>(state_ix % 4));  // gmt offset -5..-8
}

// ---- dimension generators -------------------------------------------------

inline void gen_customer_address(RowWriter& w, const Ctx& ctx, int64_t row) {
  Rng r(ctx.seed, T_CUSTOMER_ADDRESS, row);
  w.i64(row + 1);
  w.str(business_id(row + 1));
  emit_address(w, r, 10);
  w.str(pick(r, 30, kLocationTypes, len(kLocationTypes)));
  w.end_row();
}

inline void gen_customer_demographics(RowWriter& w, const Ctx& ctx, int64_t row) {
  (void)ctx;
  // full cross product, decomposed most-significant-first:
  // gender(2) x marital(5) x education(7) x purchase_estimate(20) x
  // credit_rating(4) x dep(7) x dep_employed(7) x dep_college(7) = 1,920,800
  int64_t ix = row;
  int dep_college = ix % 7; ix /= 7;
  int dep_emp = ix % 7; ix /= 7;
  int dep = ix % 7; ix /= 7;
  int credit = ix % 4; ix /= 4;
  int purch = ix % 20; ix /= 20;
  int edu = ix % 7; ix /= 7;
  int marital = ix % 5; ix /= 5;
  int gender = ix % 2;
  w.i64(row + 1);
  w.str(gender ? "F" : "M");
  w.str(kMarital[marital]);
  w.str(kEducation[edu]);
  w.i64((purch + 1) * 500);
  w.str(kCreditRating[credit]);
  w.i64(dep);
  w.i64(dep_emp);
  w.i64(dep_college);
  w.end_row();
}

inline void gen_date_dim(RowWriter& w, const Ctx& ctx, int64_t row) {
  (void)ctx;
  const int64_t jd = kDateDimFirstSk + row;
  int y; unsigned m, d;
  civil_from_days(jd - kJulianOfEpoch, &y, &m, &d);
  const int dow = static_cast<int>((jd + 1) % 7);  // 0=Sunday .. 6=Saturday
  static const char* kDays[] = {"Sunday", "Monday", "Tuesday", "Wednesday",
                                "Thursday", "Friday", "Saturday"};
  const int qoy = (m - 1) / 3 + 1;
  const bool holiday = (m == 7 && d == 4) || (m == 12 && d == 25) || (m == 1 && d == 1) ||
                       (m == 12 && d == 31);
  // previous day's holiday flag for d_following_holiday
  int py; unsigned pm, pd;
  civil_from_days(jd - 1 - kJulianOfEpoch, &py, &pm, &pd);
  const bool prev_holiday = (pm == 7 && pd == 4) || (pm == 12 && pd == 25) ||
                            (pm == 1 && pd == 1) || (pm == 12 && pd == 31);
  static const int kMonthDays[] = {31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31};
  const bool leap = (y % 4 == 0 && y % 100 != 0) || y % 400 == 0;
  const int dim = kMonthDays[m - 1] + (m == 2 && leap ? 1 : 0);

  w.i64(jd);
  w.str(business_id(jd));
  w.date_from_julian(jd);
  w.i64((y - 1900) * 12 + (m - 1));          // d_month_seq
  w.i64((row + 1) / 7 + 1);                  // d_week_seq (1900-01-02 was a Tuesday; weeks from 1900-01-01)
  w.i64((y - 1900) * 4 + (qoy - 1) + 1);     // d_quarter_seq
  w.i64(y);
  w.i64(dow);
  w.i64(m);
  w.i64(d);
  w.i64(qoy);
  w.i64(y);                                  // d_fy_year
  w.i64((y - 1900) * 4 + (qoy - 1) + 1);     // d_fy_quarter_seq
  w.i64((row + 1) / 7 + 1);                  // d_fy_week_seq
  w.str(kDays[dow]);
  {
    char q[8];
    snprintf(q, sizeof(q), "%04dQ%d", y, qoy);
    w.str(q);
  }
  w.str(holiday ? "Y" : "N");
  w.str(dow == 0 || dow == 6 ? "Y" : "N");
  w.str(prev_holiday ? "Y" : "N");
  w.i64(jd - d + 1);                         // d_first_dom
  w.i64(jd - d + dim);                       // d_last_dom
  w.i64(jd - 365);                           // d_same_day_ly
  w.i64(jd - 91);                            // d_same_day_lq
  w.str("N"); w.str("N"); w.str("N"); w.str("N"); w.str("N");
  w.end_row();
}

inline void gen_warehouse(RowWriter& w, const Ctx& ctx, int64_t row) {
  Rng r(ctx.seed, T_WAREHOUSE, row);
  w.i64(row + 1);
  w.str(business_id(row + 1));
  w.str(rand_word_text(r, 2, 2, 3));
  w.i64(r.range(3, 50000, 1000000));
  emit_address(w, r, 10);
  w.end_row();
}

inline void gen_ship_mode(RowWriter& w, const Ctx& ctx, int64_t row) {
  Rng r(ctx.seed, T_SHIP_MODE, row);
  w.i64(row + 1);
  w.str(business_id(row + 1));
  w.str(kShipModeTypes[row % len(kShipModeTypes)]);
  w.str(kShipModeCodes[row % len(kShipModeCodes)]);
  w.str(kShipModeCarriers[row % len(kShipModeCarriers)]);
  {
    char contract[21];
    for (int i = 0; i < 20; ++i)
      contract[i] = static_cast<char>('a' + r.raw(5, i) % 26);
    contract[20] = 0;
    w.str(contract);
  }
  w.end_row();
}

inline void gen_time_dim(RowWriter& w, const Ctx& ctx, int64_t row) {
  (void)ctx;
  const int hour = static_cast<int>(row / 3600);
  const int minute = static_cast<int>((row / 60) % 60);
  const int second = static_cast<int>(row % 60);
  w.i64(row);
  w.str(business_id(row));
  w.i64(row);
  w.i64(hour);
  w.i64(minute);
  w.i64(second);
  w.str(hour < 12 ? "AM" : "PM");
  w.str(hour >= 6 && hour < 14 ? kShifts[0] : (hour >= 14 && hour < 22 ? kShifts[1] : kShifts[2]));
  w.str(hour < 6 ? kSubShifts[3]
                 : (hour < 12 ? kSubShifts[0] : (hour < 18 ? kSubShifts[1] : kSubShifts[2])));
  if (hour >= 6 && hour <= 8) w.str(kMealTimes[0]);
  else if (hour >= 11 && hour <= 13) w.str(kMealTimes[1]);
  else if (hour >= 17 && hour <= 20) w.str(kMealTimes[2]);
  else w.null_field();
  w.end_row();
}

inline void gen_reason(RowWriter& w, const Ctx& ctx, int64_t row) {
  (void)ctx;
  w.i64(row + 1);
  w.str(business_id(row + 1));
  w.str(kReasons[row % len(kReasons)]);
  w.end_row();
}

inline void gen_income_band(RowWriter& w, const Ctx& ctx, int64_t row) {
  (void)ctx;
  w.i64(row + 1);
  w.i64(row == 0 ? 0 : row * 10000 + 1);
  w.i64((row + 1) * 10000);
  w.end_row();
}

inline void gen_item(RowWriter& w, const Ctx& ctx, int64_t row) {
  Rng r(ctx.seed, T_ITEM, row);
  const int cat = static_cast<int>(r.raw(12) % len(kCategories));       // 0..9
  const int cls = static_cast<int>(r.raw(10) % 8);                      // 0..7 within category
  const int manufact = static_cast<int>(r.raw(13) % 1000) + 1;          // 1..1000
  const int brand_no = static_cast<int>(r.raw(8) % 10) + 1;
  const int64_t price = r.dec(5, 0.09, 99.99, 100);
  w.i64(row + 1);
  w.str(business_id(row + 1));
  // SCD-2 convention shared by all history-keeping dims: ODD sks (even row
  // index) are the current rows (null rec_end_date); fact generators and
  // inventory only reference odd sks.
  if (row % 2 == 0) {
    w.date_from_julian(julian_from_civil(1999, 10, 28));
    w.null_field();
  } else {
    w.date_from_julian(julian_from_civil(1997, 10, 27));
    w.date_from_julian(julian_from_civil(1999, 10, 27));
  }
  w.str(rand_word_text(r, 4, 5, 20));
  w.dec2(price);
  w.dec2(static_cast<int64_t>(price * 6 / 10));
  w.i64((cat + 1) * 1000000 + (cls + 1) * 1000 + brand_no);  // i_brand_id encodes cat/class/brand
  {
    char brand[32];
    snprintf(brand, sizeof(brand), "%s%s #%d", kPromoNames[cat], kPromoNames[cls], brand_no);
    w.str(brand);
  }
  w.i64(cat * 8 + cls + 1);
  w.str(kClasses[cat * 8 + cls]);
  w.i64(cat + 1);
  w.str(kCategories[cat]);
  w.i64(manufact);
  {
    char mfg[32];
    snprintf(mfg, sizeof(mfg), "%s%s", kPromoNames[manufact % 10], kPromoNames[(manufact / 10) % 10]);
    w.str(mfg);
  }
  w.str(pick(r, 15, kSizes, len(kSizes)));
  {
    char formulation[21];
    for (int i = 0; i < 20; ++i)
      formulation[i] = static_cast<char>('0' + r.raw(16, i) % 10);
    formulation[20] = 0;
    w.str(formulation);
  }
  w.str(pick(r, 17, kColors, len(kColors)));
  w.str(pick(r, 18, kUnits, len(kUnits)));
  w.str("Unknown");
  w.i64(r.range(20, 1, 100));
  {
    char pname[64];
    snprintf(pname, sizeof(pname), "%s%s%s%s", kPromoNames[r.raw(21, 0) % 10],
             kPromoNames[r.raw(21, 1) % 10], kPromoNames[r.raw(21, 2) % 10],
             kPromoNames[r.raw(21, 3) % 10]);
    w.str(pname);
  }
  w.end_row();
}

inline void gen_store(RowWriter& w, const Ctx& ctx, int64_t row) {
  Rng r(ctx.seed, T_STORE, row);
  w.i64(row + 1);
  w.str(business_id(row / 2 + 1));  // SCD pairs share business id
  if (row % 2 == 0) {
    w.date_from_julian(julian_from_civil(1997, 3, 13));
    w.null_field();
  } else {
    w.date_from_julian(julian_from_civil(1997, 3, 13));
    w.date_from_julian(julian_from_civil(2000, 3, 12));
  }
  if (r.chance(4, 10)) w.i64(kSalesFirstSk + r.raw(4, 1) % 1500); else w.null_field();
  w.str(kStoreNames[row % len(kStoreNames)]);
  w.i64(r.range(6, 200, 300));
  w.i64(r.range(7, 5000000, 10000000));
  w.str(kCcHours[r.raw(8) % len(kCcHours)]);
  w.str(kManagers[r.raw(9) % len(kManagers)]);
  w.i64(r.range(10, 1, 10));
  w.str("Unknown");
  w.str(rand_word_text(r, 12, 6, 15));
  w.str(kManagers[r.raw(13) % len(kManagers)]);
  {
    int division = static_cast<int>(r.raw(14) % len(kDivisionNames));
    w.i64(division + 1);
    w.str(kDivisionNames[division]);
  }
  {
    int company = static_cast<int>(r.raw(16) % len(kCompanyNames));
    w.i64(company + 1);
    w.str(kCompanyNames[company]);
  }
  emit_address(w, r, 20);
  w.dec2(r.raw(31) % 12);  // s_tax_precentage 0.00..0.11
  w.end_row();
}

inline void gen_call_center(RowWriter& w, const Ctx& ctx, int64_t row) {
  Rng r(ctx.seed, T_CALL_CENTER, row);
  w.i64(row + 1);
  w.str(business_id(row / 2 + 1));
  w.date_from_julian(julian_from_civil(1998, 1, 1));
  if (row % 2 == 0) w.null_field();
  else w.date_from_julian(julian_from_civil(2000, 12, 31));
  w.null_field();                                   // cc_closed_date_sk
  w.i64(kSalesFirstSk - r.raw(5) % 1000);           // cc_open_date_sk
  {
    static const char* kCcNames[] = {"NY Metro", "Mid Atlantic", "North Midwest", "California",
                                     "Pacific Northwest", "Hawaii/Alaska"};
    w.str(kCcNames[(row / 2) % 6]);
  }
  w.str(kCcClass[r.raw(7) % len(kCcClass)]);
  w.i64(r.range(8, 1, 7) * 100000);
  w.i64(r.range(9, 1, 25) * 1225);
  w.str(kCcHours[r.raw(10) % len(kCcHours)]);
  w.str(kManagers[r.raw(11) % len(kManagers)]);
  w.i64(r.range(12, 1, 6));
  w.str(kMarketClasses[r.raw(13) % len(kMarketClasses)]);
  w.str(rand_word_text(r, 14, 6, 15));
  w.str(kManagers[r.raw(15) % len(kManagers)]);
  {
    int division = static_cast<int>(r.raw(16) % len(kDivisionNames));
    w.i64(division + 1);
    w.str(kDivisionNames[division]);
  }
  {
    int company = static_cast<int>(r.raw(18) % len(kCompanyNames));
    w.i64(company + 1);
    w.str(kCompanyNames[company]);
  }
  emit_address(w, r, 20);
  w.dec2(r.raw(31) % 12);
  w.end_row();
}

inline void gen_customer(RowWriter& w, const Ctx& ctx, int64_t row) {
  Rng r(ctx.seed, T_CUSTOMER, row);
  static const char* kSalutations[] = {"Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir"};
  const char* first = kFirstNames[r.raw(8) % len(kFirstNames)];
  const char* last = kLastNames[r.raw(9) % len(kLastNames)];
  w.i64(row + 1);
  w.str(business_id(row + 1));
  if (r.chance(2, 96)) w.i64(r.range(2, 1, 1920800, 1)); else w.null_field();
  if (r.chance(3, 96)) w.i64(r.range(3, 1, 7200, 1)); else w.null_field();
  w.i64(r.range(4, 1, ctx.n_address));
  {
    int64_t first_sales = kSalesFirstSk + static_cast<int64_t>(r.raw(6) % 1000);
    if (r.chance(5, 96)) w.i64(first_sales + 30); else w.null_field();
    if (r.chance(6, 96)) w.i64(first_sales); else w.null_field();
  }
  if (r.chance(7, 96)) w.str(kSalutations[r.raw(7, 1) % 6]); else w.null_field();
  if (r.chance(8, 96)) w.str(first); else w.null_field();
  if (r.chance(9, 96)) w.str(last); else w.null_field();
  w.str(r.chance(10, 50) ? "Y" : "N");
  w.i64(r.range(11, 1, 28));
  w.i64(r.range(12, 1, 12));
  w.i64(r.range(13, 1924, 1992));
  w.str(kCountry);
  w.null_field();  // c_login is always null in dsdgen output
  {
    char email[64];
    snprintf(email, sizeof(email), "%s.%s@example.com", first, last);
    w.str(email);
  }
  {
    char buf[16];
    snprintf(buf, sizeof(buf), "%lld",
             static_cast<long long>(kSalesLastSk - r.raw(17) % 400));
    w.str(buf);  // c_last_review_date_sk is char(10) in the spec schema
  }
  w.end_row();
}

inline void gen_web_site(RowWriter& w, const Ctx& ctx, int64_t row) {
  Rng r(ctx.seed, T_WEB_SITE, row);
  w.i64(row + 1);
  w.str(business_id(row / 2 + 1));
  w.date_from_julian(julian_from_civil(1997, 8, 16));
  if (row % 2 == 0) w.null_field();
  else w.date_from_julian(julian_from_civil(2000, 8, 15));
  {
    char name[16];
    snprintf(name, sizeof(name), "site_%d", static_cast<int>((row / 2) % 100));
    w.str(name);
  }
  w.i64(kSalesFirstSk - r.raw(5) % 1000);
  w.null_field();  // web_close_date_sk
  w.str("Unknown");
  w.str(kManagers[r.raw(8) % len(kManagers)]);
  w.i64(r.range(9, 1, 6));
  w.str(kMarketClasses[r.raw(10) % len(kMarketClasses)]);
  w.str(rand_word_text(r, 11, 6, 15));
  w.str(kManagers[r.raw(12) % len(kManagers)]);
  {
    int company = static_cast<int>(r.raw(13) % len(kCompanyNames));
    w.i64(company + 1);
    w.str(kCompanyNames[company]);
  }
  emit_address(w, r, 20);
  w.dec2(r.raw(31) % 12);
  w.end_row();
}

inline void gen_household_demographics(RowWriter& w, const Ctx& ctx, int64_t row) {
  (void)ctx;
  // cross product: income_band(20) x buy_potential(6) x dep_count(10) x vehicle(6)
  int64_t ix = row;
  int vehicle = static_cast<int>(ix % 6) - 1;  // -1..4
  ix /= 6;
  int dep = ix % 10; ix /= 10;
  int buy = ix % 6; ix /= 6;
  int band = static_cast<int>(ix % 20) + 1;
  w.i64(row + 1);
  w.i64(band);
  w.str(kBuyPotential[buy]);
  w.i64(dep);
  w.i64(vehicle);
  w.end_row();
}

inline void gen_web_page(RowWriter& w, const Ctx& ctx, int64_t row) {
  Rng r(ctx.seed, T_WEB_PAGE, row);
  static const char* kPageTypes[] = {"ad", "dynamic", "feedback", "general",
                                     "order", "protected", "welcome"};
  w.i64(row + 1);
  w.str(business_id(row / 2 + 1));
  w.date_from_julian(julian_from_civil(1997, 9, 3));
  if (row % 2 == 0) w.null_field();
  else w.date_from_julian(julian_from_civil(2000, 9, 2));
  w.i64(kSalesFirstSk - r.raw(4) % 500);
  w.i64(kSalesFirstSk + r.raw(5) % 500);
  const bool autogen = r.chance(6, 30);
  w.str(autogen ? "Y" : "N");
  if (autogen) w.i64(r.range(7, 1, ctx.n_customer)); else w.null_field();
  {
    char url[32];
    snprintf(url, sizeof(url), "http://www.foo.com");
    w.str(url);
  }
  w.str(kPageTypes[r.raw(9) % len(kPageTypes)]);
  w.i64(r.range(10, 100, 8000));
  w.i64(r.range(11, 2, 25));
  w.i64(r.range(12, 1, 7));
  w.i64(r.range(13, 0, 4));
  w.end_row();
}

inline void gen_promotion(RowWriter& w, const Ctx& ctx, int64_t row) {
  Rng r(ctx.seed, T_PROMOTION, row);
  w.i64(row + 1);
  w.str(business_id(row + 1));
  {
    int64_t start = kSalesFirstSk + r.raw(2) % 1600;
    w.i64(start);
    w.i64(start + r.raw(3) % 60);
  }
  w.i64(r.range(4, 1, ctx.n_item));
  w.dec2(100000);  // p_cost constant 1000.00
  w.i64(1);
  {
    char name[24];
    snprintf(name, sizeof(name), "%s%s", kPromoNames[r.raw(7, 0) % 10],
             kPromoNames[r.raw(7, 1) % 10]);
    w.str(name);
  }
  for (uint32_t c = 8; c < 16; ++c) w.str(r.chance(c, 50) ? "Y" : "N");
  w.str(rand_word_text(r, 16, 4, 12));
  w.str("Unknown");
  w.str(r.chance(18, 50) ? "Y" : "N");
  w.end_row();
}

inline void gen_catalog_page(RowWriter& w, const Ctx& ctx, int64_t row) {
  Rng r(ctx.seed, T_CATALOG_PAGE, row);
  static const char* kCpTypes[] = {"bi-annual", "quarterly", "monthly"};
  // catalogs are issued periodically; ~100 pages per catalog number
  const int64_t catalog_number = row / 100 + 1;
  const int64_t page_number = row % 100 + 1;
  w.i64(row + 1);
  w.str(business_id(row + 1));
  {
    int64_t start = julian_from_civil(1998, 1, 1) + (catalog_number - 1) * 30;
    w.i64(start);
    w.i64(start + 90);
  }
  w.str("DEPARTMENT");
  w.i64(catalog_number);
  w.i64(page_number);
  w.str(rand_word_text(r, 7, 4, 12));
  w.str(kCpTypes[catalog_number % 3]);
  w.end_row();
}

}  // namespace ndsgen
