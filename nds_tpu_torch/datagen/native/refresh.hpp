// Refresh-set (--update) generators: the s_* staging tables consumed by the
// Data Maintenance phase (LF_* inserts join these to dims; DF_* deletes use
// the delete/inventory_delete date ranges). Insert orders get ids beyond the
// base order range so LF inserts add genuinely new tickets; return staging
// rows re-derive base sales lines for referential integrity.
#pragma once

#include "facts.hpp"

namespace ndsgen {

inline std::string date_str(int64_t jd) {
  int y; unsigned m, d;
  civil_from_days(jd - kJulianOfEpoch, &y, &m, &d);
  char tmp[16];
  snprintf(tmp, sizeof(tmp), "%04d-%02u-%02u", y, m, d);
  return tmp;
}

inline int64_t refresh_orders(const Channel& ch, double sf) {
  return std::max<int64_t>(1, channel_orders(ch, sf) / 1000);
}

// Refresh date window for update set u: a 30-day slice after the base window.
inline int64_t refresh_date(const Ctx& ctx, uint64_t table, int update, int64_t unit) {
  Rng r(ctx.seed, table, unit, 777);
  return kSalesLastSk + 1 + static_cast<int64_t>(update - 1) * 30 + r.raw(0) % 30;
}

// ---- insert staging: store channel ---------------------------------------

inline void gen_s_purchase(RowWriter& w, const Ctx& ctx, int update, int64_t j) {
  const int64_t base = channel_orders(kStore, ctx.sf);
  const int64_t order = base + (update - 1) * refresh_orders(kStore, ctx.sf) + j;
  const StoreOrder o = store_order(ctx, order);
  Rng r(ctx.seed, T_S_PURCHASE, order);
  w.i64(order + 1);
  w.str(business_id((o.store + 1) / 2));      // store business id of SCD pair
  w.str(business_id(o.customer));
  w.str(date_str(refresh_date(ctx, T_S_PURCHASE, update, order)));
  w.i64(o.time_sk);
  w.i64(r.range(1, 1, 17));
  w.i64(r.range(2, 1, 1000));
  w.str(rand_word_text(r, 3, 4, 12));
  w.end_row();
}

inline void gen_s_purchase_lineitem(RowWriter& w, const Ctx& ctx, int update, int64_t j) {
  const int64_t base = channel_orders(kStore, ctx.sf);
  const int64_t order = base + (update - 1) * refresh_orders(kStore, ctx.sf) + j;
  const int nlines = lines_of(ctx, T_STORE_SALES, order, kStore);
  for (int l = 0; l < nlines; ++l) {
    const LineVals v = compute_line(ctx, T_STORE_SALES, order, l, false);
    Rng r(ctx.seed, T_S_PURCHASE, order, l + 1);
    w.i64(order + 1);
    w.i64(l + 1);
    w.str(business_id(v.item_sk));
    if (v.has_promo) w.str(business_id(v.promo_sk)); else w.null_field();
    w.i64(v.quantity);
    w.dec2(v.sales);
    w.dec2(v.coupon);
    w.str(rand_word_text(r, 1, 4, 12));
    w.end_row();
  }
}

// ---- insert staging: catalog channel --------------------------------------

inline void gen_s_catalog_order(RowWriter& w, const Ctx& ctx, int update, int64_t j) {
  const int64_t base = channel_orders(kCatalog, ctx.sf);
  const int64_t order = base + (update - 1) * refresh_orders(kCatalog, ctx.sf) + j;
  const CatalogOrder o = catalog_order(ctx, order);
  Rng r(ctx.seed, T_S_CATALOG_ORDER, order);
  w.i64(order + 1);
  w.str(business_id(o.bill_customer));
  w.str(business_id(o.ship_customer));
  w.str(date_str(refresh_date(ctx, T_S_CATALOG_ORDER, update, order)));
  w.i64(o.time_sk);
  w.str(business_id(o.ship_mode));
  w.str(business_id((o.call_center + 1) / 2));
  w.str(rand_word_text(r, 1, 4, 12));
  w.end_row();
}

inline void gen_s_catalog_order_lineitem(RowWriter& w, const Ctx& ctx, int update, int64_t j) {
  const int64_t base = channel_orders(kCatalog, ctx.sf);
  const int64_t order = base + (update - 1) * refresh_orders(kCatalog, ctx.sf) + j;
  const int nlines = lines_of(ctx, T_CATALOG_SALES, order, kCatalog);
  const int64_t odate = refresh_date(ctx, T_S_CATALOG_ORDER, update, order);
  for (int l = 0; l < nlines; ++l) {
    const LineVals v = compute_line(ctx, T_CATALOG_SALES, order, l, true);
    Rng r(ctx.seed, T_S_CATALOG_ORDER, order, l + 1);
    w.i64(order + 1);
    w.i64(l + 1);
    w.str(business_id(v.item_sk));
    if (v.has_promo) w.str(business_id(v.promo_sk)); else w.null_field();
    w.i64(v.quantity);
    w.dec2(v.sales);
    w.dec2(v.coupon);
    w.str(business_id(r.range(1, 1, ctx.n_warehouse)));
    w.str(date_str(odate + 2 + r.raw(2) % 90));
    {
      const int64_t page = r.range(3, 1, ctx.n_catalog_page);
      w.i64(page / 100 + 1);   // catalog number
      w.i64(page % 100 + 1);   // page within catalog
    }
    w.dec2(v.ext_ship / v.quantity);
    w.end_row();
  }
}

// ---- insert staging: web channel ------------------------------------------

inline void gen_s_web_order(RowWriter& w, const Ctx& ctx, int update, int64_t j) {
  const int64_t base = channel_orders(kWeb, ctx.sf);
  const int64_t order = base + (update - 1) * refresh_orders(kWeb, ctx.sf) + j;
  const WebOrder o = web_order(ctx, order);
  Rng r(ctx.seed, T_S_WEB_ORDER, order);
  w.i64(order + 1);
  w.str(business_id(o.bill_customer));
  w.str(business_id(o.ship_customer));
  w.str(date_str(refresh_date(ctx, T_S_WEB_ORDER, update, order)));
  w.i64(o.time_sk);
  w.str(business_id(o.ship_mode));
  w.str(business_id((o.web_site + 1) / 2));
  w.str(rand_word_text(r, 1, 4, 12));
  w.end_row();
}

inline void gen_s_web_order_lineitem(RowWriter& w, const Ctx& ctx, int update, int64_t j) {
  const int64_t base = channel_orders(kWeb, ctx.sf);
  const int64_t order = base + (update - 1) * refresh_orders(kWeb, ctx.sf) + j;
  const int nlines = lines_of(ctx, T_WEB_SALES, order, kWeb);
  const int64_t odate = refresh_date(ctx, T_S_WEB_ORDER, update, order);
  for (int l = 0; l < nlines; ++l) {
    const LineVals v = compute_line(ctx, T_WEB_SALES, order, l, true);
    Rng r(ctx.seed, T_S_WEB_ORDER, order, l + 1);
    w.i64(order + 1);
    w.i64(l + 1);
    w.str(business_id(v.item_sk));
    if (v.has_promo) w.str(business_id(v.promo_sk)); else w.null_field();
    w.i64(v.quantity);
    w.dec2(v.sales);
    w.dec2(v.coupon);
    w.str(business_id(r.range(1, 1, ctx.n_warehouse)));
    w.str(date_str(odate + 1 + r.raw(2) % 120));
    w.dec2(v.ext_ship / v.quantity);
    w.str(business_id(r.range(3, 1, (ctx.n_web_page + 1) / 2)));
    w.end_row();
  }
}

// ---- return staging -------------------------------------------------------
// Each update returns lines from a pseudo-random sample of BASE orders.

// Format-preserving permutation of [0, n): 4-round Feistel on the smallest
// even bit-width covering n, cycle-walked back into range. Collision-free by
// construction, so two sample indices can never map to the same base order
// (a plain hash-mod here emitted byte-identical duplicate return rows).
inline int64_t permute_into(uint64_t key, uint64_t j, uint64_t n) {
  int k = 2;
  while ((uint64_t(1) << k) < n) k += 2;
  const int h = k / 2;
  const uint64_t half_mask = (uint64_t(1) << h) - 1;
  uint64_t x = j;
  do {
    for (int rd = 0; rd < 4; ++rd) {
      const uint64_t L = x >> h, R = x & half_mask;
      const uint64_t f = mix64(R ^ key ^ (uint64_t(rd) << 56)) & half_mask;
      x = (R << h) | (L ^ f);
    }
  } while (x >= n);
  return static_cast<int64_t>(x);
}

inline int64_t sampled_base_order(const Ctx& ctx, const Channel& ch, uint64_t table,
                                  int update, int64_t j) {
  const uint64_t key = mix64(ctx.seed ^ (table << 40) ^ update);
  return permute_into(key, static_cast<uint64_t>(j),
                      static_cast<uint64_t>(channel_orders(ch, ctx.sf)));
}

inline void gen_s_store_returns(RowWriter& w, const Ctx& ctx, int update, int64_t j) {
  const int64_t order = sampled_base_order(ctx, kStore, T_STORE_RETURNS, update, j);
  const StoreOrder o = store_order(ctx, order);
  const int nlines = lines_of(ctx, T_STORE_SALES, order, kStore);
  const int l = static_cast<int>(j % nlines);
  const LineVals v = compute_line(ctx, T_STORE_SALES, order, l, false);
  Rng r(ctx.seed, T_STORE_RETURNS + 50, order, l + 1);
  const int64_t rq = 1 + static_cast<int64_t>(r.raw(2) % v.quantity);
  const int64_t ret_amt = v.sales * rq;
  const int64_t ret_tax = v.ext_tax * rq / v.quantity;
  const int64_t fee = 50 + static_cast<int64_t>(r.raw(3) % 9950);
  const int64_t ship = static_cast<int64_t>(r.raw(4) % 5000);
  const int64_t cash = static_cast<int64_t>(ret_amt * r.unit_f(5));
  const int64_t charge = static_cast<int64_t>((ret_amt - cash) * r.unit_f(6));
  const int64_t credit = ret_amt - cash - charge;
  const int64_t rdate = kSalesLastSk + 1 + (update - 1) * 30 + r.raw(7) % 30;
  w.str(business_id((o.store + 1) / 2));
  w.str(business_id(order + 1));
  w.i64(l + 1);
  w.str(business_id(v.item_sk));
  w.str(business_id(o.customer));
  w.str(date_str(rdate));
  {
    char t[12];
    int64_t sec = o.time_sk;
    snprintf(t, sizeof(t), "%02d:%02d:%02d", static_cast<int>(sec / 3600),
             static_cast<int>((sec / 60) % 60), static_cast<int>(sec % 60));
    w.str(t);
  }
  w.i64(order + 1);
  w.i64(rq);
  w.dec2(ret_amt);
  w.dec2(ret_tax);
  w.dec2(fee);
  w.dec2(ship);
  w.dec2(cash);
  w.dec2(charge);
  w.dec2(credit);
  w.str(business_id(1 + r.raw(8) % ctx.n_reason));
  w.end_row();
}

inline void gen_s_catalog_returns(RowWriter& w, const Ctx& ctx, int update, int64_t j) {
  const int64_t order = sampled_base_order(ctx, kCatalog, T_CATALOG_RETURNS, update, j);
  const CatalogOrder o = catalog_order(ctx, order);
  const int nlines = lines_of(ctx, T_CATALOG_SALES, order, kCatalog);
  const int l = static_cast<int>(j % nlines);
  const LineVals v = compute_line(ctx, T_CATALOG_SALES, order, l, true);
  Rng r(ctx.seed, T_CATALOG_RETURNS + 50, order, l + 1);
  const int64_t rq = 1 + static_cast<int64_t>(r.raw(2) % v.quantity);
  const int64_t ret_amt = v.sales * rq;
  const int64_t ret_tax = v.ext_tax * rq / v.quantity;
  const int64_t fee = 50 + static_cast<int64_t>(r.raw(3) % 9950);
  const int64_t ship = v.ext_ship * rq / v.quantity;
  const int64_t cash = static_cast<int64_t>(ret_amt * r.unit_f(5));
  const int64_t charge = static_cast<int64_t>((ret_amt - cash) * r.unit_f(6));
  const int64_t credit = ret_amt - cash - charge;
  const int64_t rdate = kSalesLastSk + 1 + (update - 1) * 30 + r.raw(7) % 30;
  w.str(business_id((o.call_center + 1) / 2));
  w.i64(order + 1);
  w.i64(l + 1);
  w.str(business_id(v.item_sk));
  w.str(business_id(o.ship_customer));
  w.str(business_id(o.bill_customer));
  w.str(date_str(rdate));
  {
    char t[12];
    snprintf(t, sizeof(t), "%02d:%02d:%02d", static_cast<int>(o.time_sk / 3600),
             static_cast<int>((o.time_sk / 60) % 60), static_cast<int>(o.time_sk % 60));
    w.str(t);
  }
  w.i64(rq);
  w.dec2(ret_amt);
  w.dec2(ret_tax);
  w.dec2(fee);
  w.dec2(ship);
  w.dec2(cash);
  w.dec2(charge);
  w.dec2(credit);
  w.str(business_id(1 + r.raw(8) % ctx.n_reason));
  w.str(business_id(o.ship_mode));
  w.str(business_id(1 + r.raw(9) % ctx.n_catalog_page));
  w.str(business_id(1 + r.raw(10) % ctx.n_warehouse));
  w.end_row();
}

inline void gen_s_web_returns(RowWriter& w, const Ctx& ctx, int update, int64_t j) {
  const int64_t order = sampled_base_order(ctx, kWeb, T_WEB_RETURNS, update, j);
  const WebOrder o = web_order(ctx, order);
  const int nlines = lines_of(ctx, T_WEB_SALES, order, kWeb);
  const int l = static_cast<int>(j % nlines);
  const LineVals v = compute_line(ctx, T_WEB_SALES, order, l, true);
  Rng r(ctx.seed, T_WEB_RETURNS + 50, order, l + 1);
  const int64_t rq = 1 + static_cast<int64_t>(r.raw(2) % v.quantity);
  const int64_t ret_amt = v.sales * rq;
  const int64_t ret_tax = v.ext_tax * rq / v.quantity;
  const int64_t fee = 50 + static_cast<int64_t>(r.raw(3) % 9950);
  const int64_t ship = v.ext_ship * rq / v.quantity;
  const int64_t cash = static_cast<int64_t>(ret_amt * r.unit_f(5));
  const int64_t charge = static_cast<int64_t>((ret_amt - cash) * r.unit_f(6));
  const int64_t credit = ret_amt - cash - charge;
  const int64_t rdate = kSalesLastSk + 1 + (update - 1) * 30 + r.raw(7) % 30;
  w.str(business_id(1 + r.raw(9) % std::max<int64_t>(1, (ctx.n_web_page + 1) / 2)));
  w.i64(order + 1);
  w.i64(l + 1);
  w.str(business_id(v.item_sk));
  w.str(business_id(o.ship_customer));
  w.str(business_id(o.bill_customer));
  w.str(date_str(rdate));
  {
    char t[12];
    snprintf(t, sizeof(t), "%02d:%02d:%02d", static_cast<int>(o.time_sk / 3600),
             static_cast<int>((o.time_sk / 60) % 60), static_cast<int>(o.time_sk % 60));
    w.str(t);
  }
  w.i64(rq);
  w.dec2(ret_amt);
  w.dec2(ret_tax);
  w.dec2(fee);
  w.dec2(ship);
  w.dec2(cash);
  w.dec2(charge);
  w.dec2(credit);
  w.str(business_id(1 + r.raw(8) % ctx.n_reason));
  w.end_row();
}

// ---- inventory + delete staging -------------------------------------------

inline void gen_s_inventory(RowWriter& w, const Ctx& ctx, int update, int64_t row) {
  const int64_t nw = ctx.n_warehouse;
  const int64_t item_ix = row / nw;
  const int64_t wh = row % nw;
  Rng r(ctx.seed, T_S_INVENTORY, row ^ (static_cast<uint64_t>(update) << 40));
  w.str(business_id(wh + 1));
  w.str(business_id(item_ix * 2 + 1));
  w.str(date_str(kSalesFirstSk + (kInventoryWeeks + update - 1) * 7));
  w.i64(r.raw(1) % 1000);
  w.end_row();
}

// 3 date-range tuples per update set (the reference's maintenance driver
// substitutes DATE1/DATE2 three times per DF function:
// reference nds/nds_maintenance.py:75-96).
inline void gen_delete_range(RowWriter& w, int update, int64_t k, bool inventory) {
  const int64_t span = inventory ? 21 : 30;
  const int64_t start = kSalesFirstSk + ((update - 1) * 3 + k) * 60 + (inventory ? 7 : 0);
  w.str(date_str(start));
  w.str(date_str(start + span));
  w.end_row();
}

}  // namespace ndsgen
