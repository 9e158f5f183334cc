// Fact-table generators: the three sales channels, their returns, and
// inventory. The generation unit is the ORDER index; rows are (order, line).
// Returns are derived by re-deriving the matching sales line from the same
// counter RNG (no stored state), so a returns chunk only needs the order
// range of the corresponding sales chunk — the property that makes
// distributed generation embarrassingly parallel.
#pragma once

#include <numeric>

#include "dims.hpp"

namespace ndsgen {

// Shared per-line economics. All monetary values are scaled x100 int64.
struct LineVals {
  int64_t item_sk = 0, promo_sk = 0, quantity = 0;
  int64_t wholesale = 0, list = 0, sales = 0;        // per-unit prices
  int64_t ext_discount = 0, ext_sales = 0, ext_wholesale = 0, ext_list = 0;
  int64_t ext_tax = 0, coupon = 0, ext_ship = 0;
  int64_t net_paid = 0, net_paid_inc_tax = 0, net_paid_inc_ship = 0;
  int64_t net_paid_inc_ship_tax = 0, net_profit = 0;
  bool has_promo = false;
};

inline LineVals compute_line(const Ctx& ctx, uint64_t table, int64_t order, int line,
                             bool with_ship) {
  Rng r(ctx.seed, table, order, line + 1);
  LineVals v;
  // Items are distinct within an order (TPC-DS PK: (item_sk, ticket/order
  // number); dsdgen samples per-ticket items without replacement). Stateless
  // equivalent: an order-keyed modular arithmetic progression — returns
  // chunks re-derive the same items from (seed, table, order, line) alone.
  {
    const int64_t half = (ctx.n_item + 1) / 2;  // odd sks = current SCD rows
    Rng ro(ctx.seed, table, order, 0);
    // random start + random stride COPRIME to the domain: (s + l*t) mod H
    // cycles through all H items, so lines are distinct whenever the
    // order has fewer lines than items, and the marginal item
    // distribution stays uniform over the whole domain
    int64_t stride = 1;
    for (uint32_t k = 0; k < 64; ++k) {
      const int64_t t = 1 + static_cast<int64_t>(
          ro.raw(90, k) % static_cast<uint64_t>(half > 1 ? half - 1 : 1));
      if (std::gcd(t, half) == 1) { stride = t; break; }
    }
    const int64_t start = static_cast<int64_t>(ro.raw(91) % static_cast<uint64_t>(half));
    const int64_t idx = (start + stride * line) % half;
    v.item_sk = idx * 2 + 1;
  }
  // dsdgen keeps nullable fact FKs ~96% populated; promo follows suit
  // (a 30% rate here made ss_promo_sk 70% null — spec-shape violation)
  v.has_promo = r.chance(101, 96);
  v.promo_sk = r.range(101, 1, ctx.n_promotion, 1);
  v.quantity = r.range(102, 1, 100);
  v.wholesale = r.dec(103, 1.00, 100.00, 100);
  const double markup = r.unit_f(104) * 2.0;            // 0..200% markup
  v.list = static_cast<int64_t>(v.wholesale * (1.0 + markup));
  const double discount = r.unit_f(105);                // 0..100% off list
  v.sales = static_cast<int64_t>(v.list * (1.0 - discount));
  v.ext_discount = (v.list - v.sales) * v.quantity;
  v.ext_sales = v.sales * v.quantity;
  v.ext_wholesale = v.wholesale * v.quantity;
  v.ext_list = v.list * v.quantity;
  const int tax_pct = static_cast<int>(r.raw(106) % 10);  // 0..9 %
  v.ext_tax = v.ext_sales * tax_pct / 100;
  v.coupon = r.chance(107, 20) ? static_cast<int64_t>(v.ext_sales * r.unit_f(107, 1) * 0.5) : 0;
  v.net_paid = v.ext_sales - v.coupon;
  v.net_paid_inc_tax = v.net_paid + v.ext_tax;
  if (with_ship) {
    const int64_t ship_per_unit = static_cast<int64_t>(v.list * r.unit_f(108) * 0.75);
    v.ext_ship = ship_per_unit * v.quantity;
  }
  v.net_paid_inc_ship = v.net_paid + v.ext_ship;
  v.net_paid_inc_ship_tax = v.net_paid + v.ext_ship + v.ext_tax;
  v.net_profit = v.net_paid - v.ext_wholesale;
  return v;
}

inline int lines_of(const Ctx& ctx, uint64_t table, int64_t order, const Channel& ch) {
  Rng r(ctx.seed, table, order, 0);
  return ch.lines_lo + static_cast<int>(r.raw(0) % (ch.lines_hi - ch.lines_lo + 1));
}

// nullable FK emit: ~4% null rate on nullable fact FKs, dsdgen-style
inline void fk(RowWriter& w, const Rng& r, uint32_t col, int64_t hi) {
  if (r.chance(col, 96))
    w.i64(r.range(col, 1, hi, 1));
  else
    w.null_field();
}

// nullable FK into an SCD-2 dim: only odd (current) sks are referenced
inline void fk_odd(RowWriter& w, const Rng& r, uint32_t col, int64_t hi) {
  if (r.chance(col, 96))
    w.i64(r.range(col, 1, (hi + 1) / 2, 1) * 2 - 1);
  else
    w.null_field();
}

// ---- store channel --------------------------------------------------------

struct StoreOrder {
  int64_t date_sk, time_sk, customer, cdemo, hdemo, addr, store;
  bool d_null, t_null, c_null, cd_null, hd_null, a_null, s_null;
};

inline StoreOrder store_order(const Ctx& ctx, int64_t order) {
  Rng r(ctx.seed, T_STORE_SALES, order, 0);
  StoreOrder o;
  o.date_sk = kSalesFirstSk + static_cast<int64_t>(r.raw(1) % (kSalesLastSk - kSalesFirstSk + 1));
  o.time_sk = 28800 + static_cast<int64_t>(r.raw(2) % (79200 - 28800));  // store hours 8:00-22:00
  o.customer = r.range(3, 1, ctx.n_customer);
  o.cdemo = r.range(4, 1, 1920800);
  o.hdemo = r.range(5, 1, 7200);
  o.addr = r.range(6, 1, ctx.n_address);
  o.store = (r.range(7, 1, (ctx.n_store + 1) / 2)) * 2 - 1;  // odd sks = current SCD rows
  o.d_null = !r.chance(1, 96, 9);
  o.t_null = !r.chance(2, 96, 9);
  o.c_null = !r.chance(3, 96, 9);
  o.cd_null = !r.chance(4, 96, 9);
  o.hd_null = !r.chance(5, 96, 9);
  o.a_null = !r.chance(6, 96, 9);
  o.s_null = !r.chance(7, 96, 9);
  return o;
}

inline void gen_store_sales_order(RowWriter& w, const Ctx& ctx, int64_t order) {
  const StoreOrder o = store_order(ctx, order);
  const int nlines = lines_of(ctx, T_STORE_SALES, order, kStore);
  for (int l = 0; l < nlines; ++l) {
    const LineVals v = compute_line(ctx, T_STORE_SALES, order, l, false);
    if (o.d_null) w.null_field(); else w.i64(o.date_sk);
    if (o.t_null) w.null_field(); else w.i64(o.time_sk);
    w.i64(v.item_sk);
    if (o.c_null) w.null_field(); else w.i64(o.customer);
    if (o.cd_null) w.null_field(); else w.i64(o.cdemo);
    if (o.hd_null) w.null_field(); else w.i64(o.hdemo);
    if (o.a_null) w.null_field(); else w.i64(o.addr);
    if (o.s_null) w.null_field(); else w.i64(o.store);
    if (v.has_promo) w.i64(v.promo_sk); else w.null_field();
    w.i64(order + 1);  // ss_ticket_number
    w.i64(v.quantity);
    w.dec2(v.wholesale);
    w.dec2(v.list);
    w.dec2(v.sales);
    w.dec2(v.ext_discount);
    w.dec2(v.ext_sales);
    w.dec2(v.ext_wholesale);
    w.dec2(v.ext_list);
    w.dec2(v.ext_tax);
    w.dec2(v.coupon);
    w.dec2(v.net_paid);
    w.dec2(v.net_paid_inc_tax);
    w.dec2(v.net_profit);
    w.end_row();
  }
}

// Return decision for (channel-table, order, line); ~10% of lines return.
inline bool is_returned(const Ctx& ctx, uint64_t sales_table, int64_t order, int line) {
  Rng r(ctx.seed, sales_table + 100, order, line + 1);
  return r.chance(0, 10);
}

inline void gen_store_returns_order(RowWriter& w, const Ctx& ctx, int64_t order) {
  const StoreOrder o = store_order(ctx, order);
  const int nlines = lines_of(ctx, T_STORE_SALES, order, kStore);
  for (int l = 0; l < nlines; ++l) {
    if (!is_returned(ctx, T_STORE_SALES, order, l)) continue;
    const LineVals v = compute_line(ctx, T_STORE_SALES, order, l, false);
    Rng r(ctx.seed, T_STORE_RETURNS, order, l + 1);
    const int64_t ret_date = o.date_sk + 1 + static_cast<int64_t>(r.raw(1) % 90);
    const int64_t rq = 1 + static_cast<int64_t>(r.raw(2) % v.quantity);
    const int64_t ret_amt = v.sales * rq;
    const int64_t ret_tax = v.ext_tax * rq / v.quantity;
    const int64_t fee = 50 + static_cast<int64_t>(r.raw(3) % 9950);
    const int64_t ship = static_cast<int64_t>(r.raw(4) % 5000);
    // split refund across cash / reversed charge / store credit
    const int64_t cash = static_cast<int64_t>(ret_amt * r.unit_f(5));
    const int64_t charge = static_cast<int64_t>((ret_amt - cash) * r.unit_f(6));
    const int64_t credit = ret_amt - cash - charge;
    if (o.d_null) w.null_field(); else w.i64(ret_date);
    if (o.t_null) w.null_field(); else w.i64(o.time_sk);
    w.i64(v.item_sk);
    // 10% of returns are made by a different customer than the purchaser
    const bool other = r.chance(7, 10);
    if (o.c_null) w.null_field();
    else w.i64(other ? r.range(7, 1, ctx.n_customer, 1) : o.customer);
    if (o.cd_null) w.null_field(); else w.i64(o.cdemo);
    if (o.hd_null) w.null_field(); else w.i64(o.hdemo);
    if (o.a_null) w.null_field(); else w.i64(o.addr);
    if (o.s_null) w.null_field(); else w.i64(o.store);
    fk(w, r, 8, ctx.n_reason);
    w.i64(order + 1);  // sr_ticket_number
    w.i64(rq);
    w.dec2(ret_amt);
    w.dec2(ret_tax);
    w.dec2(ret_amt + ret_tax);
    w.dec2(fee);
    w.dec2(ship);
    w.dec2(cash);
    w.dec2(charge);
    w.dec2(credit);
    w.dec2(ret_tax + fee + ship);  // sr_net_loss
    w.end_row();
  }
}

// ---- catalog channel ------------------------------------------------------

struct CatalogOrder {
  int64_t date_sk, time_sk, bill_customer, bill_cdemo, bill_hdemo, bill_addr;
  int64_t ship_customer, ship_cdemo, ship_hdemo, ship_addr;
  int64_t call_center, ship_mode;
  bool d_null, cc_null;
};

inline CatalogOrder catalog_order(const Ctx& ctx, int64_t order) {
  Rng r(ctx.seed, T_CATALOG_SALES, order, 0);
  CatalogOrder o;
  o.date_sk = kSalesFirstSk + static_cast<int64_t>(r.raw(1) % (kSalesLastSk - kSalesFirstSk + 1));
  o.time_sk = static_cast<int64_t>(r.raw(2) % 86400);
  o.bill_customer = r.range(3, 1, ctx.n_customer);
  o.bill_cdemo = r.range(4, 1, 1920800);
  o.bill_hdemo = r.range(5, 1, 7200);
  o.bill_addr = r.range(6, 1, ctx.n_address);
  if (r.chance(7, 85)) {  // ship-to == bill-to for 85% of orders
    o.ship_customer = o.bill_customer;
    o.ship_cdemo = o.bill_cdemo;
    o.ship_hdemo = o.bill_hdemo;
    o.ship_addr = o.bill_addr;
  } else {
    o.ship_customer = r.range(8, 1, ctx.n_customer);
    o.ship_cdemo = r.range(9, 1, 1920800);
    o.ship_hdemo = r.range(10, 1, 7200);
    o.ship_addr = r.range(11, 1, ctx.n_address);
  }
  o.call_center = (r.range(12, 1, (ctx.n_call_center + 1) / 2)) * 2 - 1;  // current SCD rows
  o.ship_mode = r.range(13, 1, 20);
  o.d_null = !r.chance(1, 96, 9);
  o.cc_null = !r.chance(12, 96, 9);
  return o;
}

inline void gen_catalog_sales_order(RowWriter& w, const Ctx& ctx, int64_t order) {
  const CatalogOrder o = catalog_order(ctx, order);
  const int nlines = lines_of(ctx, T_CATALOG_SALES, order, kCatalog);
  for (int l = 0; l < nlines; ++l) {
    const LineVals v = compute_line(ctx, T_CATALOG_SALES, order, l, true);
    Rng r(ctx.seed, T_CATALOG_SALES, order, l + 1);
    if (o.d_null) w.null_field(); else w.i64(o.date_sk);
    w.i64(o.time_sk);
    w.i64(o.date_sk + 2 + static_cast<int64_t>(r.raw(120) % 90));  // cs_ship_date_sk
    w.i64(o.bill_customer);
    w.i64(o.bill_cdemo);
    w.i64(o.bill_hdemo);
    w.i64(o.bill_addr);
    w.i64(o.ship_customer);
    w.i64(o.ship_cdemo);
    w.i64(o.ship_hdemo);
    w.i64(o.ship_addr);
    if (o.cc_null) w.null_field(); else w.i64(o.call_center);
    fk(w, r, 121, ctx.n_catalog_page);
    w.i64(o.ship_mode);
    w.i64(r.range(122, 1, ctx.n_warehouse));
    w.i64(v.item_sk);
    if (v.has_promo) w.i64(v.promo_sk); else w.null_field();
    w.i64(order + 1);  // cs_order_number
    w.i64(v.quantity);
    w.dec2(v.wholesale);
    w.dec2(v.list);
    w.dec2(v.sales);
    w.dec2(v.ext_discount);
    w.dec2(v.ext_sales);
    w.dec2(v.ext_wholesale);
    w.dec2(v.ext_list);
    w.dec2(v.ext_tax);
    w.dec2(v.coupon);
    w.dec2(v.ext_ship);
    w.dec2(v.net_paid);
    w.dec2(v.net_paid_inc_tax);
    w.dec2(v.net_paid_inc_ship);
    w.dec2(v.net_paid_inc_ship_tax);
    w.dec2(v.net_profit);
    w.end_row();
  }
}

inline void gen_catalog_returns_order(RowWriter& w, const Ctx& ctx, int64_t order) {
  const CatalogOrder o = catalog_order(ctx, order);
  const int nlines = lines_of(ctx, T_CATALOG_SALES, order, kCatalog);
  for (int l = 0; l < nlines; ++l) {
    if (!is_returned(ctx, T_CATALOG_SALES, order, l)) continue;
    const LineVals v = compute_line(ctx, T_CATALOG_SALES, order, l, true);
    Rng r(ctx.seed, T_CATALOG_RETURNS, order, l + 1);
    const int64_t ret_date = o.date_sk + 3 + static_cast<int64_t>(r.raw(1) % 90);
    const int64_t rq = 1 + static_cast<int64_t>(r.raw(2) % v.quantity);
    const int64_t ret_amt = v.sales * rq;
    const int64_t ret_tax = v.ext_tax * rq / v.quantity;
    const int64_t fee = 50 + static_cast<int64_t>(r.raw(3) % 9950);
    const int64_t ship = v.ext_ship * rq / v.quantity;
    const int64_t cash = static_cast<int64_t>(ret_amt * r.unit_f(5));
    const int64_t charge = static_cast<int64_t>((ret_amt - cash) * r.unit_f(6));
    const int64_t credit = ret_amt - cash - charge;
    const bool other = r.chance(7, 10);
    const int64_t ret_cust = other ? r.range(7, 1, ctx.n_customer, 1) : o.ship_customer;
    w.i64(ret_date);
    w.i64(o.time_sk);
    w.i64(v.item_sk);
    w.i64(o.bill_customer);
    w.i64(o.bill_cdemo);
    w.i64(o.bill_hdemo);
    w.i64(o.bill_addr);
    w.i64(ret_cust);
    w.i64(o.ship_cdemo);
    w.i64(o.ship_hdemo);
    w.i64(o.ship_addr);
    if (o.cc_null) w.null_field(); else w.i64(o.call_center);
    fk(w, r, 8, ctx.n_catalog_page);
    w.i64(o.ship_mode);
    w.i64(r.range(9, 1, ctx.n_warehouse));
    fk(w, r, 10, ctx.n_reason);
    w.i64(order + 1);
    w.i64(rq);
    w.dec2(ret_amt);
    w.dec2(ret_tax);
    w.dec2(ret_amt + ret_tax);
    w.dec2(fee);
    w.dec2(ship);
    w.dec2(cash);
    w.dec2(charge);
    w.dec2(credit);
    w.dec2(ret_tax + fee + ship);
    w.end_row();
  }
}

// ---- web channel ----------------------------------------------------------

struct WebOrder {
  int64_t date_sk, time_sk, bill_customer, bill_cdemo, bill_hdemo, bill_addr;
  int64_t ship_customer, ship_cdemo, ship_hdemo, ship_addr;
  int64_t web_site, ship_mode;
  bool d_null;
};

inline WebOrder web_order(const Ctx& ctx, int64_t order) {
  Rng r(ctx.seed, T_WEB_SALES, order, 0);
  WebOrder o;
  o.date_sk = kSalesFirstSk + static_cast<int64_t>(r.raw(1) % (kSalesLastSk - kSalesFirstSk + 1));
  o.time_sk = static_cast<int64_t>(r.raw(2) % 86400);
  o.bill_customer = r.range(3, 1, ctx.n_customer);
  o.bill_cdemo = r.range(4, 1, 1920800);
  o.bill_hdemo = r.range(5, 1, 7200);
  o.bill_addr = r.range(6, 1, ctx.n_address);
  if (r.chance(7, 85)) {
    o.ship_customer = o.bill_customer;
    o.ship_cdemo = o.bill_cdemo;
    o.ship_hdemo = o.bill_hdemo;
    o.ship_addr = o.bill_addr;
  } else {
    o.ship_customer = r.range(8, 1, ctx.n_customer);
    o.ship_cdemo = r.range(9, 1, 1920800);
    o.ship_hdemo = r.range(10, 1, 7200);
    o.ship_addr = r.range(11, 1, ctx.n_address);
  }
  o.web_site = (r.range(12, 1, (ctx.n_web_site + 1) / 2)) * 2 - 1;
  o.ship_mode = r.range(13, 1, 20);
  o.d_null = !r.chance(1, 96, 9);
  return o;
}

inline void gen_web_sales_order(RowWriter& w, const Ctx& ctx, int64_t order) {
  const WebOrder o = web_order(ctx, order);
  const int nlines = lines_of(ctx, T_WEB_SALES, order, kWeb);
  for (int l = 0; l < nlines; ++l) {
    const LineVals v = compute_line(ctx, T_WEB_SALES, order, l, true);
    Rng r(ctx.seed, T_WEB_SALES, order, l + 1);
    if (o.d_null) w.null_field(); else w.i64(o.date_sk);
    w.i64(o.time_sk);
    w.i64(o.date_sk + 1 + static_cast<int64_t>(r.raw(120) % 120));  // ws_ship_date_sk
    w.i64(v.item_sk);
    w.i64(o.bill_customer);
    w.i64(o.bill_cdemo);
    w.i64(o.bill_hdemo);
    w.i64(o.bill_addr);
    w.i64(o.ship_customer);
    w.i64(o.ship_cdemo);
    w.i64(o.ship_hdemo);
    w.i64(o.ship_addr);
    fk_odd(w, r, 121, ctx.n_web_page);
    w.i64(o.web_site);
    w.i64(o.ship_mode);
    w.i64(r.range(122, 1, ctx.n_warehouse));
    if (v.has_promo) w.i64(v.promo_sk); else w.null_field();
    w.i64(order + 1);  // ws_order_number
    w.i64(v.quantity);
    w.dec2(v.wholesale);
    w.dec2(v.list);
    w.dec2(v.sales);
    w.dec2(v.ext_discount);
    w.dec2(v.ext_sales);
    w.dec2(v.ext_wholesale);
    w.dec2(v.ext_list);
    w.dec2(v.ext_tax);
    w.dec2(v.coupon);
    w.dec2(v.ext_ship);
    w.dec2(v.net_paid);
    w.dec2(v.net_paid_inc_tax);
    w.dec2(v.net_paid_inc_ship);
    w.dec2(v.net_paid_inc_ship_tax);
    w.dec2(v.net_profit);
    w.end_row();
  }
}

inline void gen_web_returns_order(RowWriter& w, const Ctx& ctx, int64_t order) {
  const WebOrder o = web_order(ctx, order);
  const int nlines = lines_of(ctx, T_WEB_SALES, order, kWeb);
  for (int l = 0; l < nlines; ++l) {
    if (!is_returned(ctx, T_WEB_SALES, order, l)) continue;
    const LineVals v = compute_line(ctx, T_WEB_SALES, order, l, true);
    Rng r(ctx.seed, T_WEB_RETURNS, order, l + 1);
    const int64_t ret_date = o.date_sk + 1 + static_cast<int64_t>(r.raw(1) % 120);
    const int64_t rq = 1 + static_cast<int64_t>(r.raw(2) % v.quantity);
    const int64_t ret_amt = v.sales * rq;
    const int64_t ret_tax = v.ext_tax * rq / v.quantity;
    const int64_t fee = 50 + static_cast<int64_t>(r.raw(3) % 9950);
    const int64_t ship = v.ext_ship * rq / v.quantity;
    const int64_t cash = static_cast<int64_t>(ret_amt * r.unit_f(5));
    const int64_t charge = static_cast<int64_t>((ret_amt - cash) * r.unit_f(6));
    const int64_t credit = ret_amt - cash - charge;
    const bool other = r.chance(7, 10);
    const int64_t ret_cust = other ? r.range(7, 1, ctx.n_customer, 1) : o.ship_customer;
    w.i64(ret_date);
    w.i64(o.time_sk);
    w.i64(v.item_sk);
    w.i64(o.bill_customer);
    w.i64(o.bill_cdemo);
    w.i64(o.bill_hdemo);
    w.i64(o.bill_addr);
    w.i64(ret_cust);
    w.i64(o.ship_cdemo);
    w.i64(o.ship_hdemo);
    w.i64(o.ship_addr);
    fk_odd(w, r, 8, ctx.n_web_page);
    fk(w, r, 10, ctx.n_reason);
    w.i64(order + 1);
    w.i64(rq);
    w.dec2(ret_amt);
    w.dec2(ret_tax);
    w.dec2(ret_amt + ret_tax);
    w.dec2(fee);
    w.dec2(ship);
    w.dec2(cash);
    w.dec2(charge);
    w.dec2(credit);
    w.dec2(ret_tax + fee + ship);
    w.end_row();
  }
}

// ---- inventory ------------------------------------------------------------
// Full cross product: weekly snapshot x (items with odd sk) x warehouses.
inline void gen_inventory(RowWriter& w, const Ctx& ctx, int64_t row) {
  const int64_t n_items = ctx.n_inv_items;
  const int64_t nw = ctx.n_warehouse;
  const int64_t week = row / (n_items * nw);
  const int64_t rem = row % (n_items * nw);
  const int64_t item_ix = rem / nw;
  const int64_t wh = rem % nw;
  Rng r(ctx.seed, T_INVENTORY, row);
  w.i64(kSalesFirstSk + week * 7);
  w.i64(item_ix * 2 + 1);
  w.i64(wh + 1);
  if (r.chance(3, 96))
    w.i64(r.raw(3, 1) % 1000);
  else
    w.null_field();
  w.end_row();
}

}  // namespace ndsgen
