// ndsgen CLI: chunked TPC-DS-shaped data generation.
//
//   ndsgen -scale SF -dir DIR [-parallel N -child I] [-table T] [-update U]
//          [-seed S] [-counts]
//
// Emits {table}_{child}_{parallel}.dat pipe-delimited files into DIR
// (dsdgen's naming convention, which the Python driver relies on when
// assembling per-table directories; reference: nds/nds_gen_data.py:234-242).
// With -update U it emits the refresh-set staging tables instead.

#include <cstdlib>
#include <string>
#include <vector>

#include "refresh.hpp"

namespace ndsgen {

using RowGen = void (*)(RowWriter&, const Ctx&, int64_t);
using UpdateGen = void (*)(RowWriter&, const Ctx&, int, int64_t);

struct TableDef {
  const char* name;
  RowGen gen;              // per-unit generator; unit is a row, or an order
                           // (multi-row) when channel != nullptr
  const Channel* channel;
};

int64_t unit_count(const TableDef& t, const Ctx& ctx) {
  if (t.channel) return channel_orders(*t.channel, ctx.sf);
  if (std::string(t.name) == "inventory")
    return kInventoryWeeks * ctx.n_inv_items * ctx.n_warehouse;
  return dim_rows(t.name, ctx.sf);
}

static const TableDef kTables[] = {
    {"call_center", gen_call_center, nullptr},
    {"catalog_page", gen_catalog_page, nullptr},
    {"catalog_returns", gen_catalog_returns_order, &kCatalog},
    {"catalog_sales", gen_catalog_sales_order, &kCatalog},
    {"customer", gen_customer, nullptr},
    {"customer_address", gen_customer_address, nullptr},
    {"customer_demographics", gen_customer_demographics, nullptr},
    {"date_dim", gen_date_dim, nullptr},
    {"household_demographics", gen_household_demographics, nullptr},
    {"income_band", gen_income_band, nullptr},
    {"inventory", gen_inventory, nullptr},
    {"item", gen_item, nullptr},
    {"promotion", gen_promotion, nullptr},
    {"reason", gen_reason, nullptr},
    {"ship_mode", gen_ship_mode, nullptr},
    {"store", gen_store, nullptr},
    {"store_returns", gen_store_returns_order, &kStore},
    {"store_sales", gen_store_sales_order, &kStore},
    {"time_dim", gen_time_dim, nullptr},
    {"warehouse", gen_warehouse, nullptr},
    {"web_page", gen_web_page, nullptr},
    {"web_returns", gen_web_returns_order, &kWeb},
    {"web_sales", gen_web_sales_order, &kWeb},
    {"web_site", gen_web_site, nullptr},
};

struct UpdateDef {
  const char* name;
  UpdateGen gen;
  int which;  // 0: store-orders count, 1: catalog, 2: web, 3: inventory-week, 4: delete
};

static const UpdateDef kUpdateTables[] = {
    {"s_purchase", gen_s_purchase, 0},
    {"s_purchase_lineitem", gen_s_purchase_lineitem, 0},
    {"s_catalog_order", gen_s_catalog_order, 1},
    {"s_catalog_order_lineitem", gen_s_catalog_order_lineitem, 1},
    {"s_web_order", gen_s_web_order, 2},
    {"s_web_order_lineitem", gen_s_web_order_lineitem, 2},
    {"s_store_returns", gen_s_store_returns, 0},
    {"s_catalog_returns", gen_s_catalog_returns, 1},
    {"s_web_returns", gen_s_web_returns, 2},
    {"s_inventory", gen_s_inventory, 3},
};

int64_t update_unit_count(const UpdateDef& t, const Ctx& ctx) {
  switch (t.which) {
    case 0: return refresh_orders(kStore, ctx.sf);
    case 1: return refresh_orders(kCatalog, ctx.sf);
    case 2: return refresh_orders(kWeb, ctx.sf);
    case 3: return inventory_items(ctx.sf) * ctx.n_warehouse;
  }
  return 0;
}

struct Args {
  double scale = 1.0;
  int parallel = 1;
  int child = 1;
  int update = 0;
  uint64_t seed = 19620718;
  std::string dir = ".";
  std::string table;
  bool counts_only = false;
};

FILE* open_chunk(const Args& a, const std::string& table) {
  std::string path = a.dir + "/" + table + "_" + std::to_string(a.child) + "_" +
                     std::to_string(a.parallel) + ".dat";
  FILE* f = fopen(path.c_str(), "w");
  if (!f) {
    fprintf(stderr, "ndsgen: cannot open %s\n", path.c_str());
    exit(2);
  }
  return f;
}

// chunk [child-1] of [parallel] over n units
void chunk_bounds(int64_t n, int parallel, int child, int64_t* lo, int64_t* hi) {
  *lo = n * (child - 1) / parallel;
  *hi = n * child / parallel;
}

bool known_table(const std::string& name, bool update) {
  if (name.empty()) return true;
  if (update) {
    if (name == "delete" || name == "inventory_delete") return true;
    for (const auto& t : kUpdateTables)
      if (name == t.name) return true;
    return false;
  }
  for (const auto& t : kTables)
    if (name == t.name) return true;
  return false;
}

int run(const Args& a) {
  Ctx ctx(a.scale, a.seed);
  if (!known_table(a.table, a.update > 0)) {
    fprintf(stderr, "ndsgen: unknown table %s%s\n", a.table.c_str(),
            a.update > 0 ? " (update mode generates s_* staging tables)" : "");
    return 2;
  }
  if (a.counts_only) {
    for (const auto& t : kTables) {
      int64_t units = unit_count(t, ctx);
      printf("%s %lld %s\n", t.name, static_cast<long long>(units),
             t.channel ? "orders" : "rows");
    }
    return 0;
  }
  if (a.update > 0) {
    for (const auto& t : kUpdateTables) {
      if (!a.table.empty() && a.table != t.name) continue;
      int64_t lo, hi;
      chunk_bounds(update_unit_count(t, ctx), a.parallel, a.child, &lo, &hi);
      FILE* f = open_chunk(a, t.name);
      {
        RowWriter w(f);
        for (int64_t u = lo; u < hi; ++u) t.gen(w, ctx, a.update, u);
      }
      fclose(f);
    }
    // delete-date tables: chunk 1 only (3 tuples each)
    if (a.child == 1 && (a.table.empty() || a.table == "delete" || a.table == "inventory_delete")) {
      for (const char* name : {"delete", "inventory_delete"}) {
        if (!a.table.empty() && a.table != name) continue;
        FILE* f = open_chunk(a, name);
        {
          RowWriter w(f);
          for (int k = 0; k < 3; ++k)
            gen_delete_range(w, a.update, k, std::string(name) == "inventory_delete");
        }
        fclose(f);
      }
    }
    return 0;
  }
  for (const auto& t : kTables) {
    if (!a.table.empty() && a.table != t.name) continue;
    int64_t lo, hi;
    chunk_bounds(unit_count(t, ctx), a.parallel, a.child, &lo, &hi);
    if (lo >= hi && a.table.empty()) continue;  // tiny dims: child >1 may own nothing
    FILE* f = open_chunk(a, t.name);
    {
      RowWriter w(f);
      for (int64_t u = lo; u < hi; ++u) t.gen(w, ctx, u);
    }
    fclose(f);
  }
  return 0;
}

}  // namespace ndsgen

int main(int argc, char** argv) {
  ndsgen::Args a;
  for (int i = 1; i < argc; ++i) {
    std::string arg = argv[i];
    auto next = [&]() -> const char* {
      if (i + 1 >= argc) {
        fprintf(stderr, "ndsgen: missing value for %s\n", arg.c_str());
        exit(2);
      }
      return argv[++i];
    };
    if (arg == "-scale") a.scale = atof(next());
    else if (arg == "-parallel") a.parallel = atoi(next());
    else if (arg == "-child") a.child = atoi(next());
    else if (arg == "-update") a.update = atoi(next());
    else if (arg == "-seed") a.seed = strtoull(next(), nullptr, 10);
    else if (arg == "-dir") a.dir = next();
    else if (arg == "-table") a.table = next();
    else if (arg == "-counts") a.counts_only = true;
    else {
      fprintf(stderr,
              "usage: ndsgen -scale SF -dir DIR [-parallel N -child I] [-table T]"
              " [-update U] [-seed S] [-counts]\n");
      return 2;
    }
  }
  if (a.child < 1 || a.child > a.parallel) {
    fprintf(stderr, "ndsgen: need 1 <= child <= parallel\n");
    return 2;
  }
  return ndsgen::run(a);
}
