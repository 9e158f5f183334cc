"""Per-query parameter generators for the query templates: a copy of
nds_tpu/datagen/substitutions.py (tests/test_torch_query_streams.py holds
every template's instantiation equal to the reference's).

The dsqgen `define` equivalents: each generator draws this query's
substitution values from a seeded RNG, using the same categorical
vocabularies the data generator emits (native/vocab.hpp), so
predicates hit real data. Sales dates span 1998-01-01..2002-12-31
(kSalesFirstSk..kSalesLastSk in rowcounts.hpp).
"""

from __future__ import annotations

CATEGORIES = [
    "Books", "Children", "Electronics", "Home", "Jewelry",
    "Men", "Music", "Shoes", "Sports", "Women",
]

CLASSES = {
    "Books": ["arts", "business", "computers", "cooking", "history", "mystery", "romance", "science"],
    "Children": ["infants", "newborn", "school-uniforms", "toddlers", "accessories", "shirts", "pants", "swimwear"],
    "Electronics": ["audio", "cameras", "dvd/vcr players", "karoke", "memory", "monitors", "portable", "televisions"],
    "Home": ["bathroom", "bedding", "blinds/shades", "curtains/drapes", "decor", "flatware", "furniture", "kids"],
    "Jewelry": ["birdal", "costume", "diamonds", "estate", "gold", "loose stones", "pendants", "rings"],
    "Men": ["accessories", "pants", "shirts", "sports-apparel", "underwear", "dress shirts", "suits", "casual"],
    "Music": ["classical", "country", "pop", "rock", "jazz", "blues", "folk", "world"],
    "Shoes": ["athletic", "dress", "kids", "mens", "womens", "work", "sandals", "boots"],
    "Sports": ["archery", "baseball", "basketball", "camping", "fishing", "fitness", "golf", "hockey"],
    "Women": ["dresses", "fragrances", "intimates", "maternity", "swimwear", "accessories", "shirts", "pants"],
}

STATES = [
    "AL", "AK", "AZ", "AR", "CA", "CO", "CT", "DE", "FL", "GA", "HI", "ID", "IL",
    "IN", "IA", "KS", "KY", "LA", "ME", "MD", "MA", "MI", "MN", "MS", "MO", "MT",
    "NE", "NV", "NH", "NJ", "NM", "NY", "NC", "ND", "OH", "OK", "OR", "PA", "RI",
    "SC", "SD", "TN", "TX", "UT", "VT", "VA", "WA", "WV", "WI", "WY",
]

COUNTIES = [
    "Williamson County", "Walker County", "Ziebach County", "Richland County",
    "Barrow County", "Bronx County", "Maricopa County", "Jackson County",
    "Franklin County", "Jefferson County", "Washington County", "Lincoln County",
    "Madison County", "Montgomery County", "Clay County", "Marion County",
]

CITIES = [
    "Fairview", "Midway", "Pleasant Hill", "Centerville", "Riverside",
    "Five Points", "Oak Grove", "Pleasant Valley", "Mountain View", "Salem",
    "Union", "Liberty", "Greenville", "Franklin", "Springfield",
]

EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
             "Advanced Degree", "Unknown"]
MARITAL = ["M", "S", "D", "W", "U"]
GENDERS = ["M", "F"]
BUY_POTENTIAL = ["0-500", "501-1000", "1001-5000", "5001-10000", ">10000", "Unknown"]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blue", "blush", "brown", "chartreuse", "chocolate", "coral", "cream",
    "cyan", "firebrick", "forest", "gainsboro", "goldenrod", "green", "grey",
    "honeydew", "indian", "ivory", "khaki", "lavender", "lemon", "light",
    "lime", "linen", "magenta", "maroon", "medium", "midnight", "mint",
    "misty", "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
    "pink", "plum", "powder", "puff", "purple", "red", "rose", "rosy",
    "royal", "saddle", "salmon", "sandy", "seashell", "sienna", "sky",
    "slate", "smoke", "snow", "spring", "steel", "tan", "thistle", "tomato",
    "turquoise", "violet", "wheat", "white", "yellow",
]

SALES_YEARS = (1998, 2002)


def _year(rng, lo=None, hi=None):
    lo = lo or SALES_YEARS[0]
    hi = hi or SALES_YEARS[1]
    return int(rng.integers(lo, hi + 1))


def _choice(rng, xs):
    return xs[int(rng.integers(0, len(xs)))]


def _distinct(rng, xs, n):
    idx = rng.permutation(len(xs))[:n]
    return [xs[i] for i in idx]


def _date_in_year(rng, year, latest_month=11):
    m = int(rng.integers(1, latest_month + 1))
    d = int(rng.integers(1, 29))
    return f"{year}-{m:02d}-{d:02d}"


# columns q4/q11/q74 can project for the year-over-year report
SELECT_ONE = [
    "customer_preferred_cust_flag", "customer_birth_country",
    "customer_login", "customer_email_address",
]


def _zip5(rng, n):
    """n distinct 5-digit zip prefixes (dsqgen ZIPLIST equivalent)."""
    zips = set()
    while len(zips) < n:
        zips.add(f"{int(rng.integers(0, 100000)):05d}")
    return ", ".join(f"'{z}'" for z in sorted(zips))


def q1(rng, scale):
    return {"YEAR": _year(rng), "STATE": _choice(rng, STATES), "AGG_FIELD": "sr_return_amt"}


def q2(rng, scale):
    return {"YEAR": _year(rng, hi=SALES_YEARS[1] - 1)}


def q4(rng, scale):
    return {"YEAR": _year(rng, hi=SALES_YEARS[1] - 1),
            "SELECTONE": _choice(rng, SELECT_ONE)}


def q5(rng, scale):
    year = _year(rng)
    return {"SDATE": _date_in_year(rng, year, 8)}


def q8(rng, scale):
    return {"YEAR": _year(rng), "QOY": int(rng.integers(1, 3)),
            "ZIPLIST": _zip5(rng, 400)}


def q9(rng, scale):
    # bucket thresholds near each quantity-range's expected row count so the
    # CASE exercises both branches (reference: dsqgen RC distributions)
    base = int(2_880_404 * scale * 0.2)
    out = {}
    for i in range(1, 6):
        out[f"RC{i}"] = max(1, int(base * rng.uniform(0.5, 1.5)))
    return out


def q10(rng, scale):
    counties = _distinct(rng, COUNTIES, 5)
    out = {"YEAR": _year(rng), "MONTH": int(rng.integers(1, 5))}
    for i, c in enumerate(counties, 1):
        out[f"COUNTY{i}"] = c
    return out


def q11(rng, scale):
    return q4(rng, scale)


def q16(rng, scale):
    counties = _distinct(rng, COUNTIES, 5)
    out = {"YEAR": _year(rng), "MONTH": int(rng.integers(2, 6)),
           "STATE": _choice(rng, STATES)}
    for i, c in enumerate(counties, 1):
        out[f"COUNTY{i}"] = c
    return out


def q17(rng, scale):
    return {"YEAR": _year(rng)}


def q18(rng, scale):
    months = _distinct(rng, list(range(1, 13)), 6)
    states = _distinct(rng, STATES, 7)
    out = {"YEAR": _year(rng), "GEN": _choice(rng, GENDERS),
           "ES": _choice(rng, EDUCATION[:6])}
    for i, m in enumerate(months, 1):
        out[f"MONTH{i}"] = m
    for i, s in enumerate(states, 1):
        out[f"STATE{i}"] = s
    return out


def q3(rng, scale):
    return {
        "MANUFACT": int(rng.integers(1, 1001)),
        "MONTH": int(rng.integers(11, 13)),
        "AGGC": _choice(
            rng,
            ["ss_ext_sales_price", "ss_sales_price", "ss_ext_discount_amt", "ss_net_profit"],
        ),
    }


def q6(rng, scale):
    return {"YEAR": _year(rng), "MONTH": int(rng.integers(1, 8))}


def q7(rng, scale):
    return {
        "YEAR": _year(rng),
        "GEN": _choice(rng, GENDERS),
        "MS": _choice(rng, MARITAL),
        "ES": _choice(rng, EDUCATION[:6]),
    }


def q12(rng, scale):
    year = _year(rng)
    cats = _distinct(rng, CATEGORIES, 3)
    return {
        "YEAR": year,
        "SDATE": _date_in_year(rng, year, 7),
        "CAT_A": cats[0], "CAT_B": cats[1], "CAT_C": cats[2],
    }


def q13(rng, scale):
    ms = _distinct(rng, MARITAL, 3)
    es = _distinct(rng, EDUCATION[:6], 3)
    st = [_distinct(rng, STATES, 3) for _ in range(3)]
    out = {"MS1": ms[0], "MS2": ms[1], "MS3": ms[2],
           "ES1": es[0], "ES2": es[1], "ES3": es[2]}
    for g, group in enumerate(st, 1):
        for i, s in enumerate(group, 1):
            out[f"STATE{g}{i}"] = s
    return out


def q15(rng, scale):
    return {"YEAR": _year(rng), "QOY": int(rng.integers(1, 3))}


def q19(rng, scale):
    return {
        "YEAR": _year(rng),
        "MONTH": int(rng.integers(11, 13)),
        "MANAGER": int(rng.integers(1, 101)),
    }


def q20(rng, scale):
    return q12(rng, scale)


def q25(rng, scale):
    return {"YEAR": _year(rng)}


def q26(rng, scale):
    return q7(rng, scale)


def q42(rng, scale):
    return {"YEAR": _year(rng), "MONTH": int(rng.integers(11, 13))}


def q43(rng, scale):
    return {"YEAR": _year(rng), "GMT": "-5"}


def q52(rng, scale):
    return q42(rng, scale)


def q55(rng, scale):
    return {"YEAR": _year(rng), "MONTH": int(rng.integers(11, 13)),
            "MANAGER": int(rng.integers(1, 101))}


def q96(rng, scale):
    return {"HOUR": int(rng.integers(15, 21)), "DEPCNT": int(rng.integers(0, 10))}


def q98(rng, scale):
    return q12(rng, scale)


def q37(rng, scale):
    year = _year(rng)
    return {
        "SDATE": _date_in_year(rng, year, 6),
        "PRICE": int(rng.integers(10, 61)),
        "MANU_A": int(rng.integers(1, 1001)),
        "MANU_B": int(rng.integers(1, 1001)),
        "MANU_C": int(rng.integers(1, 1001)),
        "MANU_D": int(rng.integers(1, 1001)),
    }


def q82(rng, scale):
    return q37(rng, scale)


def q41(rng, scale):
    return {"MANUFACT": int(rng.integers(600, 701))}


def q45(rng, scale):
    return {"YEAR": _year(rng), "QOY": int(rng.integers(1, 3))}


def q48(rng, scale):
    ms = _distinct(rng, MARITAL, 3)
    es = _distinct(rng, EDUCATION[:6], 3)
    st = [_distinct(rng, STATES, 3) for _ in range(3)]
    out = {"YEAR": _year(rng),
           "MS1": ms[0], "MS2": ms[1], "MS3": ms[2],
           "ES1": es[0], "ES2": es[1], "ES3": es[2]}
    for g, group in enumerate(st, 1):
        for i, s in enumerate(group, 1):
            out[f"STATE{g}{i}"] = s
    return out


def q61(rng, scale):
    return {"YEAR": _year(rng), "MONTH": int(rng.integers(11, 13)),
            "GMT": "-5", "CATEGORY": _choice(rng, CATEGORIES)}


def q65(rng, scale):
    return {"YEAR": _year(rng)}


def q68(rng, scale):
    cities = _distinct(rng, CITIES, 2)
    return {"YEAR": _year(rng), "CITY_A": cities[0], "CITY_B": cities[1],
            "DEPCNT": int(rng.integers(0, 10)), "VEHCNT": int(rng.integers(-1, 5))}


def q73(rng, scale):
    return {"YEAR": _year(rng),
            "BP1": _choice(rng, BUY_POTENTIAL), "BP2": _choice(rng, BUY_POTENTIAL),
            "COUNTY1": _choice(rng, COUNTIES), "COUNTY2": _choice(rng, COUNTIES),
            "COUNTY3": _choice(rng, COUNTIES), "COUNTY4": _choice(rng, COUNTIES)}


def q79(rng, scale):
    return {"YEAR": _year(rng), "DEPCNT": int(rng.integers(0, 10)),
            "VEHCNT": int(rng.integers(-1, 5))}


def q88(rng, scale):
    return {"STORE": "Unknown", "DEPCNT1": int(rng.integers(0, 5)),
            "DEPCNT2": int(rng.integers(0, 5)), "DEPCNT3": int(rng.integers(0, 5))}


def q93(rng, scale):
    return {"REASON": "reason 28"}


# i_brand = PROMO[cat] + PROMO[cls] + ' #n' (datagen/native/dims.hpp gen_item)
PROMO_NAMES = ["ese", "anti", "ought", "able", "pri", "bar", "cally",
               "ation", "eing", "n st"]
CARRIERS = [
    "UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU", "ZOUROS",
    "MSC", "LATVIAN", "ALLIANCE", "ORIENTAL", "BARIAN", "BOXBUNDLES",
    "RUPEKSA", "HARMSTORF", "PRIVATECARRIER", "DIAMOND", "GREAT EASTERN",
    "GERMA",
]

# d_month_seq = (year-1900)*12 + (month-1); sales span 1998..2002
DMS_RANGE = (1176, 1224)


def _dms(rng):
    return int(rng.integers(DMS_RANGE[0], DMS_RANGE[1] + 1))


def _brand(rng, cat_ix=None, cls_ix=None):
    cat = cat_ix if cat_ix is not None else int(rng.integers(0, 10))
    cls = cls_ix if cls_ix is not None else int(rng.integers(0, 8))
    return f"{PROMO_NAMES[cat]}{PROMO_NAMES[cls]} #{int(rng.integers(1, 11))}"


def _gmt(rng):
    return str(int(rng.integers(-8, -4)))


def _cat_class_brand_group(rng, prefix):
    """Coherent category/class/brand IN-lists over the generated item vocab
    (the reference hardcodes dsdgen's syllable brands; ours differ)."""
    cat_ix = _distinct(rng, list(range(10)), 3)
    out = {}
    for i, ci in enumerate(cat_ix, 1):
        out[f"CAT_{prefix}{i}"] = CATEGORIES[ci]
    cls_ix = [int(rng.integers(0, 8)) for _ in range(4)]
    for i, ki in enumerate(cls_ix, 1):
        out[f"CLASS_{prefix}{i}"] = CLASSES[CATEGORIES[cat_ix[(i - 1) % 3]]][ki]
    for i in range(1, 5):
        out[f"BRAND_{prefix}{i}"] = _brand(rng, cat_ix[(i - 1) % 3],
                                           cls_ix[i - 1])
    return out


def q14(rng, scale):
    return {"YEAR": _year(rng, hi=2000), "DAY": int(rng.integers(1, 29))}


def q21(rng, scale):
    year = _year(rng)
    return {"SDATE": _date_in_year(rng, year, 10)}


def q22(rng, scale):
    return {"DMS": _dms(rng)}


def q23(rng, scale):
    return {"YEAR": _year(rng, hi=1999), "MONTH": int(rng.integers(1, 8))}


def q24(rng, scale):
    colors = _distinct(rng, COLORS, 2)
    return {"MARKET": int(rng.integers(5, 11)),
            "COLOR1": colors[0], "COLOR2": colors[1]}


def q27(rng, scale):
    out = {"YEAR": _year(rng), "GEN": _choice(rng, GENDERS),
           "MS": _choice(rng, MARITAL), "ES": _choice(rng, EDUCATION[:6])}
    for i, s in enumerate(_distinct(rng, STATES, 6), 1):
        out[f"STATE{i}"] = s
    return out


def q28(rng, scale):
    out = {}
    for i in range(1, 7):
        out[f"LP{i}"] = int(rng.integers(90, 191))
        out[f"CA{i}"] = int(rng.integers(0, 12001))
        out[f"WC{i}"] = int(rng.integers(0, 81))
    return out


def q29(rng, scale):
    return {"YEAR": _year(rng, hi=2000), "MONTH": int(rng.integers(1, 10))}


def q30(rng, scale):
    return {"YEAR": _year(rng), "STATE": _choice(rng, STATES)}


def q31(rng, scale):
    return {"YEAR": _year(rng)}


def q32(rng, scale):
    year = _year(rng)
    return {"IMID": int(rng.integers(1, 1001)),
            "SDATE": _date_in_year(rng, year, 9)}


def q33(rng, scale):
    return {"CATEGORY": _choice(rng, CATEGORIES), "YEAR": _year(rng),
            "MONTH": int(rng.integers(1, 13)), "GMT": _gmt(rng)}


def q34(rng, scale):
    bps = _distinct(rng, BUY_POTENTIAL, 2)
    out = {"YEAR": _year(rng, hi=2000), "BP1": bps[0], "BP2": bps[1]}
    for i, c in enumerate(_distinct(rng, COUNTIES, 8), 1):
        out[f"COUNTY{i}"] = c
    return out


def q35(rng, scale):
    return {"YEAR": _year(rng)}


def q36(rng, scale):
    out = {"YEAR": _year(rng)}
    for i, s in enumerate(_distinct(rng, STATES, 8), 1):
        out[f"STATE{i}"] = s
    return out


def q38(rng, scale):
    return {"DMS": _dms(rng)}


def q39(rng, scale):
    return {"YEAR": _year(rng), "MONTH": int(rng.integers(1, 12))}


def q40(rng, scale):
    year = _year(rng)
    return {"SDATE": _date_in_year(rng, year, 10)}


def q44(rng, scale):
    n_stores = max(1, min(12, int(12 * scale))) if scale < 1 else 12
    return {"STORE": int(rng.integers(1, n_stores + 1))}


def q46(rng, scale):
    out = {"YEAR": _year(rng, hi=2000), "DEPCNT": int(rng.integers(0, 10)),
           "VEHCNT": int(rng.integers(-1, 5))}
    for i, c in enumerate(_distinct(rng, CITIES, 5), 1):
        out[f"CITY{i}"] = c
    return out


def q47(rng, scale):
    return {"YEAR": _year(rng, lo=1999, hi=2001)}


def q49(rng, scale):
    return {"YEAR": _year(rng), "MONTH": int(rng.integers(11, 13))}


def q50(rng, scale):
    return {"YEAR": _year(rng), "MONTH": int(rng.integers(8, 11))}


def q51(rng, scale):
    return {"DMS": _dms(rng)}


def q53(rng, scale):
    out = {"DMS": _dms(rng)}
    out.update(_cat_class_brand_group(rng, "A"))
    out.update(_cat_class_brand_group(rng, "B"))
    return out


def q54(rng, scale):
    cat = _choice(rng, CATEGORIES)
    return {"CATEGORY": cat, "CLASS": _choice(rng, CLASSES[cat]),
            "YEAR": _year(rng, hi=2001), "MONTH": int(rng.integers(1, 8))}


def q56(rng, scale):
    colors = _distinct(rng, COLORS, 3)
    return {"COLOR1": colors[0], "COLOR2": colors[1], "COLOR3": colors[2],
            "YEAR": _year(rng), "MONTH": int(rng.integers(1, 13)),
            "GMT": _gmt(rng)}


def q57(rng, scale):
    return {"YEAR": _year(rng, lo=1999, hi=2001)}


def q58(rng, scale):
    year = _year(rng)
    return {"SDATE": _date_in_year(rng, year)}


def q59(rng, scale):
    return {"DMS": int(rng.integers(DMS_RANGE[0], DMS_RANGE[1] - 11))}


def q60(rng, scale):
    return {"CATEGORY": _choice(rng, CATEGORIES), "YEAR": _year(rng),
            "MONTH": int(rng.integers(8, 11)), "GMT": _gmt(rng)}


def q62(rng, scale):
    return {"DMS": _dms(rng)}


def q63(rng, scale):
    return q53(rng, scale)


def q64(rng, scale):
    out = {"YEAR": _year(rng, hi=2001), "PRICE": int(rng.integers(0, 86))}
    for i, c in enumerate(_distinct(rng, COLORS, 6), 1):
        out[f"COLOR{i}"] = c
    return out


def q66(rng, scale):
    carriers = _distinct(rng, CARRIERS, 2)
    return {"YEAR": _year(rng), "TIME": int(rng.integers(0, 57600)),
            "CARRIER_A": carriers[0], "CARRIER_B": carriers[1]}


def q67(rng, scale):
    return {"DMS": _dms(rng)}


def q69(rng, scale):
    out = {"YEAR": _year(rng), "MONTH": int(rng.integers(1, 5))}
    for i, s in enumerate(_distinct(rng, STATES, 3), 1):
        out[f"STATE{i}"] = s
    return out


def q70(rng, scale):
    return {"DMS": _dms(rng)}


def q71(rng, scale):
    return {"MANAGER": int(rng.integers(1, 101)), "YEAR": _year(rng),
            "MONTH": int(rng.integers(11, 13))}


def q72(rng, scale):
    return {"BP": _choice(rng, BUY_POTENTIAL), "YEAR": _year(rng),
            "MS": _choice(rng, MARITAL)}


def q74(rng, scale):
    return {"YEAR": _year(rng, hi=2001)}


def q75(rng, scale):
    return {"CATEGORY": _choice(rng, CATEGORIES),
            "YEAR": _year(rng, lo=1999)}


def q77(rng, scale):
    year = _year(rng)
    return {"SDATE": _date_in_year(rng, year, 10)}


def q78(rng, scale):
    return {"YEAR": _year(rng)}


def q80(rng, scale):
    year = _year(rng)
    return {"SDATE": _date_in_year(rng, year, 10)}


def q81(rng, scale):
    return {"YEAR": _year(rng), "STATE": _choice(rng, STATES)}


def q83(rng, scale):
    year = _year(rng)
    return {"DATE1": _date_in_year(rng, year),
            "DATE2": _date_in_year(rng, year),
            "DATE3": _date_in_year(rng, year)}


def q84(rng, scale):
    return {"CITY": _choice(rng, CITIES),
            "INCOME": int(rng.integers(0, 8)) * 10000}


def q85(rng, scale):
    ms = _distinct(rng, MARITAL, 3)
    es = _distinct(rng, EDUCATION[:6], 3)
    states = _distinct(rng, STATES, 9)
    out = {"YEAR": _year(rng)}
    for i in range(1, 4):
        out[f"MS{i}"] = ms[i - 1]
        out[f"ES{i}"] = es[i - 1]
        for j in range(1, 4):
            out[f"STATE{i}{j}"] = states[(i - 1) * 3 + (j - 1)]
    return out


def q86(rng, scale):
    return {"DMS": _dms(rng)}


def q87(rng, scale):
    return {"DMS": _dms(rng)}


def q89(rng, scale):
    out = {"YEAR": _year(rng)}
    for p in ("A", "B"):
        cats = _distinct(rng, list(range(10)), 3)
        for i, ci in enumerate(cats, 1):
            out[f"CAT_{p}{i}"] = CATEGORIES[ci]
            out[f"CLASS_{p}{i}"] = _choice(rng, CLASSES[CATEGORIES[ci]])
    return out


def q90(rng, scale):
    return {"HOUR_AM": int(rng.integers(6, 12)),
            "HOUR_PM": int(rng.integers(14, 21)),
            "DEPCNT": int(rng.integers(0, 10))}


def q91(rng, scale):
    return {"YEAR": _year(rng), "MONTH": int(rng.integers(11, 13)),
            "GMT": _gmt(rng)}


def q92(rng, scale):
    year = _year(rng)
    return {"IMID": int(rng.integers(1, 1001)),
            "SDATE": _date_in_year(rng, year, 9)}


def q94(rng, scale):
    return {"YEAR": _year(rng), "MONTH": int(rng.integers(2, 11)),
            "STATE": _choice(rng, STATES)}


def q95(rng, scale):
    return q94(rng, scale)


def q97(rng, scale):
    return {"DMS": _dms(rng)}


def q99(rng, scale):
    return {"DMS": _dms(rng)}


PARAM_GENERATORS = {
    1: q1, 2: q2, 3: q3, 4: q4, 5: q5, 6: q6, 7: q7, 8: q8, 9: q9, 10: q10,
    11: q11, 12: q12, 13: q13, 14: q14, 15: q15, 16: q16, 17: q17, 18: q18,
    19: q19, 20: q20, 21: q21, 22: q22, 23: q23, 24: q24, 25: q25, 26: q26,
    27: q27, 28: q28, 29: q29, 30: q30, 31: q31, 32: q32, 33: q33, 34: q34,
    35: q35, 36: q36, 37: q37, 38: q38, 39: q39, 40: q40, 41: q41, 42: q42,
    43: q43, 44: q44, 45: q45, 46: q46, 47: q47, 48: q48, 49: q49, 50: q50,
    51: q51, 52: q52, 53: q53, 54: q54, 55: q55, 56: q56, 57: q57, 58: q58,
    59: q59, 60: q60, 61: q61, 62: q62, 63: q63, 64: q64, 65: q65, 66: q66,
    67: q67, 68: q68, 69: q69, 70: q70, 71: q71, 72: q72, 73: q73, 74: q74,
    75: q75, 77: q77, 78: q78, 79: q79, 80: q80, 81: q81, 82: q82, 83: q83,
    84: q84, 85: q85, 86: q86, 87: q87, 88: q88, 89: q89, 90: q90, 91: q91,
    92: q92, 93: q93, 94: q94, 95: q95, 96: q96, 97: q97, 98: q98, 99: q99,
}
