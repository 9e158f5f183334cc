// Categorical vocabularies for ndsgen. These mirror the value domains the
// TPC-DS spec defines for low-cardinality columns (the values queries filter
// and group on), so generated data exercises the same predicates.
#pragma once

#include <cstddef>

namespace ndsgen::vocab {

inline constexpr const char* kCategories[] = {
    "Books", "Children", "Electronics", "Home", "Jewelry",
    "Men", "Music", "Shoes", "Sports", "Women"};

// i_class values per category (flattened; index = cat*8 + k, 8 classes each).
inline constexpr const char* kClasses[] = {
    // Books
    "arts", "business", "computers", "cooking", "history", "mystery", "romance", "science",
    // Children
    "infants", "newborn", "school-uniforms", "toddlers", "accessories", "shirts", "pants", "swimwear",
    // Electronics
    "audio", "cameras", "dvd/vcr players", "karoke", "memory", "monitors", "portable", "televisions",
    // Home
    "bathroom", "bedding", "blinds/shades", "curtains/drapes", "decor", "flatware", "furniture", "kids",
    // Jewelry
    "birdal", "costume", "diamonds", "estate", "gold", "loose stones", "pendants", "rings",
    // Men
    "accessories", "pants", "shirts", "sports-apparel", "underwear", "dress shirts", "suits", "casual",
    // Music
    "classical", "country", "pop", "rock", "jazz", "blues", "folk", "world",
    // Shoes
    "athletic", "dress", "kids", "mens", "womens", "work", "sandals", "boots",
    // Sports
    "archery", "baseball", "basketball", "camping", "fishing", "fitness", "golf", "hockey",
    // Women
    "dresses", "fragrances", "intimates", "maternity", "swimwear", "accessories", "shirts", "pants"};

inline constexpr const char* kColors[] = {
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black", "blanched",
    "blue", "blush", "brown", "burlywood", "burnished", "chartreuse", "chiffon", "chocolate",
    "coral", "cornflower", "cornsilk", "cream", "cyan", "dark", "deep", "dim",
    "dodger", "drab", "firebrick", "floral", "forest", "frosted", "gainsboro", "ghost",
    "goldenrod", "green", "grey", "honeydew", "hot", "indian", "ivory", "khaki",
    "lace", "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin", "navajo",
    "navy", "olive", "orange", "orchid", "pale", "papaya", "peach", "peru",
    "pink", "plum", "powder", "puff", "purple", "red", "rose", "rosy",
    "royal", "saddle", "salmon", "sandy", "seashell", "sienna", "sky", "slate",
    "smoke", "snow", "spring", "steel", "tan", "thistle", "tomato", "turquoise",
    "violet", "wheat", "white", "yellow"};

inline constexpr const char* kSizes[] = {
    "petite", "small", "medium", "large", "extra large", "economy", "N/A"};

inline constexpr const char* kUnits[] = {
    "Unknown", "Oz", "Bunch", "Ton", "N/A", "Dozen", "Box", "Pound", "Pallet",
    "Gross", "Cup", "Dram", "Each", "Tbl", "Lb", "Bundle", "Tsp", "Ounce", "Case", "Carton"};

inline constexpr const char* kEducation[] = {
    "Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
    "Advanced Degree", "Unknown"};

inline constexpr const char* kMarital[] = {"M", "S", "D", "W", "U"};

inline constexpr const char* kCreditRating[] = {
    "Low Risk", "High Risk", "Good", "Unknown"};

inline constexpr const char* kBuyPotential[] = {
    "0-500", "501-1000", "1001-5000", "5001-10000", ">10000", "Unknown"};

inline constexpr const char* kFirstNames[] = {
    "James", "John", "Robert", "Michael", "William", "David", "Richard", "Charles",
    "Joseph", "Thomas", "Mary", "Patricia", "Linda", "Barbara", "Elizabeth", "Jennifer",
    "Maria", "Susan", "Margaret", "Dorothy", "Daniel", "Paul", "Mark", "Donald",
    "George", "Kenneth", "Steven", "Edward", "Brian", "Ronald", "Anthony", "Kevin",
    "Jason", "Matthew", "Gary", "Timothy", "Jose", "Larry", "Jeffrey", "Frank",
    "Lisa", "Nancy", "Karen", "Betty", "Helen", "Sandra", "Donna", "Carol",
    "Ruth", "Sharon", "Michelle", "Laura", "Sarah", "Kimberly", "Deborah", "Jessica",
    "Shirley", "Cynthia", "Angela", "Melissa", "Brenda", "Amy", "Anna", "Rebecca"};

inline constexpr const char* kLastNames[] = {
    "Smith", "Johnson", "Williams", "Jones", "Brown", "Davis", "Miller", "Wilson",
    "Moore", "Taylor", "Anderson", "Thomas", "Jackson", "White", "Harris", "Martin",
    "Thompson", "Garcia", "Martinez", "Robinson", "Clark", "Rodriguez", "Lewis", "Lee",
    "Walker", "Hall", "Allen", "Young", "Hernandez", "King", "Wright", "Lopez",
    "Hill", "Scott", "Green", "Adams", "Baker", "Gonzalez", "Nelson", "Carter",
    "Mitchell", "Perez", "Roberts", "Turner", "Phillips", "Campbell", "Parker", "Evans",
    "Edwards", "Collins", "Stewart", "Sanchez", "Morris", "Rogers", "Reed", "Cook",
    "Morgan", "Bell", "Murphy", "Bailey", "Rivera", "Cooper", "Richardson", "Cox"};

inline constexpr const char* kStreetNames[] = {
    "Main", "Oak", "Park", "First", "Second", "Third", "Fourth", "Fifth",
    "Cedar", "Elm", "View", "Washington", "Lake", "Hill", "Walnut", "Spring",
    "North", "Ridge", "Church", "Willow", "Mill", "Sunset", "Railroad", "Jackson",
    "Maple", "Pine", "Highland", "Johnson", "Dogwood", "Chestnut", "Laurel", "Poplar",
    "College", "Woodland", "Franklin", "Meadow", "Forest", "Hickory", "Green", "River",
    "Valley", "Smith", "Lincoln", "Davis", "Locust", "Wilson", "Broadway", "Center",
    "Lee", "Birch", "Adams", "Jefferson", "Sycamore", "Miller", "Madison", "Cherry",
    "Eighth", "Sixth", "Seventh", "Ninth", "Tenth", "Eleventh", "Twelfth", "Thirteenth"};

inline constexpr const char* kStreetTypes[] = {
    "Street", "ST", "Avenue", "Ave", "Boulevard", "Blvd", "Road", "RD", "Circle",
    "Cir", "Court", "Ct", "Drive", "Dr", "Lane", "Ln", "Parkway", "Pkwy", "Way", "Wy"};

inline constexpr const char* kCities[] = {
    "Fairview", "Midway", "Oak Grove", "Five Points", "Pleasant Hill", "Centerville",
    "Liberty", "Salem", "Riverside", "Greenville", "Franklin", "Springfield",
    "Farmington", "Union", "Oakland", "Glendale", "Bethel", "Clinton", "Georgetown",
    "Marion", "Greenfield", "Oakdale", "Jamestown", "Kingston", "Waterloo",
    "Summit", "Ashland", "Newport", "Clifton", "Lakeside", "Sunnyside", "Woodville",
    "Glenwood", "Mount Pleasant", "Harmony", "Concord", "Belmont", "Antioch",
    "Arlington", "Bridgeport", "Brownsville", "Buena Vista", "Crossroads", "Deerfield",
    "Edgewood", "Enterprise", "Florence", "Forest Hills", "Friendship", "Hamilton",
    "Highland Park", "Hillcrest", "Hopewell", "Lakeview", "Lebanon", "Lincoln",
    "Macedonia", "Maple Grove", "Mount Olive", "Mount Zion", "New Hope", "Pine Grove",
    "Pleasant Valley", "Providence", "Red Hill", "Riverdale", "Rockwood", "Shady Grove",
    "Shiloh", "Stringtown", "Unionville", "Walnut Grove", "White Oak", "Wildwood"};

// (county, state) pairs; ~30 states weighted toward the populous ones.
inline constexpr const char* kCounties[] = {
    "Williamson County", "Walker County", "Ziebach County", "Richland County",
    "Barrow County", "Bronx County", "Maricopa County", "Jackson County",
    "Franklin County", "Jefferson County", "Washington County", "Lincoln County",
    "Madison County", "Montgomery County", "Clay County", "Marion County",
    "Monroe County", "Greene County", "Wayne County", "Union County",
    "Perry County", "Fairfield County", "Huron County", "Luce County",
    "Dauphin County", "San Miguel County", "Pennington County", "Mobile County",
    "Kittitas County", "Terrell County", "Pipestone County", "Levy County"};

inline constexpr const char* kStates[] = {
    "AL", "AK", "AZ", "AR", "CA", "CO", "CT", "DE", "FL", "GA", "HI", "ID", "IL",
    "IN", "IA", "KS", "KY", "LA", "ME", "MD", "MA", "MI", "MN", "MS", "MO", "MT",
    "NE", "NV", "NH", "NJ", "NM", "NY", "NC", "ND", "OH", "OK", "OR", "PA", "RI",
    "SC", "SD", "TN", "TX", "UT", "VT", "VA", "WA", "WV", "WI", "WY"};

inline constexpr const char* kCountry = "United States";

inline constexpr const char* kLocationTypes[] = {"apartment", "condo", "single family"};

inline constexpr const char* kShipModeTypes[] = {
    "EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY", "LIBRARY"};
inline constexpr const char* kShipModeCodes[] = {"AIR", "SURFACE", "SEA"};
inline constexpr const char* kShipModeCarriers[] = {
    "UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU", "ZOUROS",
    "MSC", "LATVIAN", "ALLIANCE", "ORIENTAL", "BARIAN", "BOXBUNDLES", "RUPEKSA",
    "HARMSTORF", "PRIVATECARRIER", "DIAMOND", "GREAT EASTERN", "GERMA"};

inline constexpr const char* kReasons[] = {
    "Package was damaged", "Stopped working", "Did not get it on time", "Not the product that was ordred",
    "Parts missing", "Does not work with a product that I have", "Gift exchange", "Did not like the color",
    "Did not like the model", "Did not like the make", "Did not like the warranty", "No service location in my area",
    "Found a better price in a store", "Found a better extended warranty in a store", "reason 15", "reason 16",
    "reason 17", "reason 18", "reason 19", "reason 20", "reason 21", "reason 22", "reason 23", "reason 24",
    "reason 25", "reason 26", "reason 27", "reason 28", "reason 29", "reason 30", "reason 31", "reason 32",
    "reason 33", "reason 34", "reason 35", "reason 36", "reason 37", "reason 38", "reason 39", "reason 40",
    "reason 41", "reason 42", "reason 43", "reason 44", "reason 45", "reason 46", "reason 47", "reason 48",
    "reason 49", "reason 50", "reason 51", "reason 52", "reason 53", "reason 54", "reason 55", "reason 56",
    "reason 57", "reason 58", "reason 59", "reason 60", "reason 61", "reason 62", "reason 63", "reason 64",
    "reason 65"};

inline constexpr const char* kPromoNames[] = {
    "ese", "anti", "ought", "able", "pri", "bar", "cally", "ation", "eing", "n st"};
inline constexpr const char* kWebSiteNames[] = {"site_0", "site_1", "site_2", "site_3"};
inline constexpr const char* kMarketClasses[] = {
    "A bit narrow forms matter animals. Consist", "Largely blank years put substantially deaf, new others. Question",
    "Wrong troops shall work sometimes in a opti", "Bites followed via the tough, keen candidates. Beds need other, true l",
    "Admit forms. Tests act curiously. For",  "Express, sorry conditions mean as well gay arms. Real materials ra"};

inline constexpr const char* kMealTimes[] = {"breakfast", "lunch", "dinner"};
inline constexpr const char* kShifts[] = {"first", "second", "third"};
inline constexpr const char* kSubShifts[] = {"morning", "afternoon", "evening", "night"};

inline constexpr const char* kStoreNames[] = {
    "ought", "able", "pri", "ese", "anti", "cally", "ation", "eing", "bar", "n st"};

inline constexpr const char* kDivisionNames[] = {"Unknown", "ably", "ation", "bar", "eing", "ese"};
inline constexpr const char* kCompanyNames[] = {"Unknown", "ally", "ble", "cally", "ought", "pri"};

inline constexpr const char* kCcClass[] = {"small", "medium", "large"};
inline constexpr const char* kCcHours[] = {"8AM-4PM", "8AM-12AM", "8AM-8AM"};
inline constexpr const char* kManagers[] = {
    "Bob Belcher", "Felipe Perkins", "Mark Hightower", "Larry Mccray", "Gary Colburn",
    "Matthew Clifton", "Daniel Weller", "William Ward", "Gregory Altman", "Brandon Moore",
    "Kenneth Harlan", "Scott Smith", "Robert Thompson", "David Lamontagne", "Steven Barnes",
    "Jonathan Smith", "Eric Hoffman", "Phillip Sanders", "Dustin Gamble", "Harold Jones"};

template <typename T, size_t N>
constexpr size_t len(const T (&)[N]) {
  return N;
}

}  // namespace ndsgen::vocab
