// Native host-side setup kernels.
//
// Reference analog: the C++ mesh/fespace setup machinery of the reference
// library (dof enumeration in fem/fespace.cpp, entity tables in mesh/).  This
// package keeps device compute in XLA, but the *runtime* setup path
// (global dof numbering for million-element meshes, halo table construction)
// is natively implemented here and exposed to Python via ctypes — the
// numpy fallback in fem/fespace.py implements identical semantics.
//
// Build: csrc/build.sh  →  cardiac_ablation_ecm2/_native.so
//
// encode_rows: hash-unique the rows of `main` (n_main × row_len int64),
// assigning ids in first-occurrence order; then map each row of `query` to
// its id (or -1 when absent).  This one primitive covers:
//   * gather-map construction (query == empty)
//   * boundary-dof lookup (query = boundary node keys)
//   * general entity-table building (edges/faces as 2/4-wide rows)

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct RowRef {
    const int64_t* p;
    int64_t len;
};

struct RowHash {
    size_t operator()(const RowRef& r) const {
        // FNV-1a over the raw bytes
        const unsigned char* b = reinterpret_cast<const unsigned char*>(r.p);
        size_t n = static_cast<size_t>(r.len) * sizeof(int64_t);
        size_t h = 1469598103934665603ULL;
        for (size_t i = 0; i < n; ++i) {
            h ^= b[i];
            h *= 1099511628211ULL;
        }
        return h;
    }
};

struct RowEq {
    bool operator()(const RowRef& a, const RowRef& b) const {
        return a.len == b.len &&
               std::memcmp(a.p, b.p, a.len * sizeof(int64_t)) == 0;
    }
};

}  // namespace

extern "C" {

// Returns the number of unique rows in `main`; fills main_ids (n_main) and
// query_ids (n_query, -1 for rows not present in main).
int64_t encode_rows(const int64_t* main, int64_t n_main, const int64_t* query,
                    int64_t n_query, int64_t row_len, int64_t* main_ids,
                    int64_t* query_ids) {
    std::unordered_map<RowRef, int64_t, RowHash, RowEq> table;
    table.reserve(static_cast<size_t>(n_main));
    int64_t next = 0;
    for (int64_t i = 0; i < n_main; ++i) {
        RowRef key{main + i * row_len, row_len};
        auto it = table.find(key);
        if (it == table.end()) {
            table.emplace(key, next);
            main_ids[i] = next;
            ++next;
        } else {
            main_ids[i] = it->second;
        }
    }
    for (int64_t q = 0; q < n_query; ++q) {
        RowRef key{query + q * row_len, row_len};
        auto it = table.find(key);
        query_ids[q] = (it == table.end()) ? -1 : it->second;
    }
    return next;
}

// Counting sort of small-range int64 keys: fills perm with a stable
// permutation sorting `keys` ascending (the restriction scatter-permutation
// builder; reference analog: ElementRestriction offset construction,
// fem/restriction.cpp).  `nbins` must exceed max(keys); keys must be >= 0.
void stable_counting_argsort(const int64_t* keys, int64_t n, int64_t nbins,
                             int64_t* perm) {
    std::vector<int64_t> count(static_cast<size_t>(nbins) + 1, 0);
    for (int64_t i = 0; i < n; ++i) count[keys[i] + 1]++;
    for (int64_t b = 0; b < nbins; ++b) count[b + 1] += count[b];
    for (int64_t i = 0; i < n; ++i) perm[count[keys[i]]++] = i;
}

}  // extern "C"
