// Native part-key index core (counterpart of filodb_tpu/native/index.cpp;
// reference analog: the Rust tantivy index, core/src/rust/filodb_core --
// ingestDocument / queryPartIds hot paths).
//
// Posting lists: tag key -> value -> sorted vector of part ids, plus
// per-part start/end times for range overlap filtering. The Python wrapper
// (memstore/index_native.py) keeps the bitmap index beside it for label
// introspection and the matchers this core does not answer; this core
// answers the hot equality-AND + time-overlap queries and the
// prefix-narrowed regex unions.
//
// Built by g++ at first use (native/__init__.py build_library).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int64_t kAbsent = INT64_MIN;

struct Index {
    // key -> value -> sorted part ids. The value dictionary is ORDERED so
    // anchored-regex/prefix queries narrow to a range scan instead of
    // walking every value (reference: tantivy_utils' range-aware regex).
    std::unordered_map<std::string, std::map<std::string, std::vector<int32_t>>> postings;
    // part ids are dense small ints: flat time vectors beat hash maps on
    // the per-candidate overlap filter (the hot loop of every query)
    std::vector<int64_t> start_ts;
    std::vector<int64_t> end_ts;
    std::vector<int32_t> all_ids;  // sorted

    void set_times(int32_t id, int64_t s, int64_t e) {
        if ((size_t)id >= start_ts.size()) {
            start_ts.resize((size_t)id + 1, kAbsent);
            end_ts.resize((size_t)id + 1, kAbsent);
        }
        start_ts[(size_t)id] = s;
        end_ts[(size_t)id] = e;
    }
    bool overlaps(int32_t id, int64_t qs, int64_t qe) const {
        if ((size_t)id >= start_ts.size()) return false;
        int64_t s = start_ts[(size_t)id];
        int64_t e = end_ts[(size_t)id];
        return s != kAbsent && s <= qe && e != kAbsent && e >= qs;
    }
};

std::string make_key(const char* p, long n) { return std::string(p, (size_t)n); }

void sorted_insert(std::vector<int32_t>& v, int32_t id) {
    auto it = std::lower_bound(v.begin(), v.end(), id);
    if (it == v.end() || *it != id) v.insert(it, id);
}

void sorted_erase(std::vector<int32_t>& v, int32_t id) {
    auto it = std::lower_bound(v.begin(), v.end(), id);
    if (it != v.end() && *it == id) v.erase(it);
}

// walk the ordered value dictionary over the prefix range, calling
// fn(value, postings) for each entry (the ONE definition of the
// prefix-termination rule)
template <typename Fn>
void for_prefix_range(const std::map<std::string, std::vector<int32_t>>& values,
                      const std::string& pre, Fn&& fn) {
    auto it = pre.empty() ? values.begin() : values.lower_bound(pre);
    for (; it != values.end(); ++it) {
        const std::string& v = it->first;
        if (!pre.empty() &&
            (v.size() < pre.size() || v.compare(0, pre.size(), pre) != 0))
            break;  // ordered map: past the prefix range
        fn(v, it->second);
    }
}

// sort+dedup merged ids, apply the [start,end] overlap filter, emit into
// out (clipped to cap); the shared tail of every union query
long emit_union(Index* idx, std::vector<int32_t>& merged,
                int64_t start, int64_t end, int32_t* out, long cap) {
    std::sort(merged.begin(), merged.end());
    merged.erase(std::unique(merged.begin(), merged.end()), merged.end());
    long n_out = 0;
    for (int32_t id : merged) {
        if (!idx->overlaps(id, start, end)) continue;
        if (n_out < cap) out[n_out] = id;
        n_out++;
    }
    return n_out;
}

}  // namespace

extern "C" {

void* fdb_idx_new() { return new Index(); }

void fdb_idx_free(void* h) { delete (Index*)h; }

void fdb_idx_add(void* h, int32_t part_id, int32_t n_pairs,
                 const char** keys, const long* key_lens,
                 const char** vals, const long* val_lens,
                 int64_t start, int64_t end) {
    Index* idx = (Index*)h;
    for (int32_t i = 0; i < n_pairs; i++) {
        auto& post = idx->postings[make_key(keys[i], key_lens[i])][make_key(vals[i], val_lens[i])];
        sorted_insert(post, part_id);
    }
    idx->set_times(part_id, start, end);
    sorted_insert(idx->all_ids, part_id);
}

void fdb_idx_update_end(void* h, int32_t part_id, int64_t end) {
    Index* idx = (Index*)h;
    if ((size_t)part_id < idx->end_ts.size()) idx->end_ts[(size_t)part_id] = end;
}

void fdb_idx_remove(void* h, int32_t part_id, int32_t n_pairs,
                    const char** keys, const long* key_lens,
                    const char** vals, const long* val_lens) {
    Index* idx = (Index*)h;
    for (int32_t i = 0; i < n_pairs; i++) {
        auto kit = idx->postings.find(make_key(keys[i], key_lens[i]));
        if (kit == idx->postings.end()) continue;
        auto vit = kit->second.find(make_key(vals[i], val_lens[i]));
        if (vit == kit->second.end()) continue;
        sorted_erase(vit->second, part_id);
        if (vit->second.empty()) kit->second.erase(vit);
    }
    if ((size_t)part_id < idx->start_ts.size()) {
        idx->start_ts[(size_t)part_id] = kAbsent;
        idx->end_ts[(size_t)part_id] = kAbsent;
    }
    sorted_erase(idx->all_ids, part_id);
}

// AND of equality terms + [start,end] overlap. Returns count written
// (clipped to cap); -1 signals "no equality terms" (caller scans all).
long fdb_idx_query(void* h, int32_t n_terms,
                   const char** keys, const long* key_lens,
                   const char** vals, const long* val_lens,
                   int64_t start, int64_t end,
                   int32_t* out, long cap) {
    Index* idx = (Index*)h;
    if (n_terms == 0) return -1;
    // find smallest posting list first
    const std::vector<int32_t>* lists[64];
    if (n_terms > 64) return -2;
    for (int32_t i = 0; i < n_terms; i++) {
        auto kit = idx->postings.find(make_key(keys[i], key_lens[i]));
        if (kit == idx->postings.end()) return 0;
        auto vit = kit->second.find(make_key(vals[i], val_lens[i]));
        if (vit == kit->second.end()) return 0;
        lists[i] = &vit->second;
    }
    std::sort(lists, lists + n_terms,
              [](const std::vector<int32_t>* a, const std::vector<int32_t>* b) {
                  return a->size() < b->size();
              });
    long n_out = 0;
    for (int32_t id : *lists[0]) {
        bool ok = true;
        for (int32_t i = 1; i < n_terms && ok; i++) {
            const auto& l = *lists[i];
            ok = std::binary_search(l.begin(), l.end(), id);
        }
        if (!ok) continue;
        if (!idx->overlaps(id, start, end)) continue;
        if (n_out < cap) out[n_out] = id;
        n_out++;
    }
    return n_out;
}

// ids of every series matching one key=value (for regex unions in python)
long fdb_idx_postings_of(void* h, const char* key, long key_len,
                         const char* val, long val_len,
                         int32_t* out, long cap) {
    Index* idx = (Index*)h;
    auto kit = idx->postings.find(make_key(key, key_len));
    if (kit == idx->postings.end()) return 0;
    auto vit = kit->second.find(make_key(val, val_len));
    if (vit == kit->second.end()) return 0;
    long n = (long)vit->second.size();
    long w = n < cap ? n : cap;
    std::memcpy(out, vit->second.data(), (size_t)w * sizeof(int32_t));
    return n;
}

// values of ``key`` starting with ``prefix``, packed as
// [u32 len][bytes]... into out. Returns the number of values found (the
// caller grows the buffer and retries when the returned byte length in
// *used exceeds cap). An empty prefix scans the whole dictionary.
long fdb_idx_values_prefix(void* h, const char* key, long key_len,
                           const char* prefix, long prefix_len,
                           char* out, long cap, long* used) {
    Index* idx = (Index*)h;
    auto kit = idx->postings.find(make_key(key, key_len));
    *used = 0;
    if (kit == idx->postings.end()) return 0;
    long n = 0;
    long w = 0;
    for_prefix_range(kit->second, make_key(prefix, prefix_len),
                     [&](const std::string& v, const std::vector<int32_t>&) {
        long need = 4 + (long)v.size();
        if (w + need <= cap) {
            uint32_t len = (uint32_t)v.size();
            std::memcpy(out + w, &len, 4);
            std::memcpy(out + w + 4, v.data(), v.size());
        }
        w += need;
        n++;
    });
    *used = w;
    return n;
}

// sorted unique union of postings for ``key`` over the given values,
// filtered by [start, end] overlap. Returns count written (clipped to cap).
long fdb_idx_union(void* h, const char* key, long key_len,
                   int32_t n_vals, const char** vals, const long* val_lens,
                   int64_t start, int64_t end, int32_t* out, long cap) {
    Index* idx = (Index*)h;
    auto kit = idx->postings.find(make_key(key, key_len));
    if (kit == idx->postings.end()) return 0;
    std::vector<int32_t> merged;
    for (int32_t i = 0; i < n_vals; i++) {
        auto vit = kit->second.find(make_key(vals[i], val_lens[i]));
        if (vit == kit->second.end()) continue;
        merged.insert(merged.end(), vit->second.begin(), vit->second.end());
    }
    return emit_union(idx, merged, start, end, out, cap);
}

// union of postings for EVERY value of ``key`` in the prefix range —
// the pure-prefix regex (``http_.*``) answered entirely inside the core,
// no per-value matching anywhere.
long fdb_idx_union_prefix(void* h, const char* key, long key_len,
                          const char* prefix, long prefix_len,
                          int64_t start, int64_t end,
                          int32_t* out, long cap) {
    Index* idx = (Index*)h;
    auto kit = idx->postings.find(make_key(key, key_len));
    if (kit == idx->postings.end()) return 0;
    std::vector<int32_t> merged;
    for_prefix_range(kit->second, make_key(prefix, prefix_len),
                     [&](const std::string&, const std::vector<int32_t>& ids) {
        merged.insert(merged.end(), ids.begin(), ids.end());
    });
    return emit_union(idx, merged, start, end, out, cap);
}

long fdb_idx_size(void* h) { return (long)((Index*)h)->all_ids.size(); }

long fdb_idx_all(void* h, int64_t start, int64_t end, int32_t* out, long cap) {
    Index* idx = (Index*)h;
    long n_out = 0;
    for (int32_t id : idx->all_ids) {
        if (!idx->overlaps(id, start, end)) continue;
        if (n_out < cap) out[n_out] = id;
        n_out++;
    }
    return n_out;
}

}  // extern "C"
