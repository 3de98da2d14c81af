// External-sort infrastructure: the crates/bm25/src/io.rs capability.
//
// The reference's build pipeline spills 64 MiB sorted runs of
// (token_key[16], doc_id, tf) mapping records to disk and k-way merges
// them with per-worker doc-id offset rebasing (io.rs:69-282).  This
// module provides the same primitives over flat binary files of 24-byte
// records, for corpus builds that exceed host RAM:
//
//   record := key[16] | doc_id u32 | tf u32          (24 bytes, LE)
//
// Ordering: (key, doc_id) lexicographic — identical to the reference's
// Mapping ordering (segment.rs:23-45).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Record {
    uint8_t key[16];
    uint32_t doc;
    uint32_t tf;
};

static_assert(sizeof(Record) == 24, "record layout");

inline bool rec_less(const Record& a, const Record& b) {
    int c = std::memcmp(a.key, b.key, 16);
    if (c != 0) return c < 0;
    return a.doc < b.doc;
}

struct HeapItem {
    Record rec;
    int src;
};

struct HeapCmp {
    bool operator()(const HeapItem& a, const HeapItem& b) const {
        if (rec_less(b.rec, a.rec)) return true;
        if (rec_less(a.rec, b.rec)) return false;
        return a.src > b.src;
    }
};

}  // namespace

extern "C" {

// Sort a run of n records in memory (caller-provided buffer).
void vcbm25_sort_mappings(uint8_t* buf, int64_t n) {
    Record* recs = reinterpret_cast<Record*>(buf);
    std::sort(recs, recs + n, rec_less);
}

// Sort the record file at `path` in place (must fit in RAM).
int vcbm25_sort_mappings_file(const char* path) {
    FILE* f = std::fopen(path, "rb+");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    if (size < 0 || size % 24 != 0) {
        std::fclose(f);
        return -2;
    }
    int64_t n = size / 24;
    std::vector<Record> recs(static_cast<size_t>(n));
    std::fseek(f, 0, SEEK_SET);
    if (n && std::fread(recs.data(), 24, static_cast<size_t>(n), f) !=
                 static_cast<size_t>(n)) {
        std::fclose(f);
        return -3;
    }
    std::sort(recs.begin(), recs.end(), rec_less);
    std::fseek(f, 0, SEEK_SET);
    if (n && std::fwrite(recs.data(), 24, static_cast<size_t>(n), f) !=
                 static_cast<size_t>(n)) {
        std::fclose(f);
        return -4;
    }
    std::fclose(f);
    return 0;
}

// K-way merge `n_runs` sorted record files into `out_path`, adding
// doc_offsets[i] to every doc id of run i (the per-worker doc-id
// rebasing of io.rs:131-167).  Buffered streaming; memory O(k).
int vcbm25_merge_mappings(const char** run_paths, const int64_t* doc_offsets,
                          int n_runs, const char* out_path) {
    std::vector<FILE*> fs(static_cast<size_t>(n_runs), nullptr);
    for (int i = 0; i < n_runs; i++) {
        fs[static_cast<size_t>(i)] = std::fopen(run_paths[i], "rb");
        if (!fs[static_cast<size_t>(i)]) {
            for (int j = 0; j < i; j++) std::fclose(fs[static_cast<size_t>(j)]);
            return -1;
        }
    }
    FILE* out = std::fopen(out_path, "wb");
    if (!out) {
        for (auto* f : fs) std::fclose(f);
        return -2;
    }

    std::priority_queue<HeapItem, std::vector<HeapItem>, HeapCmp> heap;
    auto pull = [&](int src) -> bool {
        Record r;
        if (std::fread(&r, 24, 1, fs[static_cast<size_t>(src)]) != 1)
            return false;
        r.doc += static_cast<uint32_t>(doc_offsets[src]);
        heap.push(HeapItem{r, src});
        return true;
    };
    for (int i = 0; i < n_runs; i++) pull(i);
    std::vector<Record> obuf;
    obuf.reserve(4096);
    while (!heap.empty()) {
        HeapItem top = heap.top();
        heap.pop();
        obuf.push_back(top.rec);
        if (obuf.size() == 4096) {
            std::fwrite(obuf.data(), 24, obuf.size(), out);
            obuf.clear();
        }
        pull(top.src);
    }
    if (!obuf.empty()) std::fwrite(obuf.data(), 24, obuf.size(), out);
    for (auto* f : fs) std::fclose(f);
    std::fclose(out);
    return 0;
}

}  // extern "C"
