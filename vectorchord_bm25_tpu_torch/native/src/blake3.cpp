// BLAKE3 (hash + keyed hash), portable C++ implementation from the public
// specification.  Native hot path for token interning (the reference
// interns with the blake3 crate, crates/bm25/src/vector.rs:19-35); the
// pure-Python implementation in text/blake3.py is the fallback and the
// cross-check oracle.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr uint32_t IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

constexpr int MSG_PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};

constexpr uint32_t CHUNK_START = 1u << 0;
constexpr uint32_t CHUNK_END = 1u << 1;
constexpr uint32_t PARENT = 1u << 2;
constexpr uint32_t ROOT = 1u << 3;
constexpr uint32_t KEYED_HASH = 1u << 4;

constexpr size_t CHUNK_LEN = 1024;
constexpr size_t BLOCK_LEN = 64;

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

inline void g(uint32_t* s, int a, int b, int c, int d, uint32_t mx, uint32_t my) {
    s[a] = s[a] + s[b] + mx;
    s[d] = rotr(s[d] ^ s[a], 16);
    s[c] = s[c] + s[d];
    s[b] = rotr(s[b] ^ s[c], 12);
    s[a] = s[a] + s[b] + my;
    s[d] = rotr(s[d] ^ s[a], 8);
    s[c] = s[c] + s[d];
    s[b] = rotr(s[b] ^ s[c], 7);
}

void compress(const uint32_t cv[8], const uint32_t block[16], uint64_t counter,
              uint32_t block_len, uint32_t flags, uint32_t out[16]) {
    uint32_t s[16] = {
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        static_cast<uint32_t>(counter),
        static_cast<uint32_t>(counter >> 32),
        block_len, flags,
    };
    uint32_t m[16];
    std::memcpy(m, block, sizeof(m));
    for (int r = 0; r < 7; r++) {
        g(s, 0, 4, 8, 12, m[0], m[1]);
        g(s, 1, 5, 9, 13, m[2], m[3]);
        g(s, 2, 6, 10, 14, m[4], m[5]);
        g(s, 3, 7, 11, 15, m[6], m[7]);
        g(s, 0, 5, 10, 15, m[8], m[9]);
        g(s, 1, 6, 11, 12, m[10], m[11]);
        g(s, 2, 7, 8, 13, m[12], m[13]);
        g(s, 3, 4, 9, 14, m[14], m[15]);
        if (r != 6) {
            uint32_t p[16];
            for (int i = 0; i < 16; i++) p[i] = m[MSG_PERM[i]];
            std::memcpy(m, p, sizeof(m));
        }
    }
    for (int i = 0; i < 8; i++) out[i] = s[i] ^ s[i + 8];
    for (int i = 0; i < 8; i++) out[i + 8] = s[i + 8] ^ cv[i];
}

void load_block(const uint8_t* data, size_t len, uint32_t words[16]) {
    uint8_t buf[BLOCK_LEN] = {0};
    std::memcpy(buf, data, len);
    for (int i = 0; i < 16; i++) {
        words[i] = static_cast<uint32_t>(buf[4 * i]) |
                   (static_cast<uint32_t>(buf[4 * i + 1]) << 8) |
                   (static_cast<uint32_t>(buf[4 * i + 2]) << 16) |
                   (static_cast<uint32_t>(buf[4 * i + 3]) << 24);
    }
}

// Process one chunk; returns the chaining value in cv_out, and the final
// block state (for the root case) in last_* when requested.
struct ChunkTail {
    uint32_t cv[8];
    uint32_t block[16];
    uint32_t block_len;
    uint32_t flags;
};

ChunkTail chunk_tail(const uint32_t key[8], const uint8_t* data, size_t len,
                     uint64_t counter, uint32_t flags) {
    ChunkTail t;
    std::memcpy(t.cv, key, sizeof(t.cv));
    size_t nblocks = len <= BLOCK_LEN ? 1 : (len + BLOCK_LEN - 1) / BLOCK_LEN;
    for (size_t i = 0; i + 1 < nblocks; i++) {
        uint32_t words[16];
        load_block(data + i * BLOCK_LEN, BLOCK_LEN, words);
        uint32_t bf = flags | (i == 0 ? CHUNK_START : 0);
        uint32_t out[16];
        compress(t.cv, words, counter, BLOCK_LEN, bf, out);
        std::memcpy(t.cv, out, 8 * sizeof(uint32_t));
    }
    size_t last_off = (nblocks - 1) * BLOCK_LEN;
    size_t last_len = len - last_off;
    load_block(data + last_off, last_len, t.block);
    t.block_len = static_cast<uint32_t>(last_len);
    t.flags = flags | (nblocks == 1 ? CHUNK_START : 0) | CHUNK_END;
    return t;
}

void root_out(const uint32_t cv[8], const uint32_t block[16], uint32_t block_len,
              uint32_t flags, uint8_t* out, size_t out_len) {
    uint64_t counter = 0;
    size_t off = 0;
    while (off < out_len) {
        uint32_t words[16];
        compress(cv, block, counter, block_len, flags | ROOT, words);
        size_t n = out_len - off < 64 ? out_len - off : 64;
        for (size_t i = 0; i < n; i++)
            out[off + i] = static_cast<uint8_t>(words[i / 4] >> (8 * (i % 4)));
        off += n;
        counter++;
    }
}

void blake3_internal(const uint32_t key[8], const uint8_t* data, size_t len,
                     uint32_t flags, uint8_t* out, size_t out_len) {
    size_t nchunks = len <= CHUNK_LEN ? 1 : (len + CHUNK_LEN - 1) / CHUNK_LEN;
    if (nchunks == 1) {
        ChunkTail t = chunk_tail(key, data, len, 0, flags);
        root_out(t.cv, t.block, t.block_len, t.flags, out, out_len);
        return;
    }
    // Chunk CVs, then pairwise-with-carry reduction (equivalent to the
    // left-heavy spec tree).
    size_t cap = nchunks;
    uint32_t* cvs = new uint32_t[cap * 8];
    for (size_t i = 0; i < nchunks; i++) {
        size_t off = i * CHUNK_LEN;
        size_t clen = (i + 1 == nchunks) ? len - off : CHUNK_LEN;
        ChunkTail t = chunk_tail(key, data + off, clen, i, flags);
        uint32_t outw[16];
        compress(t.cv, t.block, i, t.block_len, t.flags, outw);
        std::memcpy(cvs + i * 8, outw, 8 * sizeof(uint32_t));
    }
    size_t n = nchunks;
    while (n > 2) {
        size_t m = 0;
        for (size_t i = 0; i + 1 < n; i += 2) {
            uint32_t words[16];
            std::memcpy(words, cvs + i * 8, 8 * sizeof(uint32_t));
            std::memcpy(words + 8, cvs + (i + 1) * 8, 8 * sizeof(uint32_t));
            uint32_t outw[16];
            compress(key, words, 0, BLOCK_LEN, flags | PARENT, outw);
            std::memcpy(cvs + m * 8, outw, 8 * sizeof(uint32_t));
            m++;
        }
        if (n % 2 == 1) {
            std::memcpy(cvs + m * 8, cvs + (n - 1) * 8, 8 * sizeof(uint32_t));
            m++;
        }
        n = m;
    }
    uint32_t words[16];
    std::memcpy(words, cvs, 8 * sizeof(uint32_t));
    std::memcpy(words + 8, cvs + 8, 8 * sizeof(uint32_t));
    root_out(key, words, BLOCK_LEN, flags | PARENT, out, out_len);
    delete[] cvs;
}

}  // namespace

extern "C" {

void vcbm25_blake3_hash(const uint8_t* data, size_t len, uint8_t* out32) {
    blake3_internal(IV, data, len, 0, out32, 32);
}

void vcbm25_blake3_keyed(const uint8_t* key32, const uint8_t* data, size_t len,
                         uint8_t* out32) {
    uint32_t key[8];
    for (int i = 0; i < 8; i++) {
        key[i] = static_cast<uint32_t>(key32[4 * i]) |
                 (static_cast<uint32_t>(key32[4 * i + 1]) << 8) |
                 (static_cast<uint32_t>(key32[4 * i + 2]) << 16) |
                 (static_cast<uint32_t>(key32[4 * i + 3]) << 24);
    }
    blake3_internal(key, data, len, KEYED_HASH, out32, 32);
}

// Intern hot path: 16-byte truncation of the keyed hash.
void vcbm25_blake3_keyed_hash16(const char* key32, const char* data, size_t len,
                                char* out16) {
    uint8_t full[32];
    vcbm25_blake3_keyed(reinterpret_cast<const uint8_t*>(key32),
                        reinterpret_cast<const uint8_t*>(data), len, full);
    std::memcpy(out16, full, 16);
}

// Batch interning: `n` tokens given as concatenated bytes + offsets
// (offsets[n+1]); writes n*16 bytes of keys, applying the reference's
// intern rule (short strings without NUL embedded verbatim, else keyed
// hash with last-byte-nonzero fix-up; vector.rs:19-35).
void vcbm25_intern_batch(const char* key32, const uint8_t* bytes,
                         const int64_t* offsets, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* tok = bytes + offsets[i];
        size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
        uint8_t* dst = out + i * 16;
        bool short_ok = len < 16;
        if (short_ok) {
            for (size_t j = 0; j < len; j++)
                if (tok[j] == 0) { short_ok = false; break; }
        }
        if (short_ok) {
            std::memset(dst, 0, 16);
            std::memcpy(dst, tok, len);
        } else {
            uint8_t full[32];
            vcbm25_blake3_keyed(reinterpret_cast<const uint8_t*>(key32), tok,
                                len, full);
            std::memcpy(dst, full, 16);
            if (dst[15] == 0) dst[15] = 1;
        }
    }
}

}  // extern "C"
