// Block compression codecs: the crates/simd capability rebuilt in C++.
//
// - ordered u32 blocks (sorted doc ids): delta from a base then bit-pack
//   at the minimal bitwidth (reference bitpacking_u32_ordered.rs:15-237);
// - unordered u32 blocks (term frequencies): bit-pack without delta
//   (bitpacking_u32_unordered.rs);
// - byte-packing at 1/2/3/4 bytes per value for partial (<128) blocks
//   (bytepacking_u32_{ordered,unordered}.rs).
//
// Layout: packed little-endian bitstream, value i occupying bits
// [i*B, (i+1)*B).  Scalar code written for compiler auto-vectorization;
// the numpy twin is index/storage.py's fallback (ops/bitpack.py).

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr int BLOCK = 128;

inline uint32_t bits_needed(uint32_t v) {
    return v == 0 ? 0 : 32 - __builtin_clz(v);
}

void pack_bits(const uint32_t* vals, int n, uint32_t bits, uint8_t* out) {
    // out must hold ceil(n*bits/8) bytes, zeroed by caller.
    uint64_t acc = 0;
    int acc_bits = 0;
    size_t pos = 0;
    for (int i = 0; i < n; i++) {
        acc |= static_cast<uint64_t>(vals[i]) << acc_bits;
        acc_bits += static_cast<int>(bits);
        while (acc_bits >= 8) {
            out[pos++] = static_cast<uint8_t>(acc);
            acc >>= 8;
            acc_bits -= 8;
        }
    }
    if (acc_bits > 0) out[pos++] = static_cast<uint8_t>(acc);
}

void unpack_bits(const uint8_t* in, int n, uint32_t bits, uint32_t* vals) {
    uint64_t acc = 0;
    int acc_bits = 0;
    size_t pos = 0;
    uint64_t mask = bits == 0 ? 0 : ((bits >= 64 ? ~0ull : ((1ull << bits) - 1)));
    for (int i = 0; i < n; i++) {
        while (acc_bits < static_cast<int>(bits)) {
            acc |= static_cast<uint64_t>(in[pos++]) << acc_bits;
            acc_bits += 8;
        }
        vals[i] = static_cast<uint32_t>(acc & mask);
        acc >>= bits;
        acc_bits -= static_cast<int>(bits);
    }
}

}  // namespace

extern "C" {

// ---- full 128-blocks, ordered (delta) ------------------------------------

uint32_t vcbm25_bitwidth_u32_ordered(uint32_t base, const uint32_t* vals) {
    uint32_t maxd = 0;
    uint32_t prev = base;
    for (int i = 0; i < BLOCK; i++) {
        uint32_t d = vals[i] - prev;
        if (d > maxd) maxd = d;
        prev = vals[i];
    }
    return bits_needed(maxd);
}

// Returns packed byte count (= 16 * bits).
size_t vcbm25_compress_u32_ordered(uint32_t base, const uint32_t* vals,
                                   uint32_t bits, uint8_t* out) {
    uint32_t deltas[BLOCK];
    uint32_t prev = base;
    for (int i = 0; i < BLOCK; i++) {
        deltas[i] = vals[i] - prev;
        prev = vals[i];
    }
    size_t nbytes = (static_cast<size_t>(BLOCK) * bits + 7) / 8;
    std::memset(out, 0, nbytes);
    pack_bits(deltas, BLOCK, bits, out);
    return nbytes;
}

void vcbm25_decompress_u32_ordered(uint32_t base, uint32_t bits,
                                   const uint8_t* in, uint32_t* vals) {
    unpack_bits(in, BLOCK, bits, vals);
    uint32_t prev = base;
    for (int i = 0; i < BLOCK; i++) {
        prev += vals[i];
        vals[i] = prev;
    }
}

// ---- full 128-blocks, unordered ------------------------------------------

uint32_t vcbm25_bitwidth_u32_unordered(const uint32_t* vals) {
    uint32_t maxv = 0;
    for (int i = 0; i < BLOCK; i++)
        if (vals[i] > maxv) maxv = vals[i];
    return bits_needed(maxv);
}

size_t vcbm25_compress_u32_unordered(const uint32_t* vals, uint32_t bits,
                                     uint8_t* out) {
    size_t nbytes = (static_cast<size_t>(BLOCK) * bits + 7) / 8;
    std::memset(out, 0, nbytes);
    pack_bits(vals, BLOCK, bits, out);
    return nbytes;
}

void vcbm25_decompress_u32_unordered(uint32_t bits, const uint8_t* in,
                                     uint32_t* vals) {
    unpack_bits(in, BLOCK, bits, vals);
}

// ---- partial blocks (byte-granularity, n < 128) ---------------------------

uint32_t vcbm25_bytewidth_u32_ordered(uint32_t base, const uint32_t* vals,
                                      int n) {
    uint32_t maxd = 0;
    uint32_t prev = base;
    for (int i = 0; i < n; i++) {
        uint32_t d = vals[i] - prev;
        if (d > maxd) maxd = d;
        prev = vals[i];
    }
    uint32_t b = bits_needed(maxd);
    return (b + 7) / 8;  // 0..4 bytes
}

size_t vcbm25_bytepack_u32_ordered(uint32_t base, const uint32_t* vals, int n,
                                   uint32_t width, uint8_t* out) {
    uint32_t prev = base;
    size_t pos = 0;
    for (int i = 0; i < n; i++) {
        uint32_t d = vals[i] - prev;
        prev = vals[i];
        for (uint32_t b = 0; b < width; b++) out[pos++] = (d >> (8 * b)) & 0xFF;
    }
    return pos;
}

void vcbm25_byteunpack_u32_ordered(uint32_t base, uint32_t width,
                                   const uint8_t* in, int n, uint32_t* vals) {
    uint32_t prev = base;
    size_t pos = 0;
    for (int i = 0; i < n; i++) {
        uint32_t d = 0;
        for (uint32_t b = 0; b < width; b++)
            d |= static_cast<uint32_t>(in[pos++]) << (8 * b);
        prev += d;
        vals[i] = prev;
    }
}

uint32_t vcbm25_bytewidth_u32_unordered(const uint32_t* vals, int n) {
    uint32_t maxv = 0;
    for (int i = 0; i < n; i++)
        if (vals[i] > maxv) maxv = vals[i];
    uint32_t b = bits_needed(maxv);
    return (b + 7) / 8;
}

size_t vcbm25_bytepack_u32_unordered(const uint32_t* vals, int n,
                                     uint32_t width, uint8_t* out) {
    size_t pos = 0;
    for (int i = 0; i < n; i++)
        for (uint32_t b = 0; b < width; b++)
            out[pos++] = (vals[i] >> (8 * b)) & 0xFF;
    return pos;
}

void vcbm25_byteunpack_u32_unordered(uint32_t width, const uint8_t* in, int n,
                                     uint32_t* vals) {
    size_t pos = 0;
    for (int i = 0; i < n; i++) {
        uint32_t v = 0;
        for (uint32_t b = 0; b < width; b++)
            v |= static_cast<uint32_t>(in[pos++]) << (8 * b);
        vals[i] = v;
    }
}

// ---- batch interfaces (numpy-friendly) ------------------------------------

// Compress `nblocks` ordered 128-blocks in one call.  bases[nblocks],
// vals[nblocks*128]; out sized worst-case (nblocks*128*4); writes
// bitwidths[nblocks] and out_offsets[nblocks+1].
void vcbm25_compress_blocks_ordered(const uint32_t* bases, const uint32_t* vals,
                                    int64_t nblocks, uint8_t* out,
                                    uint32_t* bitwidths,
                                    int64_t* out_offsets) {
    int64_t pos = 0;
    out_offsets[0] = 0;
    for (int64_t i = 0; i < nblocks; i++) {
        const uint32_t* v = vals + i * BLOCK;
        uint32_t bits = vcbm25_bitwidth_u32_ordered(bases[i], v);
        bitwidths[i] = bits;
        pos += static_cast<int64_t>(
            vcbm25_compress_u32_ordered(bases[i], v, bits, out + pos));
        out_offsets[i + 1] = pos;
    }
}

void vcbm25_decompress_blocks_ordered(const uint32_t* bases,
                                      const uint32_t* bitwidths,
                                      const int64_t* offsets, int64_t nblocks,
                                      const uint8_t* in, uint32_t* vals) {
    for (int64_t i = 0; i < nblocks; i++)
        vcbm25_decompress_u32_ordered(bases[i], bitwidths[i], in + offsets[i],
                                      vals + i * BLOCK);
}

void vcbm25_compress_blocks_unordered(const uint32_t* vals, int64_t nblocks,
                                      uint8_t* out, uint32_t* bitwidths,
                                      int64_t* out_offsets) {
    int64_t pos = 0;
    out_offsets[0] = 0;
    for (int64_t i = 0; i < nblocks; i++) {
        const uint32_t* v = vals + i * BLOCK;
        uint32_t bits = vcbm25_bitwidth_u32_unordered(v);
        bitwidths[i] = bits;
        pos += static_cast<int64_t>(
            vcbm25_compress_u32_unordered(v, bits, out + pos));
        out_offsets[i + 1] = pos;
    }
}

void vcbm25_decompress_blocks_unordered(const uint32_t* bitwidths,
                                        const int64_t* offsets,
                                        int64_t nblocks, const uint8_t* in,
                                        uint32_t* vals) {
    for (int64_t i = 0; i < nblocks; i++)
        vcbm25_decompress_u32_unordered(bitwidths[i], in + offsets[i],
                                        vals + i * BLOCK);
}

// Batch byte-packing for partial blocks (<128 live entries).  The
// reference byte-packs partial blocks and bit-packs only full ones
// (crates/bm25/src/compression.rs:52-62); these walk [nblocks, 128]
// arrays but pack only the first ns[i] entries of each block.

void vcbm25_bytepack_blocks_ordered(const uint32_t* bases, const uint32_t* vals,
                                    const int32_t* ns, int64_t nblocks,
                                    uint8_t* out, uint32_t* widths,
                                    int64_t* out_offsets) {
    int64_t pos = 0;
    out_offsets[0] = 0;
    for (int64_t i = 0; i < nblocks; i++) {
        const uint32_t* v = vals + i * BLOCK;
        int n = ns[i];
        uint32_t w = vcbm25_bytewidth_u32_ordered(bases[i], v, n);
        widths[i] = w;
        pos += static_cast<int64_t>(
            vcbm25_bytepack_u32_ordered(bases[i], v, n, w, out + pos));
        out_offsets[i + 1] = pos;
    }
}

void vcbm25_byteunpack_blocks_ordered(const uint32_t* bases,
                                      const uint32_t* widths,
                                      const int64_t* offsets,
                                      const int32_t* ns, int64_t nblocks,
                                      const uint8_t* in, uint32_t* vals) {
    for (int64_t i = 0; i < nblocks; i++)
        vcbm25_byteunpack_u32_ordered(bases[i], widths[i], in + offsets[i],
                                      ns[i], vals + i * BLOCK);
}

void vcbm25_bytepack_blocks_unordered(const uint32_t* vals, const int32_t* ns,
                                      int64_t nblocks, uint8_t* out,
                                      uint32_t* widths, int64_t* out_offsets) {
    int64_t pos = 0;
    out_offsets[0] = 0;
    for (int64_t i = 0; i < nblocks; i++) {
        const uint32_t* v = vals + i * BLOCK;
        int n = ns[i];
        uint32_t w = vcbm25_bytewidth_u32_unordered(v, n);
        widths[i] = w;
        pos += static_cast<int64_t>(
            vcbm25_bytepack_u32_unordered(v, n, w, out + pos));
        out_offsets[i + 1] = pos;
    }
}

void vcbm25_byteunpack_blocks_unordered(const uint32_t* widths,
                                        const int64_t* offsets,
                                        const int32_t* ns, int64_t nblocks,
                                        const uint8_t* in, uint32_t* vals) {
    for (int64_t i = 0; i < nblocks; i++)
        vcbm25_byteunpack_u32_unordered(widths[i], in + offsets[i], ns[i],
                                        vals + i * BLOCK);
}

}  // extern "C"
