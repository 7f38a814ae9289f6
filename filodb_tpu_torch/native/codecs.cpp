// NibblePack on the host: the library tier of filodb_tpu_torch/core/encodings.py
// (reference NibblePack.scala:108 pack8 / :395 unpack8).
//
// Wire format, the same as the Python tier's and the JAX package's: groups of
// 8 u64; a nonzero-bitmask byte, then (when any value is nonzero) a header
// byte [trailing-zero nibbles << 4 | nibbles - 1] and the nonzero values'
// nibbles, low nibble first, byte-padded per group.
//
// The _rows entries run the same over many equal-length rows in one call
// (a flush group's columns, a recovery's chunks).
//
// Built by filodb_tpu_torch/native/__init__.py with
//   g++ -O3 -shared -fPIC codecs.cpp -o libfilodbcodecs-<hash>.so

#include <cstdint>

extern "C" {

// Returns the bytes written, or -1 when out_cap is too small.
long fdb_nibble_pack(const uint64_t* in, long n, uint8_t* out, long out_cap) {
    long pos = 0;
    for (long g0 = 0; g0 < n; g0 += 8) {
        int glen = (int)((n - g0) < 8 ? (n - g0) : 8);
        uint8_t bitmask = 0;
        for (int i = 0; i < glen; i++)
            if (in[g0 + i] != 0) bitmask |= (uint8_t)(1u << i);
        if (pos + 1 > out_cap) return -1;
        out[pos++] = bitmask;
        if (bitmask == 0) continue;
        int tz_bits = 64, lz_bits = 64;
        for (int i = 0; i < glen; i++) {
            uint64_t x = in[g0 + i];
            if (x == 0) continue;
            int tz = __builtin_ctzll(x);
            int lz = __builtin_clzll(x);
            if (tz < tz_bits) tz_bits = tz;
            if (lz < lz_bits) lz_bits = lz;
        }
        int tz_nib = tz_bits / 4;
        int lz_nib = lz_bits / 4;
        int nnib = 16 - tz_nib - lz_nib;
        if (nnib < 1) nnib = 1;
        if (pos + 1 > out_cap) return -1;
        out[pos++] = (uint8_t)(((tz_nib & 0xF) << 4) | (nnib - 1));
        uint32_t acc = 0;
        int acc_n = 0;
        for (int i = 0; i < glen; i++) {
            uint64_t x = in[g0 + i];
            if (x == 0) continue;
            x >>= (tz_nib * 4);
            for (int k = 0; k < nnib; k++) {
                acc |= (uint32_t)((x >> (4 * k)) & 0xF) << (4 * acc_n);
                if (++acc_n == 2) {
                    if (pos + 1 > out_cap) return -1;
                    out[pos++] = (uint8_t)acc;
                    acc = 0;
                    acc_n = 0;
                }
            }
        }
        if (acc_n) {
            if (pos + 1 > out_cap) return -1;
            out[pos++] = (uint8_t)acc;
        }
    }
    return pos;
}

// Returns the bytes consumed, or -1 on a truncated or malformed input.
long fdb_nibble_unpack(const uint8_t* in, long in_len, uint64_t* out, long n) {
    long pos = 0;
    long i = 0;
    while (i < n) {
        int glen = (int)((n - i) < 8 ? (n - i) : 8);
        if (pos >= in_len) return -1;
        uint8_t bitmask = in[pos++];
        if (bitmask == 0) {
            for (int b = 0; b < glen; b++) out[i + b] = 0;
            i += glen;
            continue;
        }
        if (pos >= in_len) return -1;
        uint8_t hdr = in[pos++];
        int tz_nib = hdr >> 4;
        int nnib = (hdr & 0xF) + 1;
        int n_nz = __builtin_popcount(bitmask);
        long nbytes = ((long)n_nz * nnib + 1) / 2;
        if (pos + nbytes > in_len) return -1;
        const uint8_t* chunk = in + pos;
        long nib_idx = 0;
        for (int b = 0; b < glen; b++) {
            if (!(bitmask & (1u << b))) {
                out[i + b] = 0;
                continue;
            }
            uint64_t val = 0;
            for (int k = 0; k < nnib; k++) {
                long ni = nib_idx + k;
                uint8_t byte = chunk[ni >> 1];
                uint8_t nib = (ni & 1) ? (byte >> 4) : (byte & 0xF);
                val |= (uint64_t)nib << (4 * k);
            }
            nib_idx += nnib;
            out[i + b] = val << (4 * tz_nib);
        }
        pos += nbytes;
        i += glen;
    }
    return pos;
}

// Packs `rows` rows of n values each: row r's stream goes to out + r * cap,
// its length to lens[r]. Returns 0, or -1 when a row overflows cap.
long fdb_nibble_pack_rows(const uint64_t* in, long rows, long n, uint8_t* out, long cap,
                          long* lens) {
    for (long r = 0; r < rows; r++) {
        long got = fdb_nibble_pack(in + r * n, n, out + r * cap, cap);
        if (got < 0) return -1;
        lens[r] = got;
    }
    return 0;
}

// Unpacks `rows` streams of n values each: row r's stream is in_lens[r]
// bytes at in + offs[r], its values go to out + r * n. Returns 0, or
// -1 - r for the first truncated or malformed row r.
long fdb_nibble_unpack_rows(const uint8_t* in, const long* offs, const long* in_lens, long rows,
                            uint64_t* out, long n) {
    for (long r = 0; r < rows; r++) {
        if (fdb_nibble_unpack(in + offs[r], in_lens[r], out + r * n, n) < 0) return -1 - r;
    }
    return 0;
}

}  // extern "C"
