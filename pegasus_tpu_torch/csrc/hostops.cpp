// The port's host-side loops, in C++ behind a plain C interface.
//
// The engine's device lane (pack, merge, gather, read) runs on the card;
// what stays on the host around it are these byte loops over KVBlock
// arenas: CRC-64 of keys and digest records, the big-endian packing of
// key prefixes into the u32 lanes the card sorts and searches, the
// gathers that materialize a compaction's output block from its
// survivor index, and the cpu backend's merge ranks. Each function is
// byte-equal to a numpy twin kept beside its call site (`*_plain`).
//
// The library is built with g++ at first use by ops/_build.py and bound
// with ctypes by pegasus_tpu_torch/native/__init__.py, which range-checks
// every index and slice before a call: nothing here checks bounds.

#include <cstdint>
#include <cstring>

namespace {

// CRC-64/XZ (reflected poly 0xC96C5795D7870F42), as base/crc64.py: the
// table of one byte step and its slice-by-8 extensions, filled when the
// library loads.
uint64_t CRC_TABLE[8][256];

struct CrcTables {
    CrcTables() {
        const uint64_t poly = 0xC96C5795D7870F42ULL;
        for (int i = 0; i < 256; i++) {
            uint64_t crc = (uint64_t)i;
            for (int k = 0; k < 8; k++)
                crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
            CRC_TABLE[0][i] = crc;
        }
        for (int t = 1; t < 8; t++)
            for (int i = 0; i < 256; i++)
                CRC_TABLE[t][i] = CRC_TABLE[0][CRC_TABLE[t - 1][i] & 0xFF] ^
                                  (CRC_TABLE[t - 1][i] >> 8);
    }
} crc_tables;

// One string's bytes into a CRC register (the value before the final
// xor), eight bytes a step.
inline uint64_t crc64_register(const uint8_t* p, int64_t len, uint64_t reg) {
    while (len >= 8) {
        uint64_t w;
        memcpy(&w, p, 8);
        reg ^= w;
        reg = CRC_TABLE[7][reg & 0xFF] ^ CRC_TABLE[6][(reg >> 8) & 0xFF] ^
              CRC_TABLE[5][(reg >> 16) & 0xFF] ^
              CRC_TABLE[4][(reg >> 24) & 0xFF] ^
              CRC_TABLE[3][(reg >> 32) & 0xFF] ^
              CRC_TABLE[2][(reg >> 40) & 0xFF] ^
              CRC_TABLE[1][(reg >> 48) & 0xFF] ^ CRC_TABLE[0][reg >> 56];
        p += 8;
        len -= 8;
    }
    while (len-- > 0)
        reg = CRC_TABLE[0][(reg ^ *p++) & 0xFF] ^ (reg >> 8);
    return reg;
}

}  // namespace

extern "C" {

// out[i] = crc64 of arena[offsets[i] .. offsets[i] + lengths[i]).
void crc64_batch(const uint8_t* arena, const int64_t* offsets,
                 const int64_t* lengths, int64_t n, uint64_t* out) {
    for (int64_t i = 0; i < n; i++)
        out[i] = ~crc64_register(arena + offsets[i], lengths[i], ~0ULL);
}

// Continue n CRC registers (before the final xor), each over its own
// slice: reg_out[i] = reg_in[i] advanced over arena[offsets[i] ..
// offsets[i] + lengths[i]). A record hashed in parts, register carried
// from part to part, equals the record hashed whole (the state digest
// hashes each record's fields straight from the block's arenas).
void crc64_update(const uint8_t* arena, const int64_t* offsets,
                  const int64_t* lengths, int64_t n, const uint64_t* reg_in,
                  uint64_t* reg_out) {
    for (int64_t i = 0; i < n; i++)
        reg_out[i] = crc64_register(arena + offsets[i], lengths[i],
                                    reg_in[i]);
}

// Compact the variable-length slices idx[0..nidx) of (arena, off, len32)
// into out (sized by the caller as the sum of the selected lengths),
// writing the new offsets as it goes.
void gather_arena(const uint8_t* arena, const int64_t* off,
                  const int32_t* len32, const int64_t* idx, int64_t nidx,
                  uint8_t* out, int64_t* out_off) {
    int64_t pos = 0;
    for (int64_t i = 0; i < nidx; i++) {
        int64_t j = idx[i];
        int64_t l = (int64_t)len32[j];
        out_off[i] = pos;
        memcpy(out + pos, arena + off[j], (size_t)l);
        pos += l;
    }
}

// Each record's first 4*w key bytes as w big-endian u32 lanes, zero
// padded past the key's end; column-major output: out[col * n + i].
void pack_prefixes(const uint8_t* arena, const int64_t* off,
                   const int32_t* len32, int64_t n, int32_t w,
                   uint32_t* out) {
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* p = arena + off[i];
        int64_t len = (int64_t)len32[i];
        for (int32_t c = 0; c < w; c++) {
            int64_t base = (int64_t)c * 4;
            uint32_t v = 0;
            if (base + 4 <= len) {
                memcpy(&v, p + base, 4);
                v = __builtin_bswap32(v);
            } else {
                for (int b = 0; b < 4; b++) {
                    int64_t k = base + b;
                    v = (v << 8) | (uint32_t)((k < len) ? p[k] : 0);
                }
            }
            out[(int64_t)c * n + i] = v;
        }
    }
}

// A compaction output block from uniform-width records in one pass over
// the survivor index: keys (klen bytes each), values (vlen), expire and
// hash32 (u32) and deleted (u8) move together, so idx is read once, and
// the source rows of a later survivor are prefetched while this one
// copies (the gather is bound by the latency of its random row loads).
void gather_block_uniform(const uint8_t* key_arena, int64_t klen,
                          const uint8_t* val_arena, int64_t vlen,
                          const uint32_t* expire, const uint32_t* hash32,
                          const uint8_t* deleted, const int32_t* idx,
                          int64_t n, uint8_t* out_keys, uint8_t* out_vals,
                          uint32_t* out_expire, uint32_t* out_hash32,
                          uint8_t* out_deleted) {
    const int64_t AHEAD = 24;
    for (int64_t i = 0; i < n; i++) {
        if (i + AHEAD < n) {
            int64_t ja = (int64_t)idx[i + AHEAD];
            __builtin_prefetch(key_arena + ja * klen, 0, 0);
            __builtin_prefetch(val_arena + ja * vlen, 0, 0);
            // a value row can span several cache lines
            if (vlen > 64)
                __builtin_prefetch(val_arena + ja * vlen + 64, 0, 0);
            if (vlen > 128)
                __builtin_prefetch(val_arena + ja * vlen + vlen - 1, 0, 0);
            __builtin_prefetch(expire + ja, 0, 0);
            __builtin_prefetch(hash32 + ja, 0, 0);
            __builtin_prefetch(deleted + ja, 0, 0);
        }
        int64_t j = (int64_t)idx[i];
        memcpy(out_keys + i * klen, key_arena + j * klen, (size_t)klen);
        memcpy(out_vals + i * vlen, val_arena + j * vlen, (size_t)vlen);
        out_expire[i] = expire[j];
        out_hash32[i] = hash32[j];
        out_deleted[i] = deleted[j];
    }
}

// The keys-and-aux half of gather_block_uniform, for the value-residency
// output (ops/compact.py materialize_cached_survivors): its value rows
// are gathered on the card and downloaded, so this loop never touches
// the value arena.
void gather_keys_uniform(const uint8_t* key_arena, int64_t klen,
                         const uint32_t* expire, const uint32_t* hash32,
                         const uint8_t* deleted, const int32_t* idx,
                         int64_t n, uint8_t* out_keys, uint32_t* out_expire,
                         uint32_t* out_hash32, uint8_t* out_deleted) {
    const int64_t AHEAD = 32;
    for (int64_t i = 0; i < n; i++) {
        if (i + AHEAD < n) {
            int64_t ja = (int64_t)idx[i + AHEAD];
            __builtin_prefetch(key_arena + ja * klen, 0, 0);
            __builtin_prefetch(expire + ja, 0, 0);
            __builtin_prefetch(hash32 + ja, 0, 0);
            __builtin_prefetch(deleted + ja, 0, 0);
        }
        int64_t j = (int64_t)idx[i];
        memcpy(out_keys + i * klen, key_arena + j * klen, (size_t)klen);
        out_expire[i] = expire[j];
        out_hash32[i] = hash32[j];
        out_deleted[i] = deleted[j];
    }
}

// For each record of run a (fixed-width keys of itemsize bytes, memcmp
// order), the count of records of run b that are smaller (side 0,
// "left") or smaller or equal (side 1, "right"). Both runs ascending:
// one two-pointer pass, O(na + nb) compares where a binary search per
// record takes O(na log nb).
void merge_counts(const uint8_t* a, int64_t na, const uint8_t* b, int64_t nb,
                  int64_t itemsize, int32_t side, int64_t* out) {
    int64_t j = 0;
    for (int64_t i = 0; i < na; i++) {
        const uint8_t* ka = a + i * itemsize;
        if (side == 0) {
            while (j < nb && memcmp(b + j * itemsize, ka, (size_t)itemsize) < 0)
                j++;
        } else {
            while (j < nb &&
                   memcmp(b + j * itemsize, ka, (size_t)itemsize) <= 0)
                j++;
        }
        out[i] = j;
    }
}

}  // extern "C"
