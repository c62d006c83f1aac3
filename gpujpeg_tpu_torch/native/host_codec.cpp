// Native host entropy codec — the performance-grade CPU path.
//
// Plays the role of the reference's C host coders
// (reference: src/gpujpeg_huffman_cpu_encoder.c, gpujpeg_huffman_cpu_decoder.c):
// sequential T.81 F.1.2 bit emission with 0xFF stuffing on encode, and a
// 16-bit-lookahead table decoder with stuffed-byte skipping and
// corrupt-stream guards on decode. Bit-exact with the NumPy golden coder
// in ops/golden.py (property-tested), ~100x faster, used for the CPU
// fallback paths (restart_interval == 0, tiny segment counts, foreign
// JPEG decode) where the reference also runs on the host
// (reference: gpujpeg_decoder.c:238-252).
//
// Plain C ABI; loaded from Python via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Encode
// ---------------------------------------------------------------------------

struct BitWriter {
    uint8_t* out;
    int64_t pos, cap;
    uint64_t acc;
    int nbits;
    bool overflow;
};

static inline void bw_put(BitWriter& bw, uint32_t code, int length) {
    if (length == 0) return;
    bw.acc = (bw.acc << length) | (code & ((1u << length) - 1));
    bw.nbits += length;
    while (bw.nbits >= 8) {
        uint8_t b = (uint8_t)((bw.acc >> (bw.nbits - 8)) & 0xFF);
        if (bw.pos + 2 > bw.cap) { bw.overflow = true; return; }
        bw.out[bw.pos++] = b;
        if (b == 0xFF) bw.out[bw.pos++] = 0x00;
        bw.nbits -= 8;
        bw.acc &= (1ull << bw.nbits) - 1;
    }
}

static inline int category(int32_t v) {
    uint32_t a = v < 0 ? (uint32_t)(-(int64_t)v) : (uint32_t)v;
    return a == 0 ? 0 : 32 - __builtin_clz(a);
}

// Encode all segments. coeff: (n_blocks, 64) int32 zig-zag, scan order.
// Tables: (n_comp, 256) int32 each. Returns total bytes written, or -1 on
// output overflow. seg_offsets gets n_segments+1 entries.
int64_t gj_huffman_encode_segments(
    const int32_t* coeff, int64_t n_blocks,
    const int32_t* block_comp,
    const int32_t* seg_start, const int32_t* seg_count, int64_t n_segments,
    const int32_t* dc_code, const int32_t* dc_size,
    const int32_t* ac_code, const int32_t* ac_size,
    int64_t n_comp,
    uint8_t* out, int64_t out_cap,
    int64_t* seg_offsets)
{
    (void)n_blocks;
    BitWriter bw{out, 0, out_cap, 0, 0, false};
    for (int64_t s = 0; s < n_segments; ++s) {
        seg_offsets[s] = bw.pos;
        int32_t dc_pred[8] = {0};
        const int64_t start = seg_start[s];
        const int64_t end = start + seg_count[s];
        for (int64_t b = start; b < end; ++b) {
            const int ci = block_comp[b];
            const int32_t* dcc = dc_code + (int64_t)ci * 256;
            const int32_t* dcs = dc_size + (int64_t)ci * 256;
            const int32_t* acc_ = ac_code + (int64_t)ci * 256;
            const int32_t* acs = ac_size + (int64_t)ci * 256;
            const int32_t* cz = coeff + b * 64;

            // DC
            int32_t dc = cz[0];
            int32_t diff = dc - dc_pred[ci];
            dc_pred[ci] = dc;
            int cat = category(diff);
            bw_put(bw, dcc[cat], dcs[cat]);
            if (cat) {
                int32_t v = diff >= 0 ? diff : diff + (1 << cat) - 1;
                bw_put(bw, (uint32_t)v, cat);
            }
            // AC
            int run = 0;
            for (int k = 1; k < 64; ++k) {
                int32_t v = cz[k];
                if (v == 0) { ++run; continue; }
                while (run > 15) {
                    bw_put(bw, acc_[0xF0], acs[0xF0]);
                    run -= 16;
                }
                cat = category(v);
                int sym = (run << 4) | cat;
                bw_put(bw, acc_[sym], acs[sym]);
                int32_t bits = v >= 0 ? v : v + (1 << cat) - 1;
                bw_put(bw, (uint32_t)bits, cat);
                run = 0;
            }
            if (run > 0) bw_put(bw, acc_[0x00], acs[0x00]);
            if (bw.overflow) return -1;
        }
        // byte-align with 1-bits (T.81 F.1.2.3)
        if (bw.nbits & 7) {
            int pad = 8 - (bw.nbits & 7);
            bw_put(bw, (1u << pad) - 1, pad);
        }
        if (bw.overflow) return -1;
    }
    seg_offsets[n_segments] = bw.pos;
    return bw.pos;
}

// ---------------------------------------------------------------------------
// Decode
// ---------------------------------------------------------------------------

struct BitReader {
    const uint8_t* data;
    int64_t pos, len;
    uint64_t acc;
    int nbits;
};

static inline void br_fill(BitReader& br, int need) {
    while (br.nbits < need) {
        uint32_t b = 0;
        if (br.pos < br.len) {
            b = br.data[br.pos++];
            if (b == 0xFF && br.pos < br.len && br.data[br.pos] == 0x00)
                ++br.pos;  // skip stuffed zero
        }
        // fake zeros past the end (corrupt-stream guard,
        // reference: gpujpeg_huffman_cpu_decoder.c:155-159)
        br.acc = (br.acc << 8) | b;
        br.nbits += 8;
    }
}

static inline uint32_t br_get(BitReader& br, int n) {
    if (n == 0) return 0;
    br_fill(br, n);
    uint32_t v = (uint32_t)((br.acc >> (br.nbits - n)) & ((1u << n) - 1));
    br.nbits -= n;
    br.acc &= (1ull << br.nbits) - 1;
    return v;
}

static inline uint32_t br_peek16(BitReader& br) {
    br_fill(br, 16);
    return (uint32_t)((br.acc >> (br.nbits - 16)) & 0xFFFF);
}

static inline int32_t extend(uint32_t v, int cat) {
    if (cat == 0) return 0;
    return (int32_t)v >= (1 << (cat - 1)) ? (int32_t)v
                                          : (int32_t)v - (1 << cat) + 1;
}

static inline int decode_symbol(BitReader& br, const int32_t* lut) {
    int32_t entry = lut[br_peek16(br)];
    int length = entry & 0xFF;
    if (length == 0) { br_get(br, 1); return 0; }  // invalid code guard
    br_get(br, length);
    return entry >> 8;
}

// Decode all segments into coeff (n_blocks, 64) int32 (zeroed by caller
// or here). lut16: (n_tables, 65536) int32 packed sym<<8|len.
void gj_huffman_decode_segments(
    const uint8_t* data, int64_t data_len,
    const int64_t* seg_data_start, const int64_t* seg_data_end,
    const int32_t* seg_block_start, const int32_t* seg_block_count,
    int64_t n_segments,
    const int32_t* block_comp, int64_t n_blocks,
    const int32_t* lut16,
    const int32_t* dc_tab, const int32_t* ac_tab,
    int32_t* coeff)
{
    memset(coeff, 0, (size_t)n_blocks * 64 * sizeof(int32_t));
    for (int64_t s = 0; s < n_segments; ++s) {
        int64_t lo = seg_data_start[s], hi = seg_data_end[s];
        if (lo < 0 || hi > data_len || lo >= hi) continue;
        BitReader br{data + lo, 0, hi - lo, 0, 0};
        int32_t dc_pred[8] = {0};
        const int64_t bstart = seg_block_start[s];
        const int64_t bend = bstart + seg_block_count[s];
        for (int64_t b = bstart; b < bend && b < n_blocks; ++b) {
            const int ci = block_comp[b];
            const int32_t* dlut = lut16 + (int64_t)dc_tab[ci] * 65536;
            const int32_t* alut = lut16 + (int64_t)ac_tab[ci] * 65536;
            int32_t* cz = coeff + b * 64;

            int cat = decode_symbol(br, dlut);
            int32_t diff = cat ? extend(br_get(br, cat), cat) : 0;
            dc_pred[ci] += diff;
            cz[0] = dc_pred[ci];
            int k = 1;
            while (k < 64) {
                int sym = decode_symbol(br, alut);
                int run = sym >> 4, c2 = sym & 0xF;
                if (c2 == 0) {
                    if (run == 15) { k += 16; continue; }  // ZRL
                    break;                                  // EOB
                }
                k += run;
                if (k > 63) break;  // corrupt guard (gpujpeg_table.h:64-83)
                cz[k] = extend(br_get(br, c2), c2);
                ++k;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Scan splitter: find restart-segment boundaries in a scan body
// (reference byte-parse: gpujpeg_reader.c:930-1046). Returns the number of
// segments written, or -(position+1) encoded as negative if no terminating
// marker was found. seg bounds are (start, end) byte offsets into data
// relative to `start`; RST markers excluded. *scan_end gets the offset of
// the terminating 0xFF.
int64_t gj_scan_split(
    const uint8_t* data, int64_t len, int64_t start,
    int64_t* seg_starts, int64_t* seg_ends, int64_t max_segs,
    int64_t* scan_end)
{
    int64_t n = 0;
    int64_t seg_begin = 0;
    const uint8_t* p = data + start;
    const int64_t m = len - start;
    int64_t i = 0;
    while (i + 1 < m) {
        const uint8_t* hit = (const uint8_t*)memchr(p + i, 0xFF, (size_t)(m - i - 1));
        if (!hit) break;
        i = hit - p;
        uint8_t nxt = p[i + 1];
        if (nxt == 0x00) { i += 2; continue; }           // stuffed
        if (nxt >= 0xD0 && nxt <= 0xD7) {                 // RST
            if (i > seg_begin && n < max_segs) {          // drop empty segs
                seg_starts[n] = seg_begin;
                seg_ends[n] = i;
                ++n;
            }
            seg_begin = i + 2;
            i += 2;
            continue;
        }
        // terminating marker
        if (i > seg_begin && n < max_segs) {
            seg_starts[n] = seg_begin;
            seg_ends[n] = i;
            ++n;
        }
        *scan_end = i;
        return n;
    }
    return -(m + 1);
}

// ---------------------------------------------------------------------------
// Destuff one segment's bytes into contiguous big-endian u32 words.
// A per-byte loop runs at ~1.4 ns/byte (6 ms over an 8K scan); 0xFF is
// rare (~1 byte in 85 at Q75 incl. stuffing), so instead memchr to the
// next 0xFF and memcpy the clean run, then pack words with bswap (both
// loops vectorize). staging must hold cap_words*4 + 4 bytes.
static inline int64_t destuff_words(
    const uint8_t* data, int64_t a, int64_t b, int64_t cap_words,
    uint8_t* staging, uint32_t* dst)
{
    const int64_t cap4 = cap_words * 4;
    const uint8_t* p = data + a;
    const uint8_t* endp = data + b;
    int64_t n = 0;
    while (p < endp && n < cap4) {
        const uint8_t* ff =
            (const uint8_t*)memchr(p, 0xFF, (size_t)(endp - p));
        if (!ff) ff = endp;
        int64_t run = ff - p;
        if (run > cap4 - n) run = cap4 - n;
        memcpy(staging + n, p, (size_t)run);
        n += run;
        p += run;
        if (p < endp && p == ff && n < cap4) {
            staging[n++] = 0xFF;
            ++p;
            if (p < endp && *p == 0x00)
                ++p;  // skip stuffed zero
        }
    }
    memset(staging + n, 0, (size_t)((-n) & 3));
    const int64_t w_cnt = (n + 3) >> 2;
    for (int64_t w = 0; w < w_cnt; ++w) {
        uint32_t v;
        memcpy(&v, staging + 4 * w, 4);
        dst[w] = __builtin_bswap32(v);
    }
    return w_cnt;
}

// Decode-side row builder: destuff each segment's bytes into a fixed-pitch
// row matrix of big-endian u32 words (the layout the TPU decode kernel
// consumes). Replaces a per-segment Python loop (~1.8 s at 8K -> ~5 ms).
// rows must be zero-initialized, pitch_words*4 bytes per segment.
int64_t gj_build_rows(
    const uint8_t* data, int64_t data_len,
    const int64_t* lo, const int64_t* hi, int64_t n_segments,
    uint32_t* rows, int64_t pitch_words)
{
    int64_t max_words = 0;
    std::vector<uint8_t> staging((size_t)(pitch_words * 4 + 4));
    for (int64_t s = 0; s < n_segments; ++s) {
        int64_t a = lo[s], b = hi[s];
        if (a < 0 || b > data_len || a >= b) continue;
        int64_t w = destuff_words(data, a, b, pitch_words,
                                  staging.data(), rows + s * pitch_words);
        if (w > max_words) max_words = w;
    }
    return max_words;
}

// Column-major variant: writes word w of segment s at rowsT[w*n_cols + s]
// — the exact transposed (Wcap, S_pad) layout the TPU v3 decode kernel
// consumes, so the host-side 8 MB transpose of the row matrix vanishes.
// Column-major (transposed) destuffed row builder. Naively, each
// segment's ~W words land n_cols*4 bytes apart — every write a cache
// miss (measured 6 ms for 8 MB at 8K). Instead: destuff a tile of
// TB=64 segments into a row-major scratch (sequential writes, fits L1),
// then transpose the tile out — each output row gets a contiguous
// 256 B run. Segment tiles are independent, so they also split across
// threads. Fully writes rowsT (including zero padding and columns past
// n_segments), so callers can pass uninitialized memory.
static int64_t build_rows_t_range(
    const uint8_t* data, int64_t data_len,
    const int64_t* lo, const int64_t* hi, int64_t n_segments,
    uint32_t* rowsT, int64_t n_words, int64_t n_cols,
    int64_t c0, int64_t c1)
{
    constexpr int64_t TB = 64;
    int64_t max_words = 0;
    std::vector<uint32_t> tile((size_t)(TB * n_words));
    std::vector<uint8_t> staging((size_t)(n_words * 4 + 4));
    for (int64_t s0 = c0; s0 < c1; s0 += TB) {
        const int64_t nb = (s0 + TB <= c1) ? TB : (c1 - s0);
        memset(tile.data(), 0, (size_t)(nb * n_words) * sizeof(uint32_t));
        for (int64_t t = 0; t < nb; ++t) {
            const int64_t s = s0 + t;
            if (s >= n_segments) continue;
            int64_t a = lo[s], b = hi[s];
            if (a < 0 || b > data_len || a >= b) continue;
            int64_t w = destuff_words(data, a, b, n_words, staging.data(),
                                      tile.data() + t * n_words);
            if (w > max_words) max_words = w;
        }
        for (int64_t w = 0; w < n_words; ++w) {
            uint32_t* out = rowsT + w * n_cols + s0;
            const uint32_t* src = tile.data() + w;
            for (int64_t t = 0; t < nb; ++t)
                out[t] = src[t * n_words];
        }
    }
    return max_words;
}

int64_t gj_build_rows_t(
    const uint8_t* data, int64_t data_len,
    const int64_t* lo, const int64_t* hi, int64_t n_segments,
    uint32_t* rowsT, int64_t n_words, int64_t n_cols)
{
    if (n_words <= 0 || n_cols <= 0) return 0;
    // thread across 64-column tiles (disjoint, cache-line aligned for
    // any 64-divisible split, so no false sharing)
    const int64_t n_tiles = (n_cols + 63) / 64;
    int64_t n_threads = (int64_t)std::thread::hardware_concurrency();
    if (n_threads > 8) n_threads = 8;
    if (n_threads > n_tiles) n_threads = n_tiles;
    if (n_threads <= 1 || n_cols < (int64_t)16384) {
        return build_rows_t_range(data, data_len, lo, hi, n_segments,
                                  rowsT, n_words, n_cols, 0, n_cols);
    }
    const int64_t tiles_per = (n_tiles + n_threads - 1) / n_threads;
    std::vector<std::thread> threads;
    std::vector<int64_t> maxes((size_t)n_threads, 0);
    for (int64_t k = 0; k < n_threads; ++k) {
        const int64_t c0 = k * tiles_per * 64;
        int64_t c1 = (k + 1) * tiles_per * 64;
        if (c1 > n_cols) c1 = n_cols;
        if (c0 >= c1) break;
        threads.emplace_back([=, &maxes]() {
            maxes[(size_t)k] = build_rows_t_range(
                data, data_len, lo, hi, n_segments,
                rowsT, n_words, n_cols, c0, c1);
        });
    }
    for (auto& th : threads) th.join();
    int64_t max_words = 0;
    for (int64_t m : maxes) if (m > max_words) max_words = m;
    return max_words;
}

}  // extern "C"
