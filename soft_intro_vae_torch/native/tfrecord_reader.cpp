// TFRecord reader — native replacement for the reference's DareBlopy C++
// dependency (style_soft_intro_vae/dataloader.py:16 uses dareblopy
// ParsedTFRecordsDatasetIterator; this library provides the same capability:
// read TFRecord framing, validate CRC32C, and parse tf.Example protos enough
// to extract named bytes / int64-list features).
//
// Exposed as a small C API consumed from Python via ctypes
// (soft_intro_vae_torch/data/tfrecords.py, which builds it with g++ into
// soft_intro_vae_torch/_build/). No external dependencies. The port's own
// copy of the JAX package's native/tfrecord_reader.cpp, with the same C ABI.
//
// TFRecord framing (TensorFlow format):
//   uint64 length
//   uint32 masked_crc32c(length)
//   byte   data[length]
//   uint32 masked_crc32c(data)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ----------------------------------------------------------- CRC32C ------
uint32_t crc32c_table[256];
bool crc32c_init_done = false;

void crc32c_init() {
    if (crc32c_init_done) return;
    const uint32_t poly = 0x82F63B78u;  // Castagnoli, reflected
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k) c = (c & 1) ? (poly ^ (c >> 1)) : (c >> 1);
        crc32c_table[i] = c;
    }
    crc32c_init_done = true;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
    crc32c_init();
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < n; ++i)
        c = crc32c_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

uint32_t masked_crc(const uint8_t* data, size_t n) {
    uint32_t crc = crc32c(data, n);
    return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ------------------------------------------------------ proto parsing ----
// Minimal wire-format reader for tf.Example:
//   Example { Features features = 1; }
//   Features { repeated (map entry) feature = 1; }
//   map entry { string key = 1; Feature value = 2; }
//   Feature { BytesList bytes_list = 1; FloatList float_list = 2;
//             Int64List int64_list = 3; }
//   BytesList { repeated bytes value = 1; }
//   Int64List { repeated int64 value = 1 [packed]; }

struct Slice {
    const uint8_t* p;
    size_t n;
};

bool read_varint(const uint8_t*& p, const uint8_t* end, uint64_t* out) {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
        uint8_t b = *p++;
        v |= uint64_t(b & 0x7F) << shift;
        if (!(b & 0x80)) { *out = v; return true; }
        shift += 7;
    }
    return false;
}

bool skip_field(uint32_t wire_type, const uint8_t*& p, const uint8_t* end) {
    uint64_t tmp;
    switch (wire_type) {
        case 0: return read_varint(p, end, &tmp);
        case 1: if (end - p < 8) return false; p += 8; return true;
        case 2: if (!read_varint(p, end, &tmp) || uint64_t(end - p) < tmp) return false;
                p += tmp; return true;
        case 5: if (end - p < 4) return false; p += 4; return true;
        default: return false;
    }
}

bool read_len_delim(const uint8_t*& p, const uint8_t* end, Slice* out) {
    uint64_t len;
    if (!read_varint(p, end, &len) || uint64_t(end - p) < len) return false;
    out->p = p;
    out->n = size_t(len);
    p += len;
    return true;
}

// Find feature map entry with the given key inside an Example; returns the
// Feature submessage slice.
bool find_feature(Slice example, const char* key, Slice* feature_out) {
    const uint8_t* p = example.p;
    const uint8_t* end = p + example.n;
    size_t keylen = strlen(key);
    while (p < end) {
        uint64_t tag;
        if (!read_varint(p, end, &tag)) return false;
        uint32_t field = uint32_t(tag >> 3), wt = uint32_t(tag & 7);
        if (field == 1 && wt == 2) {  // features
            Slice features;
            if (!read_len_delim(p, end, &features)) return false;
            const uint8_t* fp = features.p;
            const uint8_t* fend = fp + features.n;
            while (fp < fend) {
                uint64_t ftag;
                if (!read_varint(fp, fend, &ftag)) return false;
                if (uint32_t(ftag >> 3) == 1 && uint32_t(ftag & 7) == 2) {  // map entry
                    Slice entry;
                    if (!read_len_delim(fp, fend, &entry)) return false;
                    const uint8_t* ep = entry.p;
                    const uint8_t* eend = ep + entry.n;
                    Slice k{nullptr, 0}, v{nullptr, 0};
                    while (ep < eend) {
                        uint64_t etag;
                        if (!read_varint(ep, eend, &etag)) return false;
                        uint32_t ef = uint32_t(etag >> 3), ew = uint32_t(etag & 7);
                        if (ef == 1 && ew == 2) { if (!read_len_delim(ep, eend, &k)) return false; }
                        else if (ef == 2 && ew == 2) { if (!read_len_delim(ep, eend, &v)) return false; }
                        else if (!skip_field(ew, ep, eend)) return false;
                    }
                    if (k.p && v.p && k.n == keylen && memcmp(k.p, key, keylen) == 0) {
                        *feature_out = v;
                        return true;
                    }
                } else if (!skip_field(uint32_t(ftag & 7), fp, fend)) {
                    return false;
                }
            }
        } else if (!skip_field(wt, p, end)) {
            return false;
        }
    }
    return false;
}

// Extract first bytes value from Feature{bytes_list{value}}.
bool feature_bytes(Slice feature, Slice* out) {
    const uint8_t* p = feature.p;
    const uint8_t* end = p + feature.n;
    while (p < end) {
        uint64_t tag;
        if (!read_varint(p, end, &tag)) return false;
        if (uint32_t(tag >> 3) == 1 && uint32_t(tag & 7) == 2) {  // bytes_list
            Slice bl;
            if (!read_len_delim(p, end, &bl)) return false;
            const uint8_t* bp = bl.p;
            const uint8_t* bend = bp + bl.n;
            while (bp < bend) {
                uint64_t btag;
                if (!read_varint(bp, bend, &btag)) return false;
                if (uint32_t(btag >> 3) == 1 && uint32_t(btag & 7) == 2)
                    return read_len_delim(bp, bend, out);
                if (!skip_field(uint32_t(btag & 7), bp, bend)) return false;
            }
        } else if (!skip_field(uint32_t(tag & 7), p, end)) {
            return false;
        }
    }
    return false;
}

// Extract int64 list (packed or unpacked) from Feature{int64_list{value}}.
int feature_int64s(Slice feature, int64_t* out, int max_out) {
    const uint8_t* p = feature.p;
    const uint8_t* end = p + feature.n;
    int count = 0;
    while (p < end) {
        uint64_t tag;
        if (!read_varint(p, end, &tag)) return -1;
        if (uint32_t(tag >> 3) == 3 && uint32_t(tag & 7) == 2) {  // int64_list
            Slice il;
            if (!read_len_delim(p, end, &il)) return -1;
            const uint8_t* ip = il.p;
            const uint8_t* iend = ip + il.n;
            while (ip < iend) {
                uint64_t itag;
                if (!read_varint(ip, iend, &itag)) return -1;
                uint32_t iw = uint32_t(itag & 7);
                if (uint32_t(itag >> 3) == 1 && iw == 2) {  // packed
                    Slice packed;
                    if (!read_len_delim(ip, iend, &packed)) return -1;
                    const uint8_t* pp = packed.p;
                    const uint8_t* pend = pp + packed.n;
                    while (pp < pend && count < max_out) {
                        uint64_t v;
                        if (!read_varint(pp, pend, &v)) return -1;
                        out[count++] = int64_t(v);
                    }
                } else if (uint32_t(itag >> 3) == 1 && iw == 0) {  // unpacked
                    uint64_t v;
                    if (!read_varint(ip, iend, &v)) return -1;
                    if (count < max_out) out[count++] = int64_t(v);
                } else if (!skip_field(iw, ip, iend)) {
                    return -1;
                }
            }
        } else if (!skip_field(uint32_t(tag & 7), p, end)) {
            return -1;
        }
    }
    return count;
}

struct Reader {
    FILE* f = nullptr;
    std::vector<uint8_t> buf;
    bool check_crc = true;
    std::string error;
};

}  // namespace

extern "C" {

void* tfr_open(const char* path, int check_crc) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    Reader* r = new Reader();
    r->f = f;
    r->check_crc = check_crc != 0;
    return r;
}

void tfr_close(void* handle) {
    Reader* r = static_cast<Reader*>(handle);
    if (!r) return;
    if (r->f) fclose(r->f);
    delete r;
}

// Read the next record into the reader's buffer.
// Returns record length >= 0, -1 on EOF, -2 on corruption.
long tfr_next(void* handle) {
    Reader* r = static_cast<Reader*>(handle);
    uint8_t header[12];
    if (fread(header, 1, 12, r->f) != 12) return -1;
    uint64_t len;
    memcpy(&len, header, 8);
    uint32_t len_crc;
    memcpy(&len_crc, header + 8, 4);
    if (r->check_crc && masked_crc(header, 8) != len_crc) return -2;
    r->buf.resize(len + 4);
    if (fread(r->buf.data(), 1, len + 4, r->f) != len + 4) return -2;
    if (r->check_crc) {
        uint32_t data_crc;
        memcpy(&data_crc, r->buf.data() + len, 4);
        if (masked_crc(r->buf.data(), len) != data_crc) return -2;
    }
    r->buf.resize(len);
    return long(len);
}

const uint8_t* tfr_record_data(void* handle) {
    return static_cast<Reader*>(handle)->buf.data();
}

// Extract a bytes feature from the current record (a tf.Example).
// Returns length >= 0 and sets *out to an internal pointer, or -1.
long tfr_feature_bytes(void* handle, const char* key, const uint8_t** out) {
    Reader* r = static_cast<Reader*>(handle);
    Slice ex{r->buf.data(), r->buf.size()};
    Slice feat, data;
    if (!find_feature(ex, key, &feat) || !feature_bytes(feat, &data)) return -1;
    *out = data.p;
    return long(data.n);
}

// Extract an int64-list feature; returns count or -1.
int tfr_feature_int64s(void* handle, const char* key, int64_t* out, int max_out) {
    Reader* r = static_cast<Reader*>(handle);
    Slice ex{r->buf.data(), r->buf.size()};
    Slice feat;
    if (!find_feature(ex, key, &feat)) return -1;
    return feature_int64s(feat, out, max_out);
}

// Standalone helpers for testing / writing.
uint32_t tfr_masked_crc(const uint8_t* data, size_t n) { return masked_crc(data, n); }

}  // extern "C"
