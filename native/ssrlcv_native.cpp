// Native IO runtime for ssrlcv_tpu.
//
// The reference implements its IO layer natively (vendored tinyply PLY codec,
// tinyply.{h,cpp}; Unity<T> binary checkpoint writer/reader, Unity.cuh:924-971
// / :467-531; raw image buffer plumbing in io_util.cpp).  This library is the
// package's equivalent: a small C++17 codec core for the hot host-side IO
// paths — binary PLY encode/decode and the .uty checkpoint format — exposed
// through a C ABI consumed via ctypes (no pybind11 dependency).
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Binary PLY writer: points (N,3) float32 + optional colors (N,3) uint8 +
// optional triangular faces (F,3) int32.  Returns 0 on success.
// ---------------------------------------------------------------------------
int ply_write(const char *path,
              const float *points, int64_t n_points,
              const uint8_t *colors,          // nullable
              const int32_t *faces, int64_t n_faces) {
    FILE *f = std::fopen(path, "wb");
    if (!f) return -1;

    std::string header = "ply\nformat binary_little_endian 1.0\n";
    header += "comment generated by ssrlcv_tpu native codec\n";
    header += "element vertex " + std::to_string(n_points) + "\n";
    header += "property float x\nproperty float y\nproperty float z\n";
    if (colors) {
        header += "property uchar red\nproperty uchar green\nproperty uchar blue\n";
    }
    if (faces && n_faces > 0) {
        header += "element face " + std::to_string(n_faces) + "\n";
        header += "property list uchar int vertex_indices\n";
    }
    header += "end_header\n";
    if (std::fwrite(header.data(), 1, header.size(), f) != header.size()) {
        std::fclose(f);
        return -2;
    }

    if (colors) {
        // interleave 12B position + 3B color rows through a buffer
        const size_t row = 15;
        std::vector<uint8_t> buf(row * (size_t)n_points);
        for (int64_t i = 0; i < n_points; ++i) {
            std::memcpy(&buf[i * row], &points[i * 3], 12);
            std::memcpy(&buf[i * row + 12], &colors[i * 3], 3);
        }
        if (std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
            std::fclose(f);
            return -3;
        }
    } else {
        size_t bytes = (size_t)n_points * 12;
        if (std::fwrite(points, 1, bytes, f) != bytes) {
            std::fclose(f);
            return -3;
        }
    }

    if (faces && n_faces > 0) {
        const size_t row = 13;  // 1B count + 3*4B indices
        std::vector<uint8_t> buf(row * (size_t)n_faces);
        for (int64_t i = 0; i < n_faces; ++i) {
            buf[i * row] = 3;
            std::memcpy(&buf[i * row + 1], &faces[i * 3], 12);
        }
        if (std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
            std::fclose(f);
            return -4;
        }
    }
    std::fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// .uty checkpoint codec (the reference Unity<T> binary format):
//   <typeid name>\n <u64 hash>\n <i32 state><u64 count>\n <raw bytes>
// ---------------------------------------------------------------------------
int uty_write(const char *path, const char *type_name, uint64_t hash_code,
              int32_t state, const void *data, uint64_t count,
              uint64_t elem_size) {
    FILE *f = std::fopen(path, "wb");
    if (!f) return -1;
    char eol = '\n';
    size_t name_len = std::strlen(type_name);
    bool ok = std::fwrite(type_name, 1, name_len, f) == name_len
        && std::fwrite(&eol, 1, 1, f) == 1
        && std::fwrite(&hash_code, 8, 1, f) == 1
        && std::fwrite(&eol, 1, 1, f) == 1
        && std::fwrite(&state, 4, 1, f) == 1
        && std::fwrite(&count, 8, 1, f) == 1
        && std::fwrite(&eol, 1, 1, f) == 1
        && std::fwrite(data, elem_size, count, f) == count;
    std::fclose(f);
    return ok ? 0 : -2;
}

// Parse a .uty header; returns 0 and fills outputs on success.
// body_offset receives the byte offset of the raw element data.
int uty_read_header(const char *path, char *type_name_out, int name_cap,
                    uint64_t *hash_out, int32_t *state_out,
                    uint64_t *count_out, uint64_t *body_offset_out) {
    FILE *f = std::fopen(path, "rb");
    if (!f) return -1;
    std::string name;
    int c;
    while ((c = std::fgetc(f)) != EOF && c != '\n') name.push_back((char)c);
    if (c == EOF || (int)name.size() >= name_cap) { std::fclose(f); return -2; }
    uint64_t hash = 0, count = 0;
    int32_t state = 0;
    char eol;
    bool ok = std::fread(&hash, 8, 1, f) == 1
        && std::fread(&eol, 1, 1, f) == 1 && eol == '\n'
        && std::fread(&state, 4, 1, f) == 1
        && std::fread(&count, 8, 1, f) == 1
        && std::fread(&eol, 1, 1, f) == 1 && eol == '\n';
    long off = std::ftell(f);
    std::fclose(f);
    if (!ok) return -3;
    std::strncpy(type_name_out, name.c_str(), name_cap);
    *hash_out = hash;
    *state_out = state;
    *count_out = count;
    *body_offset_out = (uint64_t)off;
    return 0;
}

// Read `bytes` of element data starting at body_offset into dst.
int uty_read_body(const char *path, uint64_t body_offset, void *dst, uint64_t bytes) {
    FILE *f = std::fopen(path, "rb");
    if (!f) return -1;
    if (std::fseek(f, (long)body_offset, SEEK_SET) != 0) { std::fclose(f); return -2; }
    size_t got = std::fread(dst, 1, bytes, f);
    std::fclose(f);
    return got == bytes ? 0 : -3;
}

// ---------------------------------------------------------------------------
// Fast CSV log appender (the Logger hot path, Logger.cpp:300-420)
// ---------------------------------------------------------------------------
int log_append(const char *path, int64_t epoch_ms, const char *tag, const char *payload) {
    FILE *f = std::fopen(path, "ab");
    if (!f) return -1;
    std::fprintf(f, "%lld,%s,%s\n", (long long)epoch_ms, tag, payload);
    std::fclose(f);
    return 0;
}

}  // extern "C"
