// Fast CSV float-matrix reader for the motion-capture text corpora.
//
// The port's own copy of motionmixerconv_tpu/_native/csv_reader.cpp, the
// same algorithm, so that the same bytes give the same float32 bits. The
// H3.6M pipeline parses hundreds of comma-separated expmap files
// (reference readCSVasFloat, h36m/utils/data_utils.py:197-215, a per-line
// Python loop). Two levels of speedup over numpy.loadtxt:
//   1. a hand-rolled fixed-format float scanner (no strtof/locale overhead),
//   2. a multi-file API that parses the whole corpus on a thread pool
//      (mmc_read_csv_many) — the corpus-level win, since numpy reads the
//      210 H3.6M files serially.
//
// C ABI (ctypes):
//   mmc_read_csv(path, &rows, &cols) -> float*   (NULL on error)
//   mmc_read_csv_many(paths, n, rows[], cols[], out_ptrs[]) -> int (#failed)
//   mmc_free(ptr)
// Returned buffers are rows*cols floats, row-major. Ragged rows -> error.
// Host code, built with g++ (_native/build.py), not with nvcc.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline const char *parse_float(const char *p, const char *end, float *out) {
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) {
        neg = *p == '-';
        ++p;
    }
    const char *digits_start = p;
    double v = 0.0;
    while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10.0 + (*p - '0');
        ++p;
    }
    if (p < end && *p == '.') {
        ++p;
        double frac = 0.0, scale = 1.0;
        while (p < end && *p >= '0' && *p <= '9') {
            frac = frac * 10.0 + (*p - '0');
            scale *= 10.0;
            ++p;
        }
        v += frac / scale;
    }
    if (p == digits_start) return nullptr;  // no digits at all
    if (p < end && (*p == 'e' || *p == 'E')) {
        ++p;
        bool eneg = false;
        if (p < end && (*p == '-' || *p == '+')) {
            eneg = *p == '-';
            ++p;
        }
        int e = 0;
        while (p < end && *p >= '0' && *p <= '9') {
            e = e * 10 + (*p - '0');
            ++p;
        }
        v *= std::pow(10.0, eneg ? -e : e);
    }
    *out = static_cast<float>(neg ? -v : v);
    return p;
}

float *read_csv_impl(const char *path, long *rows_out, long *cols_out) {
    *rows_out = 0;
    *cols_out = 0;
    FILE *f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (size <= 0) { std::fclose(f); return nullptr; }
    std::vector<char> buf(size);
    if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
        std::fclose(f);
        return nullptr;
    }
    std::fclose(f);

    std::vector<float> values;
    values.reserve(size / 9);
    long rows = 0, cols = -1;
    const char *p = buf.data();
    const char *end = p + size;
    while (p < end) {
        if (*p == '\n' || *p == '\r' || *p == ' ') { ++p; continue; }
        long cur_cols = 0;
        while (p < end && *p != '\n' && *p != '\r') {
            float v;
            const char *next = parse_float(p, end, &v);
            if (!next) return nullptr;
            values.push_back(v);
            ++cur_cols;
            p = next;
            while (p < end && (*p == ',' || *p == ' ' || *p == '\t')) ++p;
        }
        if (cols < 0) cols = cur_cols;
        else if (cols != cur_cols) return nullptr;  // ragged
        ++rows;
    }
    if (rows == 0 || cols <= 0) return nullptr;

    float *out = static_cast<float *>(std::malloc(values.size() * sizeof(float)));
    if (!out) return nullptr;
    std::memcpy(out, values.data(), values.size() * sizeof(float));
    *rows_out = rows;
    *cols_out = cols;
    return out;
}

}  // namespace

extern "C" {

float *mmc_read_csv(const char *path, long *rows_out, long *cols_out) {
    return read_csv_impl(path, rows_out, cols_out);
}

// Parse n files concurrently. rows/cols/out_ptrs are caller-allocated arrays
// of length n; a failed file gets out_ptrs[i] = NULL. Returns #failures.
int mmc_read_csv_many(const char **paths, int n, long *rows, long *cols,
                      float **out_ptrs) {
    int n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
    if (n_threads > n) n_threads = n;
    std::vector<std::thread> workers;
    for (int t = 0; t < n_threads; ++t) {
        workers.emplace_back([&, t]() {
            for (int i = t; i < n; i += n_threads) {
                out_ptrs[i] = read_csv_impl(paths[i], &rows[i], &cols[i]);
            }
        });
    }
    for (auto &w : workers) w.join();
    int failed = 0;
    for (int i = 0; i < n; ++i) {
        if (!out_ptrs[i]) ++failed;
    }
    return failed;
}

void mmc_free(float *ptr) { std::free(ptr); }

}  // extern "C"
