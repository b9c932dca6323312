// Native runtime utilities for bifurcationkit.jl_tpu_torch: the port's own
// copy of the JAX package's jl_tpu/native/src/bktpu_native.cpp, built by
// native/__init__.py with g++ at first use.
//
// The device path is PyTorch and the port's CUDA kernels; this host
// library provides the runtime pieces that want native speed:
//   * CSR -> ELL / DIA conversion (setup-time sparse format packing for the
//     SpMV containers in ops/sparse.py; the pure-Python row loop is
//     O(n) interpreted),
//   * a streaming binary branch-record logger (append-only continuation
//     checkpoints: fixed-size records, fsync'd, crash-safe resume).
//
// Exposed with a plain C ABI and loaded through ctypes (no pybind11 in the
// image).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// sparse conversions
// ---------------------------------------------------------------------------

// maximum nnz per row of a CSR matrix
int64_t bk_csr_max_row(const int64_t* indptr, int64_t n) {
    int64_t k = 0;
    for (int64_t i = 0; i < n; ++i) {
        k = std::max(k, indptr[i + 1] - indptr[i]);
    }
    return k;
}

// CSR -> ELL: out_data (n*k) zero-filled, out_cols (n*k) filled with -1
void bk_csr_to_ell(int64_t n, const int64_t* indptr, const int64_t* indices,
                   const double* data, int64_t k, double* out_data,
                   int32_t* out_cols) {
    for (int64_t i = 0; i < n * k; ++i) {
        out_data[i] = 0.0;
        out_cols[i] = -1;
    }
    for (int64_t i = 0; i < n; ++i) {
        int64_t w = 0;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p, ++w) {
            out_data[i * k + w] = data[p];
            out_cols[i * k + w] = static_cast<int32_t>(indices[p]);
        }
    }
}

// distinct diagonal offsets of a CSR matrix; returns count (<= max_diags)
int64_t bk_csr_diagonals(int64_t n, const int64_t* indptr,
                         const int64_t* indices, int64_t* offsets,
                         int64_t max_diags) {
    std::vector<int64_t> offs;
    std::vector<uint8_t> seen(2 * n + 1, 0);
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            int64_t off = indices[p] - i + n;   // shift to [0, 2n]
            if (!seen[off]) {
                seen[off] = 1;
                offs.push_back(off - n);
            }
        }
    }
    std::sort(offs.begin(), offs.end());
    int64_t cnt = std::min<int64_t>(offs.size(), max_diags);
    for (int64_t i = 0; i < cnt; ++i) offsets[i] = offs[i];
    return static_cast<int64_t>(offs.size());
}

// CSR -> DIA: out_data (ndiags * n), row-major per diagonal, zero-filled.
// convention matches ops/sparse.DIAMatrix: data[d][i] pairs with v[i+off_d].
void bk_csr_to_dia(int64_t n, const int64_t* indptr, const int64_t* indices,
                   const double* data, const int64_t* offsets,
                   int64_t ndiags, double* out_data) {
    std::memset(out_data, 0, sizeof(double) * ndiags * n);
    // offset -> slot lookup
    std::vector<int64_t> slot(2 * n + 1, -1);
    for (int64_t d = 0; d < ndiags; ++d) slot[offsets[d] + n] = d;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            int64_t off = indices[p] - i;
            int64_t d = slot[off + n];
            if (d >= 0) out_data[d * n + i] = data[p];
        }
    }
}

// ---------------------------------------------------------------------------
// streaming branch-record logger
// ---------------------------------------------------------------------------
// record: [step (i64) | n_values (i64) | values (f64 * n_values)]

struct BkLog {
    FILE* f;
    int64_t n_values;
};

void* bk_log_open(const char* path, int64_t n_values) {
    FILE* f = std::fopen(path, "ab");
    if (!f) return nullptr;
    BkLog* log = new BkLog{f, n_values};
    return log;
}

int bk_log_append(void* handle, int64_t step, const double* values) {
    if (!handle) return -1;
    BkLog* log = static_cast<BkLog*>(handle);
    if (std::fwrite(&step, sizeof(int64_t), 1, log->f) != 1) return -2;
    if (std::fwrite(&log->n_values, sizeof(int64_t), 1, log->f) != 1)
        return -2;
    if (std::fwrite(values, sizeof(double), log->n_values, log->f)
        != static_cast<size_t>(log->n_values))
        return -2;
    std::fflush(log->f);
    return 0;
}

void bk_log_close(void* handle) {
    if (!handle) return;
    BkLog* log = static_cast<BkLog*>(handle);
    std::fclose(log->f);
    delete log;
}

// read all records: returns number of records; fills steps (cap) and
// values (cap * n_values) up to capacity
int64_t bk_log_read(const char* path, int64_t n_values, int64_t* steps,
                    double* values, int64_t cap) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int64_t count = 0;
    while (true) {
        int64_t step, nv;
        if (std::fread(&step, sizeof(int64_t), 1, f) != 1) break;
        if (std::fread(&nv, sizeof(int64_t), 1, f) != 1) break;
        if (nv != n_values) break;   // layout mismatch: stop
        if (count < cap) {
            steps[count] = step;
            if (std::fread(values + count * n_values, sizeof(double),
                           n_values, f) != static_cast<size_t>(n_values))
                break;
        } else {
            std::fseek(f, sizeof(double) * n_values, SEEK_CUR);
        }
        ++count;
    }
    std::fclose(f);
    return count;
}

}  // extern "C"
